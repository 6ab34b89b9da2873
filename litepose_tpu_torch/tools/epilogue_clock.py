"""K7, the epilogue of a folded dense conv (``csrc/conv_epilogue.cu``),
held to its twin and timed on the card.

    python -m litepose_tpu_torch.tools.epilogue_clock [--out FILE.json] [--iters 20]
        [--configs auto-S auto-XS w48]

(from the root of a checkout; needs a CUDA device and nvcc).  For each
serving configuration of the benchmark, at its batch (LitePose-Auto-S@448
b64 and Auto-XS@256 b128 with the bench weights of ``assets/``,
HigherHRNet-W48@640 b16 from ``configs/crowd_pose/higher_hrnet/
w48_640_adam_lr1e-3.yaml``, seeded, its BN affines moved off the
identity), one eval forward records the inputs of every ``conv_epilogue``
(the conv's output, the folded bias, the residual, the activation).  Then:

- the kernel (on a copy of the conv's output, which it overwrites) equals
  the twin (``conv_epilogue_ref``: ``+ bias.to(bf16)``,
  the upsample and ``+ residual``, ``torch.clamp`` / ``torch.relu`` / Swish,
  run by ATen on the card) bit for bit at every one, and with NaN, +-0 and
  +-inf planted in one under each activation;
- one serving call (``process_batch_square``) launches it once a dense
  conv-BN pair (``dense_pairs``: in W48, those the dense 3x3 kernel K8 does
  not take with their epilogue);
- device times at each distinct epilogue (``--iters`` calls captured in a
  CUDA graph and replayed between CUDA events, so no host time counts):
  the kernel, ATen's sequence it replaced (``library_ms``) and the bound
  (bytes read and written over 3.35 TB/s), summed over the call;
- the serving engine's forward (the body of its ``litepose.engine.forward``
  span, its input already on the card): its ms by CUDA events over calls
  back to back, and its untraced host ms (the card idle before each call),
  with the kernel and on ATen's path (``layers.fused_epilogue`` off) in the
  same process, the two alternated call by call.

The compiler's report (registers, spills) of the kernel's instances is
printed first.  No cell of the benchmark runs this tool.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.depthwise import ACTS

REPO = Path(__file__).resolve().parents[2]
PEAK_BYTES_PER_S = 3.35e12
W48_CONFIG = REPO / "configs" / "crowd_pose" / "higher_hrnet" / "w48_640_adam_lr1e-3.yaml"
# name -> (batch of the benchmark's cell, LitePose checkpoint or None for W48)
CONFIGS = {"auto-S": (64, REPO / "assets" / "bench_ckpt.msgpack"),
           "auto-XS": (128, REPO / "assets" / "bench_ckpt_xs.msgpack"),
           "w48": (16, None)}
HOST_ROUNDS = 15  # untraced forwards whose host ms give the median


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def held(y, bias, residual, act: str) -> dict:
    """The kernel at one epilogue (on a copy of ``y``, which it overwrites)
    against the twin run by ATen on the card: bit for bit, NaN where it has
    NaN; ``max_abs`` the largest gap where the bits differ."""
    from ..ops.epilogue import conv_epilogue, conv_epilogue_ref

    out = conv_epilogue(y.clone(), bias, residual, act)
    twin = conv_epilogue_ref(y, bias, residual, act)
    if out.shape == twin.shape:
        same = _bits(out) == _bits(twin)
        differ = int((~same).sum())
        gap = (out.float() - twin.float()).abs().contiguous().masked_fill(same, 0.0)
        max_abs = float(gap.max()) if gap.numel() else 0.0
    else:
        differ, max_abs = -1, float("inf")
    return {"shape": list(y.shape), "residual": None if residual is None else
            list(residual.shape), "act": act, "layout": "nhwc" if not y.is_contiguous() else
            "nchw", "equal": differ == 0, "differ": differ, "max_abs": max_abs,
            "nan": int(out.isnan().sum()), "zeros": int((out == 0).sum())}


def planted(y, bias, residual, seed: int = 0):
    """Copies of an epilogue's inputs with NaN, +-0 and +-inf planted at
    random places of y and the residual, and +-0 in y's first channel, whose
    bias is set to -0 (the last channel's to +0), so that -0 + -0 reaches
    the activation."""
    gen = torch.Generator(device=y.device).manual_seed(seed)
    y, bias = y.clone(), bias.clone()
    residual = None if residual is None else residual.clone()
    specials = torch.tensor([float("nan"), 0.0, -0.0, float("inf"), -float("inf")],
                            device=y.device).to(y.dtype)
    for t in (y, residual):
        if t is not None:
            n = max(t.numel() // 50, len(specials))
            at = torch.randint(0, t.numel(), (n,), generator=gen, device=t.device)
            flat = (t if t.is_contiguous() else t.permute(0, 2, 3, 1)).view(-1)
            flat[at] = specials[torch.arange(n, device=t.device) % len(specials)]
    bias[0], bias[-1] = -0.0, 0.0
    y[:, 0, ::2] = -0.0
    y[:, 0, 1::2] = 0.0
    y[:, -1, ::3] = -0.0
    return y, bias, residual


def record_epilogues(forward):
    """``forward()`` (a model's forward, or a serving call) run once,
    keeping the inputs of each epilogue the kernel ran (a copy of the
    conv's output, which the kernel overwrites), and the launches it
    counted."""
    from ..models import layers as L
    from ..ops.epilogue import conv_epilogue

    calls = []
    launch = L.conv_epilogue

    def keep(y, bias, residual, act):
        calls.append((y.clone(), bias, residual, act))
        return launch(y, bias, residual, act)

    before = conv_epilogue.launches
    L.conv_epilogue = keep
    try:
        with torch.inference_mode():
            forward()
    finally:
        L.conv_epilogue = launch
    torch.cuda.synchronize()
    return calls, conv_epilogue.launches - before


def dense_pairs(model) -> int:
    """The dense conv-BN pairs whose epilogue is the kernel's: every pair
    but the depthwise ones (K6) and, in a model that runs channels-last on
    the card, the 3x3 stride-1 ones K8 takes with their epilogue."""
    from ..models import layers as L

    k8 = getattr(model, "eval_layout", None) is torch.channels_last
    return sum(1 for c, _ in model._conv_bn_pairs()
               if not c.groups == c.in_channels == c.out_channels > 1
               and not (k8 and L.conv3x3_kernel_takes(c)))


def serving_model(name: str, card, batch: int, log=lambda s: None):
    """(model, a normalized input batch, its dense conv-BN pairs) of a
    serving configuration, in eval mode on ``card``."""
    from .profile_model import litepose, load_weights, moved_affines_

    if name == "w48":
        from ..config import default_config, update_config
        from ..models import get_model

        model = get_model("pose_higher_hrnet", update_config(default_config(), str(W48_CONFIG)),
                          device="cpu", seed=0, out_dtype=torch.bfloat16)
        model = moved_affines_(model.train(), seed=7).to(card).eval()
        size = 640
    else:
        from ..arch import get_arch

        arch = get_arch(name)
        ckpt = CONFIGS[name][1]
        model = litepose(load_weights(ckpt, log) if ckpt.is_file() else None, arch, card,
                         out_dtype=torch.bfloat16)
        size = arch.img_size
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((batch, 3, size, size), generator=gen, device=card)
    return model, x, dense_pairs(model)


def bound_ms(y, residual) -> tuple:
    """(ms, bytes): y read, the residual read, the output written, over
    3.35 TB/s."""
    out = y.numel() if residual is None else residual.numel()
    nbytes = 2 * (y.numel() + out + (0 if residual is None else residual.numel()))
    return nbytes / PEAK_BYTES_PER_S * 1e3, nbytes


def events_ms(fn, iters: int) -> float:
    from .timing import cuda_ms

    return cuda_ms(fn, iters=iters, warmup=3)


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """The device ms of one ``fn()``: ``iters`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events, so that no host
    time between launches counts (a small epilogue takes less device time
    than its host call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def forward_host_ms(fn, x) -> tuple:
    """The median host ms of ``fn(x)`` under inference mode with the kernel
    and on ATen's path (``layers.fused_epilogue`` off), the two alternated
    call by call and the card idle before each call."""
    from ..models import layers as L

    fused = L.fused_epilogue
    paths = ((fused, []), (lambda y, residual: False, []))
    try:
        with torch.inference_mode():
            for _ in range(HOST_ROUNDS + 2):
                for path, times in paths:
                    L.fused_epilogue = path
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(x)
                    times.append((time.perf_counter() - t0) * 1e3)
    finally:
        L.fused_epilogue = fused
    torch.cuda.synchronize()
    return tuple(statistics.median(times[2:]) for _, times in paths)


def checked(calls, log) -> dict:
    """Each recorded epilogue ``held``, and the kernel with NaN, +-0 and
    +-inf planted in the first one with a residual, under each activation:
    ``equal`` (all bit-equal), ``max_abs`` (the largest gap found, 0 where
    equal) and the planted records."""
    checks = [held(*c) for c in calls]
    bad = [c for c in checks if not c["equal"]]
    kinds = sorted({(c["layout"], "none" if c["residual"] is None else
                     "same" if c["residual"] == c["shape"] else "up", c["act"])
                    for c in checks})
    log(f"  bit-equal to the twin at every epilogue: {'yes' if not bad else bad[:3]}; kinds "
        f"{kinds}")
    y, bias, res, _ = next(((y, b, r, a) for y, b, r, a in calls if r is not None), calls[0])
    plants = [held(*planted(y, bias, res, seed=i), a) for i, a in enumerate(ACTS)]
    log(f"  NaN, +-0, +-inf planted at {tuple(y.shape)}: "
        f"{[(p['equal'], p['nan'], p['zeros']) for p in plants]}")
    return {"equal": not bad and all(p["equal"] and p["nan"] > 0 for p in plants),
            "max_abs": max(c["max_abs"] for c in checks + plants), "planted": plants}


def timed(calls, iters: int, log) -> tuple:
    """(a row a distinct epilogue, their sum over ``calls``): the kernel's
    device ms (in place, on a copy of y, as ``conv_bn`` runs it), ATen's
    sequence's (``library_ms``) and the bound, by ``graph_ms``."""
    from ..ops.epilogue import conv_epilogue, conv_epilogue_ref

    shapes = {}
    for y, bias, res, act in calls:
        key = (tuple(y.shape), None if res is None else tuple(res.shape), act,
               y.is_contiguous(), bias.dtype)
        shapes.setdefault(key, [y, bias, res, act, 0])[4] += 1
    rows = []
    total = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    for (shape, rshape, act, _, _), (y, bias, res, act, n) in shapes.items():
        yk = y.clone()
        kern = graph_ms(lambda: conv_epilogue(yk, bias, res, act), iters)
        lib = graph_ms(lambda: conv_epilogue_ref(y, bias, res, act), iters)
        bound, nbytes = bound_ms(y, res)
        rows.append({"shape": list(shape), "residual": rshape and list(rshape), "act": act,
                     "count": n, "ms": kern, "library_ms": lib, "bound_ms": bound,
                     "bytes": nbytes, "share": bound / kern})
        for key, v in (("ms", kern), ("library_ms", lib), ("bound_ms", bound),
                       ("bytes", nbytes)):
            total[key] += n * v
        log(f"  {shape} res {rshape} {act} x{n}: kernel {kern:.4f} ms, ATen {lib:.4f} ms, "
            f"bound {bound:.4f} ms, {bound / kern:.1%} of it")
    total["share"] = total["bound_ms"] / total["ms"]
    log(f"  a forward's {len(calls)} epilogues: kernel {total['ms']:.4f} ms, ATen "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['bytes'] / 1e9:.2f} GB): {total['share']:.1%} of the bound")
    return rows, total


def serving_launches(engine, frames) -> int:
    """The kernel's launches in one serving call of ``engine`` on
    ``frames``, the count set to 0 just before it."""
    from ..ops.epilogue import conv_epilogue

    torch.cuda.synchronize()
    conv_epilogue.launches = 0
    engine.process_batch_square(frames)
    torch.cuda.synchronize()
    return conv_epilogue.launches


def clock(name: str, card, iters: int, log) -> dict:
    from ..models import layers as L
    from .profile_model import serving_engine

    batch = CONFIGS[name][0]
    model, x, pairs = serving_model(name, card, batch, log)
    calls, launched = record_epilogues(lambda: model(x))
    log(f"{name} b{batch}: {len(calls)} epilogues a forward ({launched} launches), {pairs} "
        f"dense conv-BN pairs")
    rec = {"config": name, "batch": batch, "epilogues": len(calls), "launches": launched,
           "pairs": pairs}
    rec.update(checked(calls, log))
    rec["shapes"], rec["call"] = timed(calls, iters, log)
    n_calls = len(calls)
    del calls

    engine = serving_engine(model, x.shape[-1], 0.1, card)
    frames = np.random.default_rng(0).integers(0, 255, (batch, x.shape[-1], x.shape[-1], 3),
                                               dtype=np.uint8)
    engine.process_batch_square(frames)
    rec["serving_launches"] = serving_launches(engine, frames)
    with torch.inference_mode():
        xu = engine._upload(frames)
        fn = engine.infer_fn(tuple(xu.shape[1:3]), None)
        rec["forward_ms"] = events_ms(lambda: fn(xu), max(iters // 4, 3))
        fused = L.fused_epilogue
        L.fused_epilogue = lambda y, residual: False
        try:
            rec["aten_forward_ms"] = events_ms(lambda: fn(xu), max(iters // 4, 3))
        finally:
            L.fused_epilogue = fused
        rec["forward_host_ms"], rec["aten_forward_host_ms"] = forward_host_ms(fn, xu)
    log(f"  one serving call launches the kernel {rec['serving_launches']} times; the "
        f"engine's forward: device {rec['forward_ms']:.3f} ms, host {rec['forward_host_ms']:.3f}"
        f" ms with the kernel; {rec['aten_forward_ms']:.3f} / {rec['aten_forward_host_ms']:.3f}"
        f" ms on ATen's path")
    rec["ok"] = rec["equal"] and launched == n_calls == pairs == rec["serving_launches"]
    return rec


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except OSError:
        return torch.cuda.get_device_name(0)


def ptxas_report(log) -> str:
    from ..kernels import build

    _, seconds, text = build.build()
    lines, keep = [], False
    for line in text.splitlines():
        if "nvcc" in line and " -c " in line:
            keep = "conv_epilogue.cu" in line
        elif keep and ("conv_epilogue" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    report = "\n".join(lines)
    log(f"build {seconds:.1f} s; ptxas on csrc/conv_epilogue.cu:\n{report}")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the record to this JSON file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("epilogue_clock needs a CUDA device")
    card = torch.device("cuda")
    log = lambda s: print(s, flush=True)  # noqa: E731
    out = {"card": card_line(), "torch": torch.__version__, "ptxas": ptxas_report(log)}
    log(f"card: {out['card']}, torch {out['torch']}")
    out["configs"] = []
    for name in args.configs:
        out["configs"].append(clock(name, card, args.iters, log))
        torch.cuda.empty_cache()
    out["ok"] = all(c["ok"] for c in out["configs"])
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    log(json.dumps({"ok": out["ok"], "calls": {c["config"]: c["call"] for c in out["configs"]},
                    "host": {c["config"]: (c["forward_host_ms"], c["aten_forward_host_ms"])
                             for c in out["configs"]}}))
    if not out["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
