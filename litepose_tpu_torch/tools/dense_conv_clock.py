"""K8, the dense 3x3 stride-1 conv with its epilogue (``csrc/dense_conv3x3.cu``),
held to its twin and timed on the card against the path it replaced.

    python -m litepose_tpu_torch.tools.dense_conv_clock [--out FILE.json] [--iters 10]

(from the root of a checkout; needs a CUDA device and nvcc).  One eval
forward of HigherHRNet-W48@640 at b16 (``configs/crowd_pose/higher_hrnet/
w48_640_adam_lr1e-3.yaml``, seeded) records the shape of every conv-BN pair
the kernel takes (Cin, Cout, plane, residual, activation).  At each
distinct shape, on seeded inputs of that shape:

- the twin's agreement: the kernel's conv (bias 0, no residual, no
  activation) within 1 bf16 ulp of the conv in float64 on a share of the
  outputs and on every output whose sum cancels by less than a factor 256,
  and its epilogue equal to ``ops.epilogue.unfused`` of that conv output
  bit for bit;
- device times (``--iters`` calls captured in a CUDA graph and replayed
  between CUDA events): the kernel, and the path it replaced, cuDNN's
  ``F.conv2d`` then K7 (``conv_epilogue``, written into the conv's output
  as ``layers.conv_bn`` ran it), and the bound: the larger of the FLOPs
  over 989 TFLOP/s and the bytes (input, weights, residual read once,
  output written once) over 3.35 TB/s;

and each summed over the forward's pairs.  The W48 model then serves one
call of 16 frames (``PoseEngine.process_batch_square``, the benchmark's
serving engine), the kernel's launch count set to 0 just before it: one
launch a pair.  Then HigherHRNet-W32@512 runs
one eval forward at b2 through the kernel: its launches against its 3x3
stride-1 pairs, and its maps against the same forward on the path it
replaced.  The compiler's report (registers, spills) of the kernel's
instances is printed first.  No cell of the benchmark runs this tool.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "configs" / "crowd_pose" / "higher_hrnet"
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(B, cin, cout, H, W, residual: bool) -> tuple:
    """(ms, FLOPs, bytes, what bounds it) of one conv at the roofline."""
    flops = 2 * B * H * W * cout * 9 * cin
    nbytes = 2 * (B * H * W * (cin + cout * (2 if residual else 1)) + 9 * cin * cout)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, flops, nbytes, "operations" if t_ops >= t_bytes else "bytes"


def hrnet(name: str, card, batch: int):
    """(model, a normalized input batch) of HigherHRNet ``name`` (w48 at 640,
    w32 at 512) in eval mode on ``card``, its BN affines moved off the
    identity."""
    from ..config import default_config, update_config
    from ..models import get_model
    from .profile_model import moved_affines_

    cfg_file, size = {"w48": ("w48_640_adam_lr1e-3.yaml", 640),
                      "w32": ("w32_512_adam_lr1e-3.yaml", 512)}[name]
    model = get_model("pose_higher_hrnet", update_config(default_config(),
                                                         str(CONFIGS / cfg_file)),
                      device="cpu", seed=0, out_dtype=torch.bfloat16)
    model = moved_affines_(model.train(), seed=7).to(card).eval()
    gen = torch.Generator(device=card).manual_seed(0)
    return model, torch.randn((batch, 3, size, size), generator=gen, device=card)


def record_shapes(forward) -> Counter:
    """``forward()`` run once; the count of each (B, Cin, Cout, H, W,
    residual, act) the kernel ran."""
    from ..models import layers as L

    seen = Counter()
    launch = L.conv3x3_bn_act

    def keep(x, w, bias, residual, act):
        B, cin, H, W = x.shape
        seen[(B, cin, w.shape[0], H, W, residual is not None, act)] += 1
        return launch(x, w, bias, residual, act)

    L.conv3x3_bn_act = keep
    try:
        with torch.inference_mode():
            forward()
    finally:
        L.conv3x3_bn_act = launch
    torch.cuda.synchronize()
    return seen


def inputs(B, cin, cout, H, W, residual: bool, card, seed: int = 0):
    """x, w (fan-in scaled), an fp32 bias and a residual, bf16 channels-last."""
    gen = torch.Generator(device=card).manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn((B, cin, H, W), generator=gen, device=card).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=card).mul(
        (9 * cin) ** -0.5).to(torch.bfloat16)
    bias = torch.randn((cout,), generator=gen, device=card)
    res = torch.randn((B, cout, H, W), generator=gen, device=card).to(torch.bfloat16) \
        if residual else None
    return (x.contiguous(memory_format=cl), w.contiguous(memory_format=cl), bias,
            None if res is None else res.contiguous(memory_format=cl))


def ulps(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|a - ref| in bf16 ulps at ref (a bf16, ref fp32): the larger of the
    two spacings beside ref rounded to bf16, so that either neighbour of
    ref reads at most 1, also at the edge of a binade."""
    r16 = ref.to(torch.bfloat16)
    inf = torch.full_like(r16, float("inf"))
    spacing = torch.maximum(torch.nextafter(r16, inf).float() - r16.float(),
                            r16.float() - torch.nextafter(r16, -inf).float())
    return (a.float() - ref).abs() / spacing.clamp_min(torch.finfo(torch.float32).tiny)


def held(x, w, bias, res, act: str) -> dict:
    """The kernel against its twin at one shape: ``conv_ulp_share`` of its
    conv output within 1 bf16 ulp of the conv in float64, ``conv_ulp_max``
    the most on the outputs whose sum cancels by less than a factor 256
    (|y| >= sum |x w| / 256), ``epilogue_equal`` its output equal to ``unfused`` of its conv output
    bit for bit, and the largest gap to the twin (``F.conv2d`` in bf16 and
    ``unfused``, on the card)."""
    from ..ops.dense_conv import conv3x3_bn_act, conv3x3_bn_act_ref
    from ..ops.epilogue import unfused

    y = conv3x3_bn_act(x, w, torch.zeros_like(bias), None, "none")
    out = conv3x3_bn_act(x, w, bias, res, act)
    want = unfused(y, bias, res, act)
    ref = F.conv2d(x.double(), w.double(), None, 1, 1)
    kept = ref.abs() >= F.conv2d(x.double().abs(), w.double().abs(), None, 1, 1) / 256
    gaps = ulps(y, ref.float())
    del ref
    twin = conv3x3_bn_act_ref(x, w, bias, res, act)
    share = float((gaps <= 1).float().mean())
    most = float(gaps[kept].max()) if bool(kept.any()) else 0.0
    equal = bool(torch.equal(out.contiguous().view(torch.int16),
                             want.contiguous().view(torch.int16)))
    gap = float((out.float() - twin.float()).abs().max())
    return {"conv_ulp_share": share, "conv_ulp_max": most, "epilogue_equal": equal,
            "twin_max_abs": gap}


def graph_ms(fn, iters: int) -> float:
    from .epilogue_clock import graph_ms as replayed

    return replayed(fn, iters)


def timed(seen: Counter, card, iters: int, log) -> tuple:
    """(a row a distinct shape, their sum over the forward): the kernel's
    device ms, cuDNN's conv + K7's (``library_ms``) and the bound."""
    from ..ops.dense_conv import conv3x3_bn_act
    from ..ops.epilogue import conv_epilogue

    rows = []
    total = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "convs": 0}
    for (B, cin, cout, H, W, residual, act), n in sorted(seen.items()):
        x, w, bias, res = inputs(B, cin, cout, H, W, residual, card)
        check = held(x, w, bias, res, act)
        kern = graph_ms(lambda: conv3x3_bn_act(x, w, bias, res, act), iters)
        lib = graph_ms(lambda: conv_epilogue(F.conv2d(x, w, None, 1, 1), bias, res, act), iters)
        bound, flops, nbytes, by = bound_ms(B, cin, cout, H, W, residual)
        rows.append({"shape": [B, cin, cout, H, W], "residual": residual, "act": act,
                     "count": n, "ms": kern, "library_ms": lib, "bound_ms": bound,
                     "bound_by": by, "flops": flops, "bytes": nbytes, "share": bound / kern,
                     **check})
        for key, v in (("ms", kern), ("library_ms", lib), ("bound_ms", bound), ("convs", 1)):
            total[key] += n * v
        log(f"  {cin}->{cout} @ {H}x{W} b{B} {'residual ' if residual else ''}{act} x{n}: "
            f"K8 {kern:.4f} ms, cuDNN + K7 {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{bound / kern:.1%} of it; conv within 1 ulp {check['conv_ulp_share']:.5f} "
            f"(most {check['conv_ulp_max']:.4f} where the sum cancels by < 256), "
            f"epilogue equal {check['epilogue_equal']}, twin gap {check['twin_max_abs']:g}")
        del x, w, bias, res
    total["share"] = total["bound_ms"] / total["ms"]
    log(f"  the forward's {total['convs']} convs: K8 {total['ms']:.4f} ms, cuDNN + K7 "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms: "
        f"{total['share']:.1%} of the bound")
    return rows, total


def drive_w32(card, log) -> dict:
    """HigherHRNet-W32@512 at b2: one eval forward through the kernel, its
    launches against its 3x3 stride-1 pairs and its maps against the same
    forward on the replaced path (``layers.fused_conv3x3`` off)."""
    from ..models import layers as L
    from ..ops.dense_conv import conv3x3_bn_act

    model, x = hrnet("w32", card, 2)
    pairs = sum(1 for c, _ in model._conv_bn_pairs() if L.conv3x3_kernel_takes(c))
    before = conv3x3_bn_act.launches
    with torch.inference_mode():
        got = model(x)
        torch.cuda.synchronize()
        launches = conv3x3_bn_act.launches - before
        taken = L.fused_conv3x3
        L.fused_conv3x3 = lambda conv, x, residual: False
        try:
            want = model(x)
        finally:
            L.fused_conv3x3 = taken
    rel = [float((g.float() - w_.float()).norm() / w_.float().norm()) for g, w_ in
           zip(got, want)]
    rec = {"launches": launches, "pairs": pairs, "rel_l2": rel,
           "ok": launches == pairs > 0 and all(r < 0.02 for r in rel)}
    log(f"W32@512 b2: {launches} launches for {pairs} 3x3 stride-1 pairs; maps against the "
        f"replaced path, relative L2 {', '.join(f'{r:.2e}' for r in rel)}")
    return rec


def serving_launches(model, x) -> int:
    """The kernel's launches in one serving call of ``model`` (the
    benchmark's engine, ``profile_model.serving_engine``) on as many seeded
    frames as ``x`` holds images, the count set to 0 just before it."""
    import numpy as np

    from ..ops.dense_conv import conv3x3_bn_act
    from .profile_model import serving_engine

    engine = serving_engine(model, x.shape[-1], 0.1, x.device)
    frames = np.random.default_rng(0).integers(0, 255, (x.shape[0], x.shape[-1], x.shape[-1], 3),
                                               dtype=np.uint8)
    engine.process_batch_square(frames)  # its shapes built
    torch.cuda.synchronize()
    conv3x3_bn_act.launches = 0
    engine.process_batch_square(frames)
    torch.cuda.synchronize()
    return conv3x3_bn_act.launches


def clock(card, iters: int, log) -> dict:
    model, x = hrnet("w48", card, 16)
    seen = record_shapes(lambda: model(x))
    served = serving_launches(model, x)
    del model, x
    torch.cuda.empty_cache()
    log(f"W48@640 b16: {sum(seen.values())} convs through K8 in {len(seen)} shapes; one "
        f"serving call launches it {served} times")
    rows, total = timed(seen, card, iters, log)
    rec = {"shapes": rows, "call": total, "serving_launches": served,
           "w32": drive_w32(card, log)}
    rec["ok"] = (rec["w32"]["ok"] and served == total["convs"]
                 and all(r["epilogue_equal"] and r["conv_ulp_share"] >= 0.999
                         and r["conv_ulp_max"] <= 1 for r in rows))
    return rec


def ptxas_report(log) -> str:
    from ..kernels import build

    _, seconds, text = build.build()
    lines, keep = [], False
    for line in text.splitlines():
        if "nvcc" in line and " -c " in line:
            keep = "dense_conv3x3.cu" in line
        elif keep and ("conv3x3" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    report = "\n".join(lines)
    log(f"build {seconds:.1f} s; ptxas on csrc/dense_conv3x3.cu:\n{report}")
    return report


def main(argv=None) -> None:
    from .epilogue_clock import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the record to this JSON file")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dense_conv_clock needs a CUDA device")
    card = torch.device("cuda")
    log = lambda s: print(s, flush=True)  # noqa: E731
    out = {"card": card_line(), "torch": torch.__version__, "ptxas": ptxas_report(log)}
    log(f"card: {out['card']}, torch {out['torch']}")
    out.update(clock(card, args.iters, log))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    log(json.dumps({"ok": out["ok"], "call": out["call"],
                    "serving_launches": out["serving_launches"], "w32": out["w32"]}))
    if not out["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
