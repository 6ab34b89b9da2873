"""K6, the depthwise conv with its folded-BN bias and activation
(``csrc/depthwise_conv.cu``), held to its twins and timed on the card.

    python -m litepose_tpu_torch.tools.depthwise_clock [--out FILE.json] [--iters 20]

(from the root of a checkout; needs a CUDA device and nvcc).  For
LitePose-Auto-S@448 at b64 and Auto-XS@256 at b128 (the benchmark's serving
cells, with the bench weights of ``assets/``), one eval forward records the
inputs of every depthwise ``conv_bn`` (x, the folded bf16 weights, the fp32
bias, stride, activation).  At each of them:

- the kernel equals ``order_ref`` (the same window sum, row by row and left
  to right, in torch on the card: each product of two bf16 values is exact
  in fp32, so a multiply and an add round as the kernel's FMA does), value
  for value with NaN where it has NaN;
- the kernel with a zero bias and no activation, the conv alone, lies
  within 1 bf16 ulp of ``F.conv2d``'s;
- the kernel lies within the conv's gap plus one ulp of the twin (``F.conv2d``,
  ``+ bias.to(bf16)``, ``torch.clamp`` / ``torch.relu`` on the card): the
  bias add can cancel, so a one-ulp gap of the conv may be many ulps of a
  small sum.

Then NaN planted in an input passes to the same outputs as the twin's;
shapes off the models' (odd H and W, wide and one-pixel planes, an input off
8 bytes) hold to both twins; one traced forward has as many CUPTI rows of
the kernel as launches and no row of ATen's depthwise kernel; one serving
call (``process_batch_square``) launches the kernel 39 times; the eval
forward's peak device memory is no higher than on ATen's path.  Times (CUDA
events, ``--iters`` launches after 3): at each distinct shape the kernel,
ATen's conv + add + clamp it replaces, and the bound (the larger of the
bytes read and written over 3.35 TB/s and the FMAs of the window taps
inside the plane over 33.5 T/s, 67 TFLOP/s of fp32); summed over a call's
39 convs; and the eval forward with
the kernel against the same forward on ATen's path.  The compiler's report
(registers, spills) of the kernel's instances is printed first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[2]
CELLS = (("auto-S", 64, REPO / "assets" / "bench_ckpt.msgpack"),
         ("auto-XS", 128, REPO / "assets" / "bench_ckpt_xs.msgpack"))
PEAK_BYTES_PER_S = 3.35e12
PEAK_FMA_PER_S = 67e12 / 2
ODD_SHAPES = ((2, 3, 15, 17), (1, 5, 9, 33), (3, 2, 1, 1), (1, 4, 2, 7), (2, 6, 28, 28),
              (1, 2, 301, 20), (1, 3, 5, 600), (2, 3, 16, 16))


def padded(x, k: int, pad: int = -1):
    """``x`` with ``pad`` zeros before each plane (k // 2 where -1) and k -
    1 - ``pad`` after, as the twin pads it."""
    p = k // 2 if pad == -1 else pad
    return F.pad(x, (p, k - 1 - p) * 2)


def order_ref(x, w, bias, stride: int, act: str, pad: int = -1):
    """The kernel's arithmetic in torch: the fp32 window sum in its order,
    rounded to bf16, plus the bias rounded to bf16, rounded, the activation
    in bf16."""
    from ..ops.depthwise import activation

    B, C, H, W = x.shape
    k = w.shape[-1]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xp = padded(x.float(), k, pad)
    wf = w.float()[:, 0]
    acc = torch.zeros((B, C, Ho, Wo), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            win = xp[:, :, dy:dy + (Ho - 1) * stride + 1:stride, dx:dx + (Wo - 1) * stride + 1:stride]
            acc = acc + win * wf[:, dy, dx][:, None, None]
    z = acc.to(torch.bfloat16).float() + bias.to(torch.bfloat16).float()[:, None, None]
    return activation(z.to(torch.bfloat16), act)


def ulp(v):
    """The bf16 ulp of each value (0 for 0)."""
    v = v.float()
    _, e = torch.frexp(v)
    return torch.where(v == 0, torch.zeros_like(v), torch.ldexp(torch.ones_like(v), e - 8))


def held(x, w, bias, stride: int, act: str, pad: int = -1) -> dict:
    """Run the kernel on one input and hold it to both twins (see the module doc)."""
    from ..ops.depthwise import depthwise_conv, depthwise_conv_ref

    out = depthwise_conv(x, w, bias, stride, act, pad)
    conv = depthwise_conv(x, w, torch.zeros_like(bias), stride, "none", pad)
    want = order_ref(x, w, bias, stride, act, pad)
    twin = depthwise_conv_ref(x, w, bias, stride, act, pad)
    y = F.conv2d(padded(x, w.shape[-1], pad), w, None, stride, 0, 1, x.shape[1])
    o, t, c, yf = out.float(), twin.float(), conv.float(), y.float()
    nan = o.isnan()
    order_ok = torch.equal(nan, want.float().isnan()) and torch.equal(o[~nan], want.float()[~nan])
    conv_gap = (c - yf).abs()
    conv_ulps = conv_gap / torch.maximum(ulp(c), ulp(yf)).clamp_min(1e-38)
    fine = ~(c.isnan() | yf.isnan())
    gap = (o - t).abs()
    room = conv_gap + torch.maximum(ulp(o), ulp(t))
    both = ~(nan | t.isnan())
    return {
        "shape": list(x.shape), "k": w.shape[-1], "stride": stride, "act": act, "pad": pad,
        "order_equal": bool(order_ok),
        "conv_max_ulps": float(conv_ulps[fine].max()) if fine.any() else 0.0,
        "conv_differ_share": float((conv_gap[fine] > 0).float().mean()) if fine.any() else 0.0,
        "twin_within": bool(torch.equal(nan, t.isnan()) and bool((gap[both] <= room[both]).all())),
        "twin_equal_share": float((gap[both] == 0).float().mean()) if both.any() else 1.0,
        "twin_max_abs": float(gap[both].max()) if both.any() else 0.0,
        "nan": int(nan.sum()),
    }


def ok(check: dict) -> bool:
    return check["order_equal"] and check["conv_max_ulps"] <= 1.0 and check["twin_within"]


def events_ms(fn, iters: int) -> float:
    from .timing import cuda_ms

    return cuda_ms(fn, iters=iters, warmup=3)


def taps_in(n: int, k: int, stride: int) -> int:
    """Window taps that land inside a dimension of ``n`` cells, summed over
    its outputs (padding k // 2): the taps on the zeros outside are no work
    the conv needs."""
    p = k // 2
    return sum(min(o * stride - p + k, n) - max(o * stride - p, 0)
               for o in range((n - 1) // stride + 1))


def bound_ms(x, k: int, stride: int) -> tuple:
    """(ms, "bytes" or "fma", bytes, FMAs): the larger of the bytes read and
    written over 3.35 TB/s and the FMAs of the taps inside the plane over
    33.5 T/s."""
    B, C, H, W = x.shape
    outs = B * C * ((H - 1) // stride + 1) * ((W - 1) // stride + 1)
    nbytes = 2 * (x.numel() + outs) + C * k * k * 2 + C * 4
    fmas = B * C * taps_in(H, k, stride) * taps_in(W, k, stride)
    by_bytes, by_fma = nbytes / PEAK_BYTES_PER_S * 1e3, fmas / PEAK_FMA_PER_S * 1e3
    return max(by_bytes, by_fma), "bytes" if by_bytes >= by_fma else "fma", nbytes, fmas


def record_convs(model, images):
    """Run ``model`` once, keeping the inputs of each depthwise kernel call."""
    from ..models import layers as L

    calls = []
    launch = L.depthwise_conv

    def keep(x, w, bias, stride, act):
        calls.append((x, w, bias, stride, act))
        return launch(x, w, bias, stride, act)

    L.depthwise_conv = keep
    try:
        with torch.no_grad():
            model(images)
    finally:
        L.depthwise_conv = launch
    return calls


def cell(arch_name: str, batch: int, ckpt: Path, card, iters: int, log) -> dict:
    from ..arch import get_arch
    from ..models import layers as L
    from ..ops.depthwise import depthwise_conv, depthwise_conv_ref
    from .profile_model import litepose, load_weights, serving_engine
    from .timing import trace_kernels

    arch = get_arch(arch_name)
    size = arch.img_size
    model = litepose(load_weights(ckpt, log), arch, card)
    gen = torch.Generator(device=card).manual_seed(0)
    images = torch.randn((batch, 3, size, size), generator=gen, device=card)
    calls = record_convs(model, images)
    log(f"{arch_name}@{size} b{batch}: {len(calls)} depthwise convs a forward")
    rec = {"arch": arch_name, "size": size, "batch": batch, "convs": len(calls)}

    checks = [held(*c) for c in calls]
    rec["checks_ok"] = all(ok(c) for c in checks)
    rec["worst_conv_ulps"] = max(c["conv_max_ulps"] for c in checks)
    rec["min_twin_equal_share"] = min(c["twin_equal_share"] for c in checks)
    bad = [c for c in checks if not ok(c)]
    log(f"  held to order_ref, F.conv2d and the twin: {'ok' if not bad else bad}; conv at "
        f"most {rec['worst_conv_ulps']:g} ulp off F.conv2d; outputs equal to the twin's: "
        f"{rec['min_twin_equal_share']:.4%} at least")

    x, w, bias, stride, act = calls[len(calls) // 2]
    planted = x.clone()
    planted.view(-1)[torch.randint(0, x.numel(), (64,), generator=gen, device=card)] = float("nan")
    rec["nan"] = held(planted, w, bias, stride, act)
    log(f"  NaN planted in {tuple(x.shape)}: {rec['nan']['nan']} NaN outputs, "
        f"{'ok' if ok(rec['nan']) else rec['nan']}")

    shapes = {}
    for x, w, bias, stride, act in calls:
        key = (tuple(x.shape), w.shape[-1], stride, act)
        shapes.setdefault(key, [x, w, bias, 0])[3] += 1
    rows, total = [], {"kernel_ms": 0.0, "aten_ms": 0.0, "bound_ms": 0.0}
    for (shape, k, stride, act), (x, w, bias, n) in shapes.items():
        kern = events_ms(lambda: depthwise_conv(x, w, bias, stride, act), iters)
        aten = events_ms(lambda: depthwise_conv_ref(x, w, bias, stride, act), iters)
        bound, by, nbytes, fmas = bound_ms(x, k, stride)
        rows.append({"shape": list(shape), "k": k, "stride": stride, "act": act, "count": n,
                     "kernel_ms": kern, "aten_ms": aten, "bound_ms": bound, "bound_by": by,
                     "bytes": nbytes, "fmas": fmas, "share": bound / kern})
        total["kernel_ms"] += n * kern
        total["aten_ms"] += n * aten
        total["bound_ms"] += n * bound
        log(f"  {shape} k{k} s{stride} {act} x{n}: kernel {kern:.4f} ms, ATen conv+add+act "
            f"{aten:.4f} ms, bound {bound:.4f} ms ({by}), {bound / kern:.1%} of bound")
    total["share"] = total["bound_ms"] / total["kernel_ms"]
    rec["shapes"], rec["call"] = rows, total
    log(f"  a call's {len(calls)} convs: kernel {total['kernel_ms']:.4f} ms, ATen "
        f"{total['aten_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms: {total['share']:.1%} "
        f"of bound")

    def peak_bytes():
        """Device memory a forward adds at its peak to what is allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(card)
        base = torch.cuda.memory_allocated(card)
        model(images)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(card) - base

    with torch.no_grad():
        fused = events_ms(lambda: model(images), max(iters // 4, 3))
        fused_peak = peak_bytes()
        before = depthwise_conv.launches
        kernels, _ = trace_kernels(lambda: model(images), 1)
        launched = depthwise_conv.launches - before
        fused_depthwise = L.fused_depthwise
        L.fused_depthwise = lambda conv, x: False
        try:
            aten = events_ms(lambda: model(images), max(iters // 4, 3))
            aten_peak = peak_bytes()
        finally:
            L.fused_depthwise = fused_depthwise
    rows_k6 = sum(n for name, (n, _) in kernels.items() if "depthwise_conv_kernel" in name)
    rows_aten = sum(n for name, (n, _) in kernels.items() if "conv_depthwise2d" in name)
    rec["forward"] = {"kernel_ms": fused, "aten_ms": aten, "launches": launched,
                      "cupti_rows": rows_k6, "aten_depthwise_rows": rows_aten,
                      "peak_bytes": fused_peak, "aten_peak_bytes": aten_peak}
    log(f"  eval forward: {fused:.3f} ms with the kernel, {aten:.3f} ms on ATen's path; "
        f"{launched} launches, {rows_k6} CUPTI rows of the kernel, {rows_aten} of ATen's "
        f"depthwise kernel; its peak {fused_peak / 1e9:.3f} GB over what it starts with, "
        f"{aten_peak / 1e9:.3f} GB on ATen's path")

    engine = serving_engine(model, size, 0.3, card)
    frames = np.random.default_rng(0).integers(0, 255, (batch, size, size, 3), dtype=np.uint8)
    engine.process_batch_square(frames)
    torch.cuda.synchronize()
    before = depthwise_conv.launches
    engine.process_batch_square(frames)
    rec["serving_launches"] = depthwise_conv.launches - before
    log(f"  one serving call launches the kernel {rec['serving_launches']} times")
    rec["ok"] = (rec["checks_ok"] and ok(rec["nan"]) and rec["nan"]["nan"] > 0
                 and launched == rows_k6 == len(calls) and rows_aten == 0
                 and fused_peak <= aten_peak and rec["serving_launches"] == len(calls))
    return rec


def odd_shapes(card, log) -> dict:
    gen = torch.Generator(device=card).manual_seed(1)
    acts = ("none", "relu6", "relu")
    results, i = [], 0
    for shape in ODD_SHAPES:
        for k in (3, 5, 7):
            for stride in (1, 2):
                B, C, H, W = shape
                x = torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                w = (torch.randn((C, 1, k, k), generator=gen, device=card) / k).to(torch.bfloat16)
                bias = torch.randn((C,), generator=gen, device=card)
                results.append(held(x, w, bias, stride, acts[i % 3]))
                i += 1
    x = torch.randn(2 * 5 * 24 * 24 + 1, generator=gen, device=card).to(torch.bfloat16)
    shifted = x[1:].view(2, 5, 24, 24)  # 2 bytes past the allocation: cell by cell staging
    w = torch.randn((5, 1, 7, 7), generator=gen, device=card).to(torch.bfloat16) / 7
    bias = torch.randn((5,), generator=gen, device=card)
    results.append(held(shifted, w.contiguous(), bias, 1, "relu6"))
    bad = [r for r in results if not ok(r)]
    log(f"odd shapes: {len(results)} cases, {'all held' if not bad else bad}")
    return {"cases": len(results), "bad": bad, "ok": not bad}


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
            keep = "depthwise_conv.cu" in line
        elif keep and ("depthwise" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    report = "\n".join(lines)
    log(f"build {seconds:.1f} s; ptxas on csrc/depthwise_conv.cu:\n{report}")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the record to this JSON file")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("depthwise_clock needs a CUDA device")
    card = torch.device("cuda")
    log = lambda s: print(s, flush=True)  # noqa: E731
    out = {"card": card_line(), "torch": torch.__version__, "ptxas": ptxas_report(log)}
    log(f"card: {out['card']}, torch {out['torch']}")
    out["odd"] = odd_shapes(card, log)
    out["cells"] = []
    for arch_name, batch, ckpt in CELLS:
        out["cells"].append(cell(arch_name, batch, ckpt, card, args.iters, log))
        torch.cuda.empty_cache()
    out["ok"] = out["odd"]["ok"] and all(c["ok"] for c in out["cells"])
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    log(json.dumps({"ok": out["ok"], "calls": {c["arch"]: c["call"] for c in out["cells"]},
                    "forward": {c["arch"]: c["forward"] for c in out["cells"]}}))
    if not out["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
