"""Timing on the card, shared by ``chip_smoke.py`` and the profilers
(``profile_model``, ``profile_eval``, ``sweep_serve``).

- ``cuda_ms``: the mean device ms of back-to-back calls, by CUDA events.
- ``time_rounds``: the median and range of that mean over rounds; on the
  CPU the host clock, which only the tests use (a CPU number is no device
  number).
- ``trace_kernels`` / ``kernel_families`` / ``breakdown``: the device time
  of the kernels a call runs, from ``torch.profiler`` (CUPTI), summed by
  ``KERNEL_FAMILIES``; each port kernel (K1-K5, K1') is a family of its own,
  the depthwise conv K6 is counted in "depthwise conv" (with PyTorch's,
  which a bf16 eval forward no longer launches), the dense convs' epilogue
  K7 in "conv_epilogue", the dense 3x3 stride-1 conv with its epilogue K8 in
  "conv3x3_bn_act", and ``breakdown`` holds each against the launch count
  its wrapper kept over the traced calls.

Nothing here runs at import: ``torch.profiler`` is imported by the calls
that trace.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

# (family, substrings of a CUDA kernel's lower-cased name); first match wins,
# so the port's kernels come before the generic families
KERNEL_FAMILIES = (
    ("K1 nms_topk", ("nms_topk_band_kernel", "nms_topk_merge_kernel")),
    ("K1' nms_topk_loop", ("nms_topk_loop_kernel",)),
    ("K2 group_greedy", ("group_greedy_kernel",)),
    ("K3 group_hungarian", ("group_hungarian_kernel",)),
    ("K4 refine_argmax", ("refine_argmax_tile_kernel", "refine_finalize_kernel")),
    ("K5 heatmap_nms", ("heatmap_nms_ring_kernel", "heatmap_nms_kernel")),
    ("depthwise conv", ("depthwise",)),
    ("conv_epilogue", ("conv_epilogue",)),
    ("conv3x3_bn_act", ("conv3x3_bn_act",)),
    ("cuDNN / GEMM", ("cudnn", "xmma", "gemm", "cutlass", "implicit_convolve", "winograd",
                      "fft", "sm90_", "sm80_", "nvjet")),
    ("resize (bilinear)", ("upsample",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("reductions (BN statistics, losses)", ("reduce", "norm", "welford")),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
    ("memcpy / memset", ("memcpy", "memset")),
)
OTHER = "other"


def port_launches() -> Dict[str, int]:
    """Each port kernel's family -> its wrapper's launch count so far
    (``ops.library.count_launch`` adds one where a wrapper launches)."""
    from ..ops.dense_conv import conv3x3_bn_act
    from ..ops.depthwise import depthwise_conv
    from ..ops.epilogue import conv_epilogue
    from ..ops.group import group_greedy, group_hungarian
    from ..ops.nms import nms_suppress
    from ..ops.refine import refine_argmax
    from ..ops.topk import nms_topk

    return {"K1 nms_topk": nms_topk.launches, "K1' nms_topk_loop": nms_topk.loop_launches,
            "K2 group_greedy": group_greedy.launches,
            "K3 group_hungarian": group_hungarian.launches,
            "K4 refine_argmax": refine_argmax.launches, "K5 heatmap_nms": nms_suppress.launches,
            "depthwise conv": depthwise_conv.launches,
            "conv_epilogue": conv_epilogue.launches,
            "conv3x3_bn_act": conv3x3_bn_act.launches}


def family_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)), OTHER)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Timing(NamedTuple):
    """ms a call: the median over rounds and the rounds' range."""

    median: float
    lo: float
    hi: float
    rounds: int

    def __str__(self) -> str:
        return (f"{self.median:.3f} ms (range {self.lo:.3f}-{self.hi:.3f} over "
                f"{self.rounds} rounds)")


def time_rounds(fn: Callable, device: torch.device, rounds: int, iters: int,
                warmup: int = 2) -> Timing:
    """``fn``'s ms a call in each of ``rounds`` rounds of ``iters``
    back-to-back calls, after ``warmup`` calls: CUDA events on a card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    per_round: List[float] = []
    for _ in range(rounds):
        if device.type == "cuda":
            per_round.append(cuda_ms(fn, iters, warmup=0))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            per_round.append((time.perf_counter() - t0) * 1e3 / iters)
    return Timing(statistics.median(per_round), min(per_round), max(per_round), rounds)


# On the H100 machine, once a process has run about a minute, torch.profiler
# (CUPTI) returns some traces with a short window's kernels missing, often
# every other trace, and a long window's with a few rows missing
# (``tools/cupti_check.py`` traces the same calls back to back over the
# process's age; ``chip_smoke.py`` phase 20 does so late in a long run).
# ``breakdown`` traces again, up to ``TRACE_TRIES`` times, while a trace is
# empty or a port kernel its wrapper counted has fewer rows than launches.
TRACE_TRIES = 3


def trace_kernels(fn: Callable, iters: int) -> Tuple[Dict[str, List[float]], float]:
    """``iters`` calls of ``fn`` under ``torch.profiler`` (CUPTI): ({kernel
    name: [events, device ms]}, the calls' CUDA-event span in ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    return kernel_rows(prof.events()), start.elapsed_time(end)


def kernel_rows(events) -> Dict[str, List[float]]:
    """{kernel name: [events, device ms]} of a trace's rows on the card.
    The card-side mirrors of ``record_function`` ranges (the engine's
    ``litepose.engine.*`` spans) are left out: they run no kernel."""
    from torch.autograd import DeviceType

    rows: Dict[str, List[float]] = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or ms <= 0:
            continue
        row = rows.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += ms
    return rows


def by_family(rows: Dict[str, List[float]], iters: int) -> Dict[str, float]:
    """Device ms per call by family, largest first."""
    out: Dict[str, float] = {}
    for name, (_, ms) in rows.items():
        family = family_of(name)
        out[family] = out.get(family, 0.0) + ms / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernel_families(fn: Callable, iters: int):
    """Device ms per call of ``fn`` by kernel family and the idle share of
    the device over the window (1 - kernel time / the CUDA-event span of
    the ``iters`` calls; one stream assumed)."""
    rows, span_ms = trace_kernels(fn, iters)
    out = by_family(rows, iters)
    return out, 1.0 - sum(out.values()) * iters / span_ms


def profiler_ms(calls, names):
    """Mean device duration in ms of each kernel whose name contains one of
    ``names`` over the ``calls``, from torch.profiler (CUPTI); None for a
    kernel the trace shows no device time for."""
    rows, _ = trace_kernels(lambda: [call() for call in calls], 1)
    out = dict.fromkeys(names)
    for key, (count, ms) in rows.items():
        for name in names:
            if name in key:
                out[name] = ms / count
    return out


class Breakdown(NamedTuple):
    """A call's device ms per family (CUPTI), the CUDA kernel events of
    each family, the launches each port wrapper counted, and the device ms
    of each kernel by name, all per call; the port kernels that launched
    with fewer rows than launches in every trace, and the traces taken."""

    families: Dict[str, float]
    events: Dict[str, float]
    launches: Dict[str, float]
    missing: List[str]
    kernels: Dict[str, float]
    tries: int


def breakdown(fn: Callable, device: torch.device, iters: int = 3) -> Breakdown:
    """``fn``'s device time by family over ``iters`` traced calls, on a
    card, traced again (up to ``TRACE_TRIES`` times) while the trace is
    empty or a port kernel its wrapper counted has fewer CUPTI rows than
    launches; on the CPU an empty breakdown (no device to trace)."""
    if device.type != "cuda":
        return Breakdown({}, {}, {}, [], {}, 0)
    for tries in range(1, TRACE_TRIES + 1):
        before = port_launches()
        rows, _ = trace_kernels(fn, iters)
        after = port_launches()
        launches = {f: (after[f] - before[f]) / iters for f in after if after[f] > before[f]}
        events: Dict[str, float] = {}
        for name, (count, _) in rows.items():
            events[family_of(name)] = events.get(family_of(name), 0) + count / iters
        missing = [f for f, n in launches.items() if events.get(f, 0) < n]
        if rows and not missing:
            break
    kernels = {name: ms / iters
               for name, (_, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1])}
    return Breakdown(by_family(rows, iters), events, launches, missing, kernels, tries)


def report_breakdown(label: str, b: Breakdown, log=print) -> None:
    """The breakdown as lines: ms per family with its kernel events, then a
    line of its own for each port kernel that launched but has no row."""
    if not b.tries:
        log(f"  {label}: device time by kernel family not measured (no card)")
        return
    if not b.families:
        log(f"  {label}: CUPTI returned no kernel rows in {b.tries} traces")
        return
    log(f"  {label}, device ms a call by kernel family (CUPTI): " + ", ".join(
        f"{f} {ms:.3f} ({b.events.get(f, 0):g} kernels)" for f, ms in b.families.items()))
    for f, n in b.launches.items():
        log(f"    {f}: {n:g} launches a call counted by its wrapper")
    if b.tries > 1:
        log(f"    traced {b.tries} times: CUPTI lost rows of the earlier traces")
    for f in b.missing:
        log(f"  {label}: {f} launched {b.launches[f]:g} times a call but CUPTI shows "
            f"{b.events.get(f, 0):g} rows for it in each of {b.tries} traces; the trace's "
            f"kernels: {list(b.kernels)}")
