"""The traced sub-window: ``torch.profiler`` (CUPTI) over a few calls that
the harness wraps in ``record_function`` spans, reduced to the record that
the per-layer readers (``metrics/<name>.py``) take.

The record holds the traced window's length and busy time, the device
operations by name with their family and seconds, the idle gaps by what
the host was doing, and the launches that each port kernel's wrapper
counted over the same calls.  ``check`` refuses a trace with no kernel and
one whose port kernel rows disagree with the counters; CUPTI on the H100
machine drops rows once a process is about a minute old, so the harness
traces early and traces again, a few times, before it gives up.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

from . import devices

SPAN = "bench_h100.call"
TRACE_TRIES = 3


def port_launches() -> Dict[str, int]:
    """Each port kernel family -> its wrapper's launch count so far."""
    out = {}
    for family, (module, wrapper, attr) in devices.PORT_COUNTERS.items():
        out[family] = int(getattr(getattr(importlib.import_module(module), wrapper), attr))
    return out


def _merge(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals clipped to [lo, hi], sorted and merged where they
    overlap."""
    merged: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
                  spans: List[Tuple[float, float]]) -> Dict:
    """Device rows (name, start us, end us), host ops and the harness's
    spans -> window, busy seconds, device operations and idle gaps."""
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    inside = [(n, a, b) for n, a, b in device if b > lo and a < hi]
    ops: Dict[str, List] = {}
    for name, a, b in inside:
        row = ops.setdefault(name, [devices.family_of(name), 0, 0.0])
        row[1] += 1
        row[2] += (min(b, hi) - max(a, lo)) / 1e6
    merged = _merge([(a, b) for _, a, b in inside], lo, hi)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: Dict[str, float] = {}
    for (a, b), label in zip(holes, _host_labels(host, [(a + b) / 2 for a, b in holes])):
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(b - a for a, b in merged) / 1e6,
            "ops": {n: {"family": f, "count": c, "seconds": s} for n, (f, c, s) in ops.items()},
            "idle_gaps": gaps}


def _host_labels(host: List[Tuple[str, float, float]], times: List[float]) -> List[str]:
    """For each of the increasing ``times``, the innermost host op running
    then (the one that started last), by one sweep over the ops."""
    ordered = sorted(host, key=lambda e: e[1])
    active: List[Tuple[str, float, float]] = []
    labels, i = [], 0
    for t in times:
        while i < len(ordered) and ordered[i][1] <= t:
            active.append(ordered[i])
            i += 1
        active = [e for e in active if e[2] >= t]
        labels.append(active[-1][0] if active else "host python")
    return labels


def traced(fn: Callable[[], None], calls: int, sync: Callable[[], None]) -> Dict:
    """``calls`` calls of ``fn``, each in a ``record_function`` span, under
    ``torch.profiler``: the reduced record plus the port launches the
    wrappers counted over the calls.  ``sync`` ends each span once the
    device is done with the call's work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    before = port_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function(SPAN):
                fn()
                sync()
    launches = {f: n - before[f] for f, n in port_launches().items()}
    device, host, spans = [], [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if getattr(e, "is_user_annotation", False) and e.device_type == DeviceType.CUDA:
            continue  # a span mirrored on the card's timeline (nccl:all_reduce): no kernel
        if e.name == SPAN:
            if e.device_type == DeviceType.CPU:
                spans.append(row[1:])
        elif e.device_type == DeviceType.CUDA:
            device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    del prof
    torch.cuda.synchronize()
    if not spans:
        raise RuntimeError("the trace holds none of the harness's spans")
    record = reduce_events(device, host, spans)
    record["launches"] = launches
    return record


def check(record: Dict) -> List[str]:
    """What makes a traced window unusable: no kernel, or a port kernel
    family whose CUPTI rows disagree with its wrapper's launch count (fewer
    rows than launches, or rows with no launch)."""
    problems = []
    if not any(not devices.is_copy(n) for n in record["ops"]):
        problems.append("the trace holds no kernel")
    rows: Dict[str, int] = {}
    for op in record["ops"].values():
        rows[op["family"]] = rows.get(op["family"], 0) + op["count"]
    for family in devices.PORT_FAMILIES:
        n, r = record["launches"].get(family, 0), rows.get(family, 0)
        if (n > 0 and r < n) or (n == 0 and r > 0):
            problems.append(f"{family}: {r} CUPTI rows for {n} counted launches")
    return problems


def trace_checked(fn: Callable[[], None], calls: int, sync: Callable[[], None]) -> Dict:
    """``traced``, again while ``check`` finds a problem, up to
    ``TRACE_TRIES`` times; raises with the problems of the last try."""
    for tries in range(1, TRACE_TRIES + 1):
        record = traced(fn, calls, sync)
        problems = check(record)
        if not problems:
            record["tries"] = tries
            return record
    raise RuntimeError("traced run refused: " + "; ".join(problems))


NAME_CHARS = 120  # a templated kernel name runs to thousands of characters


def breakdown(record: Dict) -> Dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing, the ten largest, in seconds over the window;
    names cut to ``NAME_CHARS``."""
    ops = sorted(((n, o["seconds"]) for n, o in record["ops"].items()), key=lambda x: -x[1])
    gaps = sorted(record["idle_gaps"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:10]],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps[:10]]}
