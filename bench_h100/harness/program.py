"""The program's own spans in a traced window: the ``litepose.*`` ranges
that the port opens (``litepose_tpu_torch/utils/spans.py``), reduced to
``record["program"]`` for the per-layer readers of the engine's host side.

The spans are ``record_function`` ranges, so they lie on the clock of the
profiler's host ops and CUPTI rows.  For each span name:

- ``count``: the spans in the window;
- ``host_s``: host seconds inside the window (each span clipped to it);
- ``self_s``: ``host_s`` less the part its child ``litepose.*`` spans cover;
- ``launches``: kernel launches (``LAUNCHES`` runtime rows) whose innermost
  ``litepose.*`` span it is, and ``launch_ops``: those launches by the
  innermost host op open at the launch (``aten::add``);
- ``device_s``: device seconds of the kernels and copies whose launching
  runtime row (found by its CUPTI correlation, not by overlap on the card)
  has it as its innermost span.

``idle_gaps`` puts each idle gap of the card down to the innermost span
open at its midpoint, or to ``CALLER`` when none is; ``unlinked_device_s``
is the device time in the window whose runtime row the trace lacks.  A
trace with no ``litepose.*`` span (a program without them) reduces to
``{}``, and every reader of it returns None.

The traced run does not call ``reduce`` yet: that is one call in
``trace.traced``, ``reduce(prof.events(), spans)`` stored as
``record["program"]`` before the profiler is dropped, and then a file in
``metrics/`` and an entry in ``BENCHMARK.json`` for each reader at the end
of this module (PERF.md §7).
"""

from __future__ import annotations

import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

from . import trace

PREFIX = "litepose."
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
CALLER = "caller"
NO_HOST_OP = "host python"  # trace._host_labels' label where no host op is open


class Host(NamedTuple):
    """A host event: a span, an op or a CUDA runtime call, with the CUPTI
    correlation of a runtime call."""

    name: str
    thread: int
    start: float  # us
    end: float
    corr: int = 0


class Device(NamedTuple):
    """A kernel or copy on the card, with the correlation of the runtime
    call that launched it."""

    name: str
    start: float  # us
    end: float
    corr: int


def is_runtime(name: str) -> bool:
    """A call into CUDA's runtime (``cudaMemcpyAsync``) or its ``cu*`` API
    (``cuLaunchKernel``), not an op or a span."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def rows(events) -> Tuple[List[Host], List[Device]]:
    """``torch.profiler`` events -> host events and card rows; the ranges
    mirrored on the card's timeline are left out, as ``trace.traced``
    leaves them out."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            host.append(Host(e.name, int(e.thread), a, b, int(e.id)))
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device.append(Device(e.name, a, b, int(e.id)))
    return host, device


def _innermost(events: List[Host], times: List[float]) -> List[Optional[str]]:
    """For each of ``times`` (any order), the name of the innermost of
    ``events`` open then (``trace._host_labels``), None where none is."""
    nested = sorted(events, key=lambda e: (e.start, -e.end))  # a parent before its children
    order = sorted(range(len(times)), key=times.__getitem__)
    labels = trace._host_labels([(e.name, e.start, e.end) for e in nested],
                                [times[k] for k in order])
    out: List[Optional[str]] = [None] * len(times)
    for k, label in zip(order, labels):
        out[k] = None if label == NO_HOST_OP else label
    return out


def _clip(a: float, b: float, lo: float, hi: float) -> float:
    return max(0.0, min(b, hi) - max(a, lo))


def _op_of(events: List[Host], threads: Dict[int, List[Host]],
           calls: List[Host]) -> List[Optional[str]]:
    """For each runtime call, the innermost of ``events`` open at its start
    on its thread, or on any thread where the profiler gave the call a
    thread that no span is on (``threads``: the spans by thread)."""
    out: List[Optional[str]] = [None] * len(calls)
    groups: Dict[int, List[int]] = {}
    for k, r in enumerate(calls):
        groups.setdefault(r.thread if r.thread in threads else -1, []).append(k)
    for thread, ks in groups.items():
        on = events if thread == -1 else [e for e in events if e.thread == thread]
        for k, name in zip(ks, _innermost(on, [calls[k].start for k in ks])):
            out[k] = name
    return out


def reduce_rows(host: List[Host], device: List[Device],
                windows: List[Tuple[float, float]]) -> Dict:
    """Host events, card rows and the harness's call spans (start, end us)
    -> ``record["program"]``."""
    spans = [h for h in host if h.name.startswith(PREFIX)]
    if not spans or not windows:
        return {}
    lo, hi = min(a for a, _ in windows), max(b for _, b in windows)
    out: Dict[str, Dict] = {}
    for s in spans:
        if s.end > lo and s.start < hi:
            o = out.setdefault(s.name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                        "launches": 0, "launch_ops": {}, "device_s": 0.0})
            o["count"] += 1
            o["host_s"] += _clip(s.start, s.end, lo, hi) / 1e6
            o["self_s"] += _clip(s.start, s.end, lo, hi) / 1e6

    # a child's clipped time leaves its parent's self time
    threads: Dict[int, List[Host]] = {}
    for s in spans:
        threads.setdefault(s.thread, []).append(s)
    for on_thread in threads.values():
        stack: List[Host] = []
        for s in sorted(on_thread, key=lambda s: (s.start, -s.end)):
            while stack and stack[-1].end < s.end:
                stack.pop()
            if stack and stack[-1].name in out:
                out[stack[-1].name]["self_s"] -= _clip(s.start, s.end, lo, hi) / 1e6
            stack.append(s)

    # runtime calls in the window -> their innermost span, on their thread
    # (on every thread's spans where the profiler gave the call a thread of
    # its own)
    runtime = [h for h in host if is_runtime(h.name) and lo <= h.start <= hi]
    where = dict(zip(map(id, runtime), _op_of(spans, threads, runtime)))
    launches = [r for r in runtime if r.name in LAUNCHES and where[id(r)] in out]
    ops = [h for h in host if not is_runtime(h.name)]  # spans too: a launch in no op
    for r, op in zip(launches, _op_of(ops, threads, launches)):
        o = out[where[id(r)]]
        o["launches"] += 1
        o["launch_ops"][op] = o["launch_ops"].get(op, 0) + 1
    launched_by = {r.corr: where[id(r)] for r in runtime}
    unlinked = 0.0
    for d in device:
        if d.end <= lo or d.start >= hi:
            continue
        if d.corr not in launched_by:
            unlinked += (d.end - d.start) / 1e6
        elif launched_by[d.corr] in out:
            out[launched_by[d.corr]]["device_s"] += (d.end - d.start) / 1e6

    # the card's idle gaps, by the span open at each gap's midpoint
    merged = trace._merge([(d.start, d.end) for d in device], lo, hi)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: Dict[str, float] = {}
    for (a, b), name in zip(holes, _innermost(spans, [(a + b) / 2 for a, b in holes])):
        gaps[name or CALLER] = gaps.get(name or CALLER, 0.0) + (b - a) / 1e6
    return {"spans": out, "idle_gaps": gaps, "unlinked_device_s": unlinked}


def note(program: Dict) -> str:
    """The idle split as one line for standard error."""
    gaps = sorted(program["idle_gaps"].items(), key=lambda kv: -kv[1])
    return ("program: idle time by the innermost litepose span open, ms in the window: "
            + (", ".join(f"{n} {s * 1e3:.3f}" for n, s in gaps) or "no idle gap")
            + f"; device ms with no runtime row {program['unlinked_device_s'] * 1e3:.3f}")


def reduce(events, windows: List[Tuple[float, float]]) -> Dict:
    """``reduce_rows`` of a profiler's events; the idle split goes to
    standard error as one line (it is no metric)."""
    program = reduce_rows(*rows(events), windows)
    if program:
        print(note(program), file=sys.stderr)
    return program


def per_call(record: Dict, span: str, field: str, scale: float = 1e3) -> Optional[float]:
    """``field`` of ``span`` a call of the window, times ``scale``; None
    where the program opened no such span."""
    found = record.get("program", {}).get("spans", {}).get(span)
    if not found or not record.get("calls"):
        return None
    return found[field] * scale / record["calls"]


def upload_host_ms(record: Dict) -> Optional[float]:
    return per_call(record, "litepose.engine.upload", "host_s")


def forward_host_ms(record: Dict) -> Optional[float]:
    return per_call(record, "litepose.engine.forward", "host_s")


def forward_launches(record: Dict) -> Optional[float]:
    return per_call(record, "litepose.engine.forward", "launches", scale=1)


def decode_host_ms(record: Dict) -> Optional[float]:
    return per_call(record, "litepose.engine.decode", "host_s")


def decode_device_ms(record: Dict) -> Optional[float]:
    return per_call(record, "litepose.engine.decode", "device_s")


def readback_wait_ms(record: Dict) -> Optional[float]:
    return per_call(record, "litepose.engine.readback", "host_s")
