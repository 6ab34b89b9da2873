"""The traced sub-window with the program's own spans kept: ``trace.traced``
and ``trace.trace_checked`` as they are, plus ``record["program"] =
program.reduce(prof.events(), spans)`` taken before the profiler is
dropped, for the readers of ``litepose.*`` spans (``harness/program.py``).

A program that opens no ``litepose.*`` span reduces to ``{}``, and every
reader of it returns None.
"""

from __future__ import annotations

from typing import Callable, Dict

from . import program, trace


def traced(fn: Callable[[], None], calls: int, sync: Callable[[], None]) -> Dict:
    """``trace.traced``'s record of ``calls`` calls of ``fn``, and the
    program's spans reduced over the same calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    before = trace.port_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function(trace.SPAN):
                fn()
                sync()
    launches = {f: n - before[f] for f, n in trace.port_launches().items()}
    events = prof.events()
    device, host, spans = [], [], []
    for e in events:
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if getattr(e, "is_user_annotation", False) and e.device_type == DeviceType.CUDA:
            continue  # a span mirrored on the card's timeline: no kernel
        if e.name == trace.SPAN:
            if e.device_type == DeviceType.CPU:
                spans.append(row[1:])
        elif e.device_type == DeviceType.CUDA:
            device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    if not spans:
        raise RuntimeError("the trace holds none of the harness's spans")
    found = program.reduce(events, spans)
    del events, prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    record = trace.reduce_events(device, host, spans)
    record["launches"] = launches
    record["program"] = found
    return record


def trace_checked(fn: Callable[[], None], calls: int, sync: Callable[[], None]) -> Dict:
    """``traced``, again while ``trace.check`` finds a problem, up to
    ``trace.TRACE_TRIES`` times; raises with the problems of the last try."""
    for tries in range(1, trace.TRACE_TRIES + 1):
        record = traced(fn, calls, sync)
        problems = trace.check(record)
        if not problems:
            record["tries"] = tries
            return record
    raise RuntimeError("traced run refused: " + "; ".join(problems))
