"""``harness/program.py`` on synthetic profiler events: the engine's
``litepose.*`` spans reduced to host, self and device seconds and launches,
each launch and device row put down to the innermost span of its runtime
call, the card's idle gaps split by span; the accepted readers unmoved by
the spans and their mirrors on the card; the program's readers None where
the program opened no span."""

import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from conftest import ROOT
from harness import program, spec, trace
from harness.program import Device, Host

WINDOWS = [(0.0, 100.0), (100.0, 200.0)]  # the harness's call spans, us
CALL, UPLOAD, FORWARD, DECODE, READBACK = (
    "litepose.engine.call", "litepose.engine.upload", "litepose.engine.forward",
    "litepose.engine.decode", "litepose.engine.readback")


def _events():
    """Two calls on thread 1, the second running past the window; a call
    outside it; ops, runtime calls (one on a thread of its own) and card
    rows linked by correlation."""
    spans = [Host(CALL, 1, 5, 95), Host(UPLOAD, 1, 6, 20), Host(FORWARD, 1, 20, 50),
             Host(DECODE, 1, 50, 60), Host(READBACK, 1, 60, 95),
             Host(CALL, 1, 105, 210), Host(UPLOAD, 1, 105, 110), Host(FORWARD, 1, 110, 150),
             Host(DECODE, 1, 150, 160), Host(READBACK, 1, 160, 210),
             Host(CALL, 1, 300, 310), Host(FORWARD, 1, 301, 309)]
    ops = [Host("aten::copy_", 1, 9, 13), Host("aten::conv2d", 1, 24, 27),
           Host("aten::add_", 1, 29, 32), Host("litepose::nms_topk", 1, 54, 57),
           Host("aten::conv2d", 1, 114, 117)]
    runtime = [Host("cudaMemcpyAsync", 1, 10, 12, corr=101),
               Host("cudaLaunchKernel", 1, 25, 26, corr=102),
               Host("cudaLaunchKernel", 1, 30, 31, corr=103),
               Host("cuLaunchKernel", 1, 55, 56, corr=104),
               Host("cudaLaunchKernel", 1, 115, 116, corr=105),
               Host("cudaMemcpyAsync", 1, 62, 90, corr=106),
               Host("cudaLaunchKernel", 999, 57, 57.5, corr=107),
               Host("cudaLaunchKernelExC", 1, 5.5, 5.8, corr=108),
               Host("cudaLaunchKernel", 1, 305, 306, corr=109)]
    device = [Device("Memcpy HtoD (Pageable -> Device)", 12, 22, 101),
              Device("conv_depthwise2d_forward_kernel", 26, 60, 102),
              # runs while the host is in decode and readback: forward's all the same
              Device("vectorized_elementwise_kernel<add>", 60, 70, 103),
              Device("nms_topk_band_kernel", 70, 72, 104),
              Device("group_greedy_kernel", 72, 73, 107),
              Device("Memcpy DtoH (Device -> Pageable)", 90, 91, 106),
              Device("conv_depthwise2d_forward_kernel", 116, 150, 105),
              Device("a_kernel_of_no_runtime_row", 150, 152, 999),
              Device("conv_depthwise2d_forward_kernel", 306, 330, 109)]
    return spans + ops + runtime, device


def test_spans_reduce_to_host_self_and_device_seconds_and_launches():
    got = program.reduce_rows(*_events(), WINDOWS)
    s = got["spans"]
    assert set(s) == {CALL, UPLOAD, FORWARD, DECODE, READBACK}
    assert {n: o["count"] for n, o in s.items()} == dict.fromkeys(s, 2)
    us = {n: (o["host_s"] * 1e6, o["self_s"] * 1e6, o["device_s"] * 1e6) for n, o in s.items()}
    assert us == {CALL: (pytest.approx(185), pytest.approx(1), 0.0),
                  UPLOAD: (pytest.approx(19), pytest.approx(19), pytest.approx(10)),
                  FORWARD: (pytest.approx(70), pytest.approx(70), pytest.approx(78)),
                  DECODE: (pytest.approx(20), pytest.approx(20), pytest.approx(3)),
                  READBACK: (pytest.approx(75), pytest.approx(75), pytest.approx(1))}
    assert {n: o["launches"] for n, o in s.items()} == {CALL: 1, UPLOAD: 0, FORWARD: 3,
                                                         DECODE: 2, READBACK: 0}
    assert s[FORWARD]["launch_ops"] == {"aten::conv2d": 2, "aten::add_": 1}
    # the launch on a thread of its own finds its op on any thread
    assert s[DECODE]["launch_ops"] == {"litepose::nms_topk": 2}
    assert s[CALL]["launch_ops"] == {CALL: 1}  # a launch in no op
    assert got["unlinked_device_s"] == pytest.approx(2e-6)
    gaps = {n: v * 1e6 for n, v in got["idle_gaps"].items()}
    assert gaps == {UPLOAD: pytest.approx(12), FORWARD: pytest.approx(4),
                    READBACK: pytest.approx(17 + 48), program.CALLER: pytest.approx(25)}
    line = program.note(got)
    assert line.startswith("program: idle time") and "\n" not in line
    assert "litepose.engine.readback 0.065" in line and "caller 0.025" in line


def test_no_program_span_reduces_to_nothing():
    host, device = _events()
    assert program.reduce_rows([h for h in host if not h.name.startswith("litepose.")],
                               device, WINDOWS) == {}
    assert program.reduce_rows(host, device, []) == {}


def _profiler_events(with_spans: bool):
    """Profiler-shaped events of two calls: the harness's spans, ops,
    runtime calls and card rows; with the engine's spans on the host and
    their mirrors on the card's timeline."""
    def ev(name, dev, a, b, corr=0, thread=1, annotation=False):
        return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=a, end=b),
                               thread=thread, id=corr, is_user_annotation=annotation)

    out = [ev(trace.SPAN, DeviceType.CPU, 0, 100, annotation=True),
           ev(trace.SPAN, DeviceType.CPU, 100, 200, annotation=True)]
    for base in (0, 100):
        out += [ev("aten::copy_", DeviceType.CPU, base + 9, base + 13, corr=base + 1),
                ev("cudaMemcpyAsync", DeviceType.CPU, base + 10, base + 12, corr=base + 51),
                ev("aten::conv2d", DeviceType.CPU, base + 24, base + 27, corr=base + 2),
                ev("cudaLaunchKernel", DeviceType.CPU, base + 25, base + 26, corr=base + 52),
                ev("cudaStreamSynchronize", DeviceType.CPU, base + 60, base + 95),
                ev("Memcpy HtoD (Pageable -> Device)", DeviceType.CUDA, base + 12, base + 22,
                   corr=base + 51),
                ev("conv_depthwise2d_forward_kernel", DeviceType.CUDA, base + 26, base + 80,
                   corr=base + 52),
                ev("nms_topk_band_kernel", DeviceType.CUDA, base + 80, base + 82,
                   corr=base + 53)]
        if with_spans:
            for name, a, b in ((CALL, 5, 95), (UPLOAD, 6, 20), (FORWARD, 20, 50),
                               (READBACK, 55, 95)):
                out += [ev(name, DeviceType.CPU, base + a, base + b, annotation=True),
                        ev(name, DeviceType.CUDA, base + a + 7, base + b + 30, annotation=True)]
    return out


class _Profile:
    events_list = []

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_list


def _traced(monkeypatch, with_spans: bool):
    monkeypatch.setattr(_Profile, "events_list", _profiler_events(with_spans))
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return trace.traced(lambda: None, 2, lambda: None)


def test_accepted_readers_are_unmoved_by_the_spans_and_their_mirrors(monkeypatch):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = spec.Cell(json.load(f), ROOT, "serve-s448-b64")
    values = []
    for with_spans in (False, True):
        record = dict(_traced(monkeypatch, with_spans), calls=2, images=128,
                      config=cell.config, traffic=cell.traffic, chips=1)
        values.append({n: r.read(record) for n, r in cell.readers().items()})
        # what the program's spans reduce to, from the same events
        found = program.reduce(_Profile.events_list, [(0.0, 100.0), (100.0, 200.0)])
        assert bool(found) is with_spans
    assert values[0] == values[1] and len(values[0]) == 6
    assert all(v is not None for v in values[0].values())
    record = dict(record, program=found)
    assert program.upload_host_ms(record) == pytest.approx(14e-3)
    assert program.forward_launches(record) == 1
    assert program.forward_host_ms(record) == pytest.approx(30e-3)
    assert program.readback_wait_ms(record) == pytest.approx(40e-3)
    assert program.decode_host_ms(record) is None  # these events open no decode span


READERS = (program.upload_host_ms, program.forward_host_ms, program.forward_launches,
           program.decode_host_ms, program.decode_device_ms, program.readback_wait_ms)


@pytest.mark.parametrize("record", [
    {"calls": 8}, {"calls": 8, "program": {}},
    {"calls": 8, "program": {"spans": {}, "idle_gaps": {}, "unlinked_device_s": 0.0}}])
def test_program_readers_read_nothing_without_program_spans(record):
    assert [r(record) for r in READERS] == [None] * 6
