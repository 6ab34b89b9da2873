"""The HigherHRNet cell's parts on the CPU: ``BENCHMARK.json`` with the new
cell, ``harness/hrnet_macs.py`` against a count of the port's own
convolutions, the readers of the new per-layer metrics, the traced window
that keeps the program's spans, and a run of the driver at a narrow size."""

import copy
import os
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import ROOT
from harness import core, hrnet_macs, spec, trace, trace_program

CELL = "serve-hrw48-640-b16"
NEW = ("fuse_ms.hrnet.serve", "branches_ms.hrnet.serve", "forward_launches.hrnet.serve",
       "mfu.hrnet.serve", "forward_roofline.hrnet.serve")


@pytest.fixture()
def bench():
    return spec.load(ROOT)


@pytest.fixture()
def cell(bench):
    return spec.Cell(bench, ROOT, CELL)


def narrow(cell, shift=True):
    """The configuration at widths 8/16/32/64, one module a stage, one
    block a branch, 96 px; its heatmap biases computed on the CPU as the
    cell's are on the card."""
    cfg = copy.deepcopy(cell.config)
    cfg.update(input_size=96, peak_scenes=4, peak_share=0.02)
    hr = cfg["hrnet"]
    hr["stem_inplanes"] = 8
    for st, w in zip(hr["stages"], ([8, 16], [8, 16, 32], [8, 16, 32, 64])):
        st.update(num_modules=1, num_blocks=[1] * len(w), num_channels=w)
    hr["deconv"].update(num_channels=[8], num_basic_blocks=1)
    if shift:
        cfg["heatmap_bias_shift"] = cell.driver.heatmap_bias_shift(cfg, "cpu")
    return cfg


def test_benchmark_json_validates_with_the_new_cell(bench, cell):
    assert cell.workload["chips"] == 1 and cell.traffic["driver"] == "serve_hrnet_closed_loop"
    assert [m["name"] for m in cell.end_to_end] == ["img_per_s", "p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "copy_ms.serve", "forward_ms.serve", "decode_ms.serve", "idle_share.serve", *NEW]
    assert cell.config["reduced"] == [] and cell.config["input_size"] == 640
    assert set(cell.readers()) == {m["name"] for m in cell.per_layer}


class _Convs(TorchDispatchMode):
    """Each convolution's multiply-adds, a transposed one at its input size."""

    def __init__(self):
        super().__init__()
        self.macs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, transposed = args[0], args[1], args[6]
            hw = x.shape[2] * x.shape[3] if transposed else out.shape[2] * out.shape[3]
            self.macs.append(x.shape[0] * w.numel() * hw)
        return out


def _counted(cfg, device):
    """The port's model of ``cfg`` run once on ``device`` at b1: each conv's
    multiply-adds in the order the forward runs them."""
    from litepose_tpu_torch.models.higher_hrnet import HigherHRNet

    driver = spec._module(os.path.join(ROOT, "bench_h100", "drivers",
                                       "serve_hrnet_closed_loop.py"), "hrnet_driver")
    with torch.device(device):
        model = HigherHRNet(driver.hrnet_spec(cfg), compute_dtype=torch.float32)
    mode = _Convs()
    with torch.no_grad(), mode:
        model(torch.zeros(1, 3, cfg["input_size"], cfg["input_size"], device=device))
    return mode.macs


def test_hrnet_macs_equals_a_count_of_the_port_at_a_small_size(cell):
    cfg = narrow(cell, shift=False)
    assert [c.macs for c in hrnet_macs.conv_layers(cfg)] == _counted(cfg, "cpu")


def test_hrnet_macs_at_w48_640(cell):
    """303 convs and 149.33 GMACs an image (the transposed conv at its input
    size), 153.81 with it at its output size (the paper: 154.3 GFLOPs); the
    port's own model gives the same list, counted on meta tensors."""
    layers = hrnet_macs.conv_layers(cell.config)
    assert len(layers) == 303
    assert hrnet_macs.macs(cell.config) == 149_328_691_200
    assert hrnet_macs.ptflops_macs(cell.config) == 153_811_353_600
    assert [c.macs for c in layers] == _counted(cell.config, "meta")


def _record(cfg, program=None):
    ops = {"sm90_xmma_fprop_implicit_gemm_bf16": {"family": "cuDNN / GEMM", "count": 600,
                                                 "seconds": 0.4},
           "nms_topk_band_kernel": {"family": "K1 nms_topk", "count": 4, "seconds": 0.004},
           "Memcpy HtoD (Pageable -> Device)": {"family": "memcpy / memset", "count": 4,
                                                "seconds": 0.02}}
    record = {"ops": ops, "window_s": 0.5, "busy_s": 0.45, "calls": 4, "images": 64,
              "config": cfg, "launches": {}, "chips": 1}
    if program is not None:
        record["program"] = program
    return record


def _span(launches, device_s):
    return {"count": 4, "host_s": 0.01, "self_s": 0.01, "launches": launches,
            "launch_ops": {}, "device_s": device_s}


def test_readers_of_the_new_metrics(cell):
    program = {"spans": {"litepose.engine.forward": _span(40, 0.0),
                         "litepose.hrnet.stem": _span(400, 0.02),
                         "litepose.hrnet.branches": _span(2000, 0.2),
                         "litepose.hrnet.fuse": _span(800, 0.08),
                         "litepose.hrnet.head": _span(120, 0.01)},
               "idle_gaps": {}, "unlinked_device_s": 0.0}
    readers = cell.readers()
    got = {n: readers[n].read(_record(cell.config, program)) for n in NEW}
    assert got["fuse_ms.hrnet.serve"] == pytest.approx(20.0)
    assert got["branches_ms.hrnet.serve"] == pytest.approx(50.0)
    assert got["forward_launches.hrnet.serve"] == pytest.approx((40 + 400 + 2000 + 800 + 120) / 4)
    flops = 2 * hrnet_macs.macs(cell.config) * 64 / 0.5
    assert got["mfu.hrnet.serve"] == pytest.approx(100 * flops / 989e12)
    least = hrnet_macs.least_seconds(cell.config, 2, 989e12, 3.35e12) * 16
    assert got["forward_roofline.hrnet.serve"] == pytest.approx(100 * least / 0.1)
    # a program with no spans (the parent's engine spans alone, or none)
    engine_only = {"spans": {"litepose.engine.forward": _span(1500, 0.1)}, "idle_gaps": {},
                   "unlinked_device_s": 0.0}
    assert readers["forward_launches.hrnet.serve"].read(
        _record(cell.config, engine_only)) == pytest.approx(375)
    for program in (None, {}, engine_only):
        record = _record(cell.config, program)
        assert readers["fuse_ms.hrnet.serve"].read(record) is None
        assert readers["branches_ms.hrnet.serve"].read(record) is None
    assert readers["forward_launches.hrnet.serve"].read(_record(cell.config, {})) is None


def test_traced_window_keeps_the_program_spans(monkeypatch):
    """``trace_program.traced`` gives ``trace.traced``'s record and the
    program's spans reduced from the same events."""
    from test_bh_program import _Profile, _profiler_events

    monkeypatch.setattr(_Profile, "events_list", _profiler_events(True))
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    want = trace.traced(lambda: None, 2, lambda: None)
    got = trace_program.traced(lambda: None, 2, lambda: None)
    assert got.pop("program")["spans"]["litepose.engine.forward"]["launches"] == 2
    assert got == want
    monkeypatch.setattr(_Profile, "events_list", _profiler_events(False))
    assert trace_program.traced(lambda: None, 2, lambda: None)["program"] == {}


def test_the_drawn_state_dict_is_the_port_state_dict(cell):
    """The cell's weights (``serve_hrnet_closed_loop.weights``), drawn from
    the configuration's widths alone, load into the port's model with
    ``strict=True``: the same names and shapes.  The heatmap biases are the
    configuration's shift, the tag biases 0, and a seed draws the same
    tensors."""
    from litepose_tpu_torch.models.higher_hrnet import HigherHRNet

    cfg = narrow(cell)
    sd = cell.driver.weights(cfg)
    model = HigherHRNet(cell.driver.hrnet_spec(cfg), compute_dtype=torch.float32)
    model.load_state_dict(sd)
    J = cfg["num_joints"]
    for k in ("final_layers.0.bias", "final_layers.1.bias"):
        assert sd[k][:J].tolist() == pytest.approx(cfg["heatmap_bias_shift"])
    assert not sd["final_layers.0.bias"][J:].any()
    again = cell.driver.weights(cfg)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_the_reference_takes_kernel_sizes_from_its_own_code(cell):
    """A state dict whose 1x1 fuse conv came as a 3x3 one is refused, not
    run at the weights' size."""
    from reference.higher_hrnet import Reference

    cfg = narrow(cell, shift=False)
    sd = cell.driver.weights(cfg, shift=[0.0] * cfg["num_joints"])
    name = "stage2.0.fuse_layers.0.1.0.weight"
    assert sd[name].shape[-1] == 1
    sd[name] = torch.zeros(*sd[name].shape[:2], 3, 3)
    ref = Reference(sd, cfg["hrnet"], cfg["num_joints"], "cpu")
    with pytest.raises(ValueError, match="a 1x1 kernel"):
        ref.maps(torch.zeros(1, 96, 96, 3, dtype=torch.uint8))


@pytest.mark.cuda
def test_the_committed_heatmap_bias_shift_is_the_reference_s(cell, card):
    """The configuration's ``heatmap_bias_shift`` is what the fp32
    reference gives on the card from the cell's weights, within 1e-5 of
    each value: the k-th value of each joint's maps (their scale is 1e4 to
    1e5 at these seeded weights), which fp32 convs summed in another order
    move by about 1e-6 of it."""
    got = cell.driver.heatmap_bias_shift(cell.config, "cuda")
    assert got == pytest.approx(cell.config["heatmap_bias_shift"], rel=1e-5)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


TINY = {"driver": "serve_hrnet_closed_loop", "why": "a CPU-sized mix", "batch": 2,
        "pool_batches": 2, "warmup_calls": 1, "trace_calls": 2,
        "scene": {"people": [2, 6], "person_size": [34.4, 114.4]}}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_narrow_run_is_correct(cell, dtype):
    cfg = dict(narrow(cell), compute_dtype=dtype, maps_dtype=dtype)
    ctx = core.Context(cell=CELL, config=cfg, traffic=TINY, chips=1, seed=2**31 + 41,
                       seconds=0.3, trace=False, root=ROOT, t_start=time.perf_counter(),
                       device="cpu")
    out = cell.driver.run(ctx)
    assert out.correct, core.check_lines(out)
    assert set(out.metrics) == {"img_per_s", "p95_ms", "setup_s"} and out.attempted > 0


def test_a_port_that_does_not_fold_fails_at_once(cell, monkeypatch):
    from litepose_tpu_torch.models import higher_hrnet

    monkeypatch.setattr(higher_hrnet, "HigherHRNet", type("HigherHRNet", (torch.nn.Module,), {}))
    ctx = core.Context(cell=CELL, config=cell.config, traffic=TINY, chips=1, seed=1, seconds=0.1,
                       trace=False, root=ROOT, t_start=time.perf_counter(), device="cpu")
    with pytest.raises(RuntimeError, match="does not fold"):
        cell.driver.run(ctx)
