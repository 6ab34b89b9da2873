"""The EfficientHRNet cell's parts on the CPU: ``BENCHMARK.json`` with the
new cell, ``harness/effhrnet_macs.py`` against a count of the port's own
convolutions, the readers of the new per-layer metrics, and a run of the
driver at a narrow size."""

import copy
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import ROOT
from harness import core, effhrnet_macs, spec

CELL = "serve-effh1-480-b64"
NEW = ("backbone_ms.effhrnet.serve", "se_ms.effhrnet.serve", "forward_launches.effhrnet.serve",
       "mfu.effhrnet.serve", "forward_roofline.effhrnet.serve", "se_roofline.effhrnet.serve")


@pytest.fixture()
def cell():
    return spec.Cell(spec.load(ROOT), ROOT, CELL)


def narrow(cell, shift=True):
    """The configuration at stage widths 11..85 (scale factor -5), one module
    a stage, one block a branch, 96 px; its heatmap biases computed on the
    CPU as the cell's are on the card."""
    cfg = copy.deepcopy(cell.config)
    cfg.update(input_size=96, peak_scenes=4, peak_share=0.02)
    eff = cfg["effhrnet"]
    eff["scale_factor"] = -5
    for st in eff["stages"]:
        st.update(num_modules=1, num_blocks=[1] * st["num_branches"])
    eff["deconv"].update(num_basic_blocks=1)
    if shift:
        cfg["heatmap_bias_shift"] = cell.driver.heatmap_bias_shift(cfg, "cpu")
    return cfg


def test_benchmark_json_validates_with_the_new_cell(cell):
    assert cell.workload["chips"] == 1
    assert cell.traffic["driver"] == "serve_effhrnet_closed_loop"
    assert (cell.traffic["batch"], cell.traffic["pool_batches"]) == (64, 4)
    assert [m["name"] for m in cell.end_to_end] == ["img_per_s", "p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "copy_ms.serve", "forward_ms.serve", "decode_ms.serve", "idle_share.serve",
        "fuse_ms.hrnet.serve", "branches_ms.hrnet.serve", *NEW]
    assert cell.config["reduced"] == [] and cell.config["input_size"] == 480
    assert set(cell.readers()) == {m["name"] for m in cell.per_layer}


class _Convs(TorchDispatchMode):
    """Each convolution's multiply-adds, a transposed one at its input size,
    and each matrix product's (the squeeze-excitations' linears)."""

    def __init__(self):
        super().__init__()
        self.macs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, transposed = args[0], args[1], args[6]
            hw = x.shape[2] * x.shape[3] if transposed else out.shape[2] * out.shape[3]
            self.macs.append(x.shape[0] * w.numel() * hw)
        elif func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            a, b = args[-2], args[-1]
            self.macs.append(a.shape[0] * a.shape[1] * b.shape[1])
        return out


def test_effhrnet_macs_equals_a_count_of_the_port(cell):
    """The list's multiply-adds are the port's, conv by conv in the
    forward's order, at H-1@480 (counted on meta tensors, the training path
    at b1): 214 convs and 32 linears, 13.087 GMACs."""
    from litepose_tpu_torch.models.efficient_hrnet import EfficientHRNet

    cfg = cell.config
    with torch.device("meta"):
        model = EfficientHRNet(cell.driver.effhrnet_spec(cfg), compute_dtype=torch.float32)
    mode = _Convs()
    with torch.no_grad(), mode:
        model(torch.zeros(1, 3, 480, 480, device="meta"))
    layers = effhrnet_macs.conv_layers(cfg)
    assert [c.macs for c in layers] == mode.macs
    assert len(layers) == 246 and sum(not effhrnet_macs.is_se(c) for c in layers) == 214
    assert effhrnet_macs.macs(cfg) == 13_087_318_448


def _record(cfg, program=None):
    ops = {"sm90_xmma_fprop_implicit_gemm_bf16": {"family": "cuDNN / GEMM", "count": 600,
                                                 "seconds": 0.4},
           "Memcpy HtoD (Pageable -> Device)": {"family": "memcpy / memset", "count": 4,
                                                "seconds": 0.02}}
    record = {"ops": ops, "window_s": 0.5, "busy_s": 0.45, "calls": 4, "images": 256,
              "config": cfg, "launches": {}, "chips": 1}
    if program is not None:
        record["program"] = program
    return record


def _span(launches, device_s):
    return {"count": 4, "host_s": 0.01, "self_s": 0.01, "launches": launches,
            "launch_ops": {}, "device_s": device_s}


def test_readers_of_the_new_metrics(cell):
    program = {"spans": {"litepose.engine.forward": _span(40, 0.0),
                         "litepose.effhrnet.backbone": _span(400, 0.04),
                         "litepose.effhrnet.se": _span(128, 0.008),
                         "litepose.hrnet.transition": _span(90, 0.01),
                         "litepose.hrnet.branches": _span(1000, 0.2),
                         "litepose.hrnet.fuse": _span(400, 0.04),
                         "litepose.hrnet.head": _span(40, 0.01)},
               "idle_gaps": {}, "unlinked_device_s": 0.0}
    readers = cell.readers()
    cfg = cell.config
    got = {n: readers[n].read(_record(cfg, program)) for n in NEW}
    assert got["backbone_ms.effhrnet.serve"] == pytest.approx(12.0)
    assert got["se_ms.effhrnet.serve"] == pytest.approx(2.0)
    assert got["forward_launches.effhrnet.serve"] == pytest.approx(
        (40 + 400 + 128 + 90 + 1000 + 400 + 40) / 4)
    assert got["mfu.effhrnet.serve"] == pytest.approx(
        100 * 2 * effhrnet_macs.macs(cfg) * 256 / 0.5 / 989e12)
    least = effhrnet_macs.least_seconds(cfg, 2, 989e12, 3.35e12) * 64
    assert got["forward_roofline.effhrnet.serve"] == pytest.approx(100 * least / 0.1)
    se = effhrnet_macs.se_bytes(cfg, 64, 2) / 3.35e12
    assert got["se_roofline.effhrnet.serve"] == pytest.approx(100 * se / 0.002)
    # a program without the model's spans (the parent's engine spans alone, or none)
    engine_only = {"spans": {"litepose.engine.forward": _span(1500, 0.1)}, "idle_gaps": {},
                   "unlinked_device_s": 0.0}
    for program in (None, {}, engine_only):
        record = _record(cfg, program)
        for name in ("backbone_ms.effhrnet.serve", "se_ms.effhrnet.serve",
                     "se_roofline.effhrnet.serve"):
            assert readers[name].read(record) is None


TINY = {"driver": "serve_effhrnet_closed_loop", "why": "a CPU-sized mix", "batch": 2,
        "pool_batches": 2, "warmup_calls": 1, "trace_calls": 2,
        "scene": {"people": [2, 6], "person_size": [34.4, 114.4]}}


def test_a_narrow_run_is_correct(cell):
    cfg = dict(narrow(cell), limits={"det_rel_rms": 0.1, "tag_rel_rms": 0.1,
                                     "decode_mismatch": 0})
    ctx = core.Context(cell=CELL, config=cfg, traffic=TINY, chips=1, seed=2**31 + 41,
                       seconds=0.3, trace=False, root=ROOT, t_start=time.perf_counter(),
                       device="cpu")
    out = cell.driver.run(ctx)
    assert out.correct, core.check_lines(out)
    assert set(out.metrics) == {"img_per_s", "p95_ms", "setup_s"} and out.attempted > 0


def test_a_port_that_does_not_fold_fails_at_once(cell, monkeypatch):
    from litepose_tpu_torch.models import efficient_hrnet

    monkeypatch.setattr(efficient_hrnet, "EfficientHRNet",
                        type("EfficientHRNet", (torch.nn.Module,), {}))
    ctx = core.Context(cell=CELL, config=cell.config, traffic=TINY, chips=1, seed=1,
                       seconds=0.1, trace=False, root=ROOT, t_start=time.perf_counter(),
                       device="cpu")
    with pytest.raises(RuntimeError, match="does not fold"):
        cell.driver.run(ctx)
