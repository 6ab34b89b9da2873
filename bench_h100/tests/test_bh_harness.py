"""The harness on the CPU: the contract of ``BENCHMARK.json``, the lookup of
a cell's parts by name, the last line, the import guard, the frozen counts
and the reduction of a trace."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import BENCH, ROOT
from harness import core, devices, macs, spec, trace


@pytest.fixture()
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_meets_the_contract(bench):
    spec.validate(bench, ROOT)
    assert bench["command"] == ["python3", "bench_h100/run.py"]
    assert bench["paths"] == ["bench_h100"]


def test_every_file_is_found_by_its_name(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(bench, ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(cell.driver.run)
        for name, reader in cell.readers().items():
            assert callable(reader.read), name
    for f in os.listdir(os.path.join(BENCH, "configs")):
        with open(os.path.join(BENCH, "configs", f)) as fh:
            assert json.load(fh)["name"] + ".json" == f
    for f in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", f)) as fh:
            driver = json.load(fh)["driver"]
        assert os.path.isfile(os.path.join(BENCH, "drivers", driver + ".py")), f
    for f in os.listdir(os.path.join(BENCH, "metrics")):
        if f.endswith(".py"):
            assert callable(spec._module(os.path.join(BENCH, "metrics", f), "m_" + f).read), f


@pytest.mark.parametrize("where, bad", [
    ("end_to_end", {"name": "img per s"}),
    ("end_to_end", {"unit": "tokens per second"}),
    ("end_to_end", {"unit": "µs"}),
    ("per_layer", {"name": "copy/ms"}),
    ("per_layer", {"layer": "two\nlines"}),
    ("workloads", {"name": "serve,b64"}),
    ("end_to_end", {"bound": 0.5}),
    ("per_layer", {"why": "a key the contract has not"}),
])
def test_a_name_unit_or_key_outside_the_contract_is_refused(bench, where, bad):
    broken = copy.deepcopy(bench)
    broken[where][0].update(bad)
    with pytest.raises(spec.SpecError):
        spec.validate(broken, ROOT)


def test_import_guard_compares_whole_top_level_names():
    assert core.loaded_forbidden({"jax": 0, "jax.numpy": 0, "litepose_tpu.ops": 0,
                                  "litepose_tpu_torch": 0, "numpy": 0}) == ["jax", "litepose_tpu"]
    assert core.loaded_forbidden({"litepose_tpu_torch.core.engine": 0, "jaxtyping": 0,
                                  "flax_like": 0}) == []
    assert core.loaded_forbidden({"flax.serialization": 0, "jaxlib": 0}) == ["flax", "jaxlib"]


def _outcome(traced: bool):
    return core.Outcome(metrics={"img_per_s": 1.0}, attempted=4, failed=0,
                        checks=[core.Check("det_rel_rms", 0.01, 0.1)],
                        device={"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 1},
                        record={"ops": {}, "idle_gaps": {}} if traced else None)


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    out = _outcome(traced)
    bd = trace.breakdown(out.record) if traced else None
    line = json.loads(core.result_line(out, {"img_per_s": (1.0, "img/s")}, bd))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"img_per_s": {"value": 1.0, "unit": "img/s"}}
    assert line["checks"] == {"det_rel_rms": {"value": 0.01, "limit": 0.1}}


def test_a_check_over_its_limit_or_nan_is_not_correct():
    out = _outcome(False)
    out.checks.append(core.Check("decode_mismatch", 1.0, 0.0))
    assert not out.correct
    out.checks[-1] = core.Check("decode_mismatch", float("nan"), 0.0)
    assert not out.correct
    out.checks.pop()
    out.failed = 1
    assert not out.correct


@pytest.mark.parametrize("arch, published, gmacs", [
    ("auto_s448", "auto-S", 4.818363648), ("auto_xs256", "auto-XS", 1.153425408)])
def test_frozen_conv_counts(arch, published, gmacs):
    from litepose_tpu_torch.arch import get_arch
    from litepose_tpu_torch.arch.macs import count_litepose_macs

    with open(os.path.join(BENCH, "configs", arch + ".json")) as f:
        cfg = json.load(f)
    assert cfg["arch"] == get_arch(published).to_dict()
    assert macs.ptflops_macs(cfg["arch"]) == round(gmacs * 1e9)
    assert macs.ptflops_macs(cfg["arch"]) == count_litepose_macs(
        get_arch(published), include_elementwise=False)["macs"]
    layers = macs.conv_layers(cfg["arch"])
    deconv = [c for c in layers if c.transposed]
    assert len(deconv) == 6
    assert macs.macs(cfg["arch"]) == macs.ptflops_macs(cfg["arch"]) - sum(
        3 * c.macs for c in deconv)


def test_trace_reduction_and_checks():
    device = [("conv_depthwise2d_forward_kernel", 0.0, 40.0),
              ("Memcpy HtoD (Pageable -> Device)", 30.0, 50.0),
              ("nms_topk_band_kernel", 60.0, 70.0), ("nms_topk_merge_kernel", 70.0, 75.0),
              ("group_greedy_kernel", 80.0, 90.0), ("outside_kernel", 200.0, 210.0)]
    host = [("aten::copy_", 0.0, 52.0), ("cudaStreamSynchronize", 90.0, 99.0),
            ("aten::item", 89.0, 100.0)]
    record = trace.reduce_events(device, host, [(0.0, 50.0), (50.0, 100.0)])
    assert record["window_s"] == pytest.approx(100e-6)
    assert record["busy_s"] == pytest.approx(75e-6)
    assert set(record["ops"]) == {n for n, _, _ in device[:5]}
    assert record["idle_gaps"] == pytest.approx({"host python": 15e-6,
                                                 "cudaStreamSynchronize": 10e-6})
    record["launches"] = {"K1 nms_topk": 1, "K2 group_greedy": 1}
    assert trace.check(record) == []
    record["launches"]["K1 nms_topk"] = 3
    assert trace.check(record) == ["K1 nms_topk: 2 CUPTI rows for 3 counted launches"]
    record["launches"] = {"K1 nms_topk": 1}
    assert trace.check(record) == ["K2 group_greedy: 1 CUPTI rows for 0 counted launches"]
    assert trace.check({"ops": {"Memcpy HtoD": {"family": "memcpy / memset", "count": 1,
                                                "seconds": 1.0}}, "launches": {}}) \
        == ["the trace holds no kernel"]
    assert devices.family_of("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "nccl"


def _serve_record(cfg):
    ops = {"conv_depthwise2d_forward_kernel": {"family": "depthwise conv", "count": 4,
                                               "seconds": 0.06},
           "nms_topk_band_kernel": {"family": "K1 nms_topk", "count": 2, "seconds": 0.0002},
           "group_greedy_kernel": {"family": "K2 group_greedy", "count": 2, "seconds": 0.0001},
           "Memcpy HtoD (Pageable -> Device)": {"family": "memcpy / memset", "count": 2,
                                                "seconds": 0.008},
           "Memset (Device)": {"family": "memcpy / memset", "count": 2, "seconds": 0.001}}
    return {"ops": ops, "window_s": 0.1, "busy_s": 0.07, "calls": 2, "images": 128,
            "config": cfg, "launches": {}, "chips": 1}


def test_serving_readers(bench):
    cell = spec.Cell(bench, ROOT, "serve-s448-b64")
    got = {n: r.read(_serve_record(cell.config)) for n, r in cell.readers().items()}
    assert got["copy_ms.serve"] == pytest.approx(4.0)
    assert got["forward_ms.serve"] == pytest.approx(30.0)
    assert got["decode_ms.serve"] == pytest.approx(0.15)
    assert got["idle_share.serve"] == pytest.approx(30.0)
    flops = 2 * macs.macs(cell.config["arch"]) * 128 / 0.1
    assert got["mfu.serve"] == pytest.approx(100 * flops / 989e12)
    least = macs.least_seconds(cell.config["arch"], 2, 989e12, 3.35e12) * 64
    assert got["forward_roofline.serve"] == pytest.approx(100 * least / 0.030)
    empty = dict(_serve_record(cell.config), ops={}, busy_s=0.0)
    assert all(r.read(empty) is None for r in cell.readers().values())


@pytest.mark.parametrize("name", ["auto_s448", "auto_xs256"])
def test_checkpoint_is_pinned_by_its_hash(tmp_path, name):
    """The configuration pins its checkpoint's bytes: the committed file
    loads, and one with a byte changed is refused."""
    from harness import msgpack

    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    path = os.path.join(ROOT, cfg["weights"])
    params, _ = msgpack.load_params(path, cfg["weights_sha256"])
    assert params["stage"]
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[-1] ^= 1
    changed = tmp_path / "changed.msgpack"
    changed.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="sha256"):
        msgpack.load_params(str(changed), cfg["weights_sha256"])


def _tree_hashes(top):
    out = {}
    for d, _, files in os.walk(top):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


TINY_TRAFFIC = {"driver": "serve_closed_loop", "why": "a CPU-sized mix", "batch": 2,
                "pool_batches": 2, "warmup_calls": 1, "trace_calls": 2,
                "scene": {"people": [2, 3], "person_size": [40, 60]}}


def test_new_config_traffic_and_metric_are_files_alone(tmp_path, bench):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries of BENCHMARK.json) run with no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copytree(os.path.join(ROOT, "assets"), root / "assets")
    before = _tree_hashes(root / "bench_h100")
    with open(root / "bench_h100" / "configs" / "auto_xs256.json") as f:
        cfg = json.load(f)
    cfg.update(name="auto_xs256_copy")
    (root / "bench_h100" / "configs" / "auto_xs256_copy.json").write_text(json.dumps(cfg))
    (root / "bench_h100" / "traffic" / "tiny_b2.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "bench_h100" / "metrics" / "images_per_call.serve.py").write_text(
        "def read(record):\n    return record['images'] / record['calls']\n")
    grown = copy.deepcopy(bench)
    grown["configs"].append(dict(bench["configs"][1], name="auto_xs256_copy",
                                 file="bench_h100/configs/auto_xs256_copy.json"))
    grown["workloads"].append({"name": "serve-tiny", "config": "auto_xs256_copy",
                               "traffic": "tiny_b2", "chips": 1, "why": "a CPU-sized cell"})
    for m in grown["end_to_end"][:2]:
        m["workloads"].append("serve-tiny")
    grown["per_layer"].append({"name": "images_per_call.serve", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "img_per_s", "workloads": ["serve-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(grown))

    loaded = spec.load(str(root))
    cell = spec.Cell(loaded, str(root), "serve-tiny", bench_dir=str(root / "bench_h100"))
    assert [m["name"] for m in cell.per_layer] == ["images_per_call.serve"]
    ctx = core.Context(cell="serve-tiny", config=cell.config, traffic=cell.traffic, chips=1,
                       seed=2**31 + 77, seconds=0.5, trace=False, root=str(root),
                       t_start=time.perf_counter(), device="cpu")
    out = cell.driver.run(ctx)
    assert out.correct, core.check_lines(out)
    assert set(out.metrics) == {"img_per_s", "p95_ms", "setup_s"}
    assert cell.readers()["images_per_call.serve"].read({"images": 4, "calls": 2}) == 2
    after = _tree_hashes(root / "bench_h100")
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without CUDA, or in a directory holding only BENCHMARK.json and the
    benchmark's folder, a run exits non-zero and prints nothing."""
    shutil.copytree(BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "serve-s448-b64",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    """One short run of the smallest serving cell on the card, from run.py."""
    proc = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "serve-xs256-b128",
                           "--seed", str(2**31 + 9), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["img_per_s"]["value"])


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
