"""The serving engine's ``litepose.engine.*`` spans (``utils/spans.py``,
``core/engine.py``) under ``torch.profiler`` on the CPU.

Each engine call is one ``litepose.engine.call`` range whose children are
``upload``, ``forward``, ``decode`` and ``readback`` in that order, with
the engine's call number in its ``args``; a call of ``run_batch`` inside
``process_batch_square`` (as the benchmark's serving loop wraps it) opens no
second root.  A two-device CPU mesh records one ``litepose.engine.shard``
a shard, each on its own thread with the call's number.  With no profiler
on, ``span`` hands back one shared no-op context and makes no
``RecordFunction``.  The people are bit-identical with the profiler on and
off.  ``tools/timing.py`` counts no span mirrored on the card as a kernel.

The model is the trained Auto-XS (``assets/bench_ckpt_xs.msgpack``) at
fp32 on 128-px bench scenes, as tests/test_torch_mesh_engine.py runs it."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from litepose_tpu_torch.arch import get_arch
from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
from litepose_tpu_torch.core.inference import InferenceFlags
from litepose_tpu_torch.data.synthetic import bench_scene_batch
from litepose_tpu_torch.models.convert import litepose_from_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.ops.group import GroupParams
from litepose_tpu_torch.parallel import make_mesh
from litepose_tpu_torch.tools import timing
from litepose_tpu_torch.train.checkpoint import load_params
from litepose_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_PY = os.path.join(REPO, "litepose_tpu_torch", "core", "engine.py")
HRNET_PY = os.path.join(REPO, "litepose_tpu_torch", "models", "higher_hrnet.py")
EFFHRNET_PY = os.path.join(REPO, "litepose_tpu_torch", "models", "efficient_hrnet.py")
SIZE = 128
FLAGS = dict(num_joints=14, with_heatmaps_loss=(True, True), with_ae_loss=(True, False),
             test_with_heatmaps=(True, True), test_with_ae=(True, False), flip_test=False)
SERVING = dict(input_size=SIZE, assignment="greedy", topk_method="approx", with_adjust=False,
               with_refine=False, project2image=False)
CHILDREN = ["litepose.engine.upload", "litepose.engine.forward", "litepose.engine.decode",
            "litepose.engine.readback"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return litepose_from_jax(*load_params(os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")),
                             ModelSpec(num_joints=14), get_arch("auto-XS"),
                             compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def images():
    return bench_scene_batch(4, SIZE, seed=3)


def engine(model, **kw):
    return PoseEngine(model, InferenceFlags(**FLAGS), GroupParams(num_joints=14,
                                                                  detection_threshold=0.1),
                      EngineConfig(**SERVING), **kw)


@pytest.fixture()
def opened(monkeypatch):
    """Every (name, args) that ``span`` hands to ``record_function``."""
    seen = []
    real = spans.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(spans, "record_function", spy)
    return seen


def program_spans(prof):
    return [e for e in prof.events() if e.name.startswith("litepose.engine.")]


def children(event):
    return [c.name for c in event.cpu_children if c.name.startswith("litepose.engine.")]


def test_each_call_is_one_tree_of_spans(model, images, opened):
    eng = engine(model, device="cpu")
    run_batch = eng.run_batch
    eng.run_batch = lambda x: run_batch(x)  # as the benchmark's serving loop wraps it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.process_batch_square(images[:2])
        eng.process_batch_square(images[2:])
        run_batch(images[:2])
        eng.process(images[0])
    calls = [e for e in program_spans(prof) if e.name == "litepose.engine.call"]
    assert len(calls) == 4
    assert all(e.cpu_parent is None for e in calls)
    assert [children(e) for e in calls] == [CHILDREN, CHILDREN, CHILDREN[:3], CHILDREN]
    assert len(program_spans(prof)) == 4 + 4 + 4 + 3 + 4
    assert [a for n, a in opened if n == "litepose.engine.call"] == [
        "call=1 batch=2", "call=2 batch=2", "call=3 batch=2", "call=4 batch=1"]
    assert all(a is None for n, a in opened if n != "litepose.engine.call")


def test_mesh_records_one_shard_span_a_shard(model, images, opened):
    mesh = engine(model, mesh=make_mesh(2, "cpu"))
    try:
        # the shard threads are recorded by a profiler of every thread
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            mesh.process_batch_square(images)
    finally:
        mesh.close()
    events = program_spans(prof)
    (call,) = [e for e in events if e.name == "litepose.engine.call"]
    shards = [e for e in events if e.name == "litepose.engine.shard"]
    assert len(shards) == 2 and len({e.thread for e in shards} | {call.thread}) == 3
    assert all(e.cpu_parent is None and children(e) == CHILDREN for e in shards)
    (call_args,) = [a for n, a in opened if n == "litepose.engine.call"]
    number = re.fullmatch(r"call=(\d+) batch=4", call_args).group(1)
    assert sorted(a for n, a in opened if n == "litepose.engine.shard") == [
        f"call={number} shard=0", f"call={number} shard=1"]


def test_no_profiler_makes_no_record_function(model, images, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a RecordFunction with no profiler on")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span("litepose.engine.call", "call=1 batch=2") is spans.NOOP
    with spans.NOOP, spans.NOOP:  # shared, so it must nest
        pass
    people, _, counts = engine(model, device="cpu").process_batch_square(images[:2])
    assert people.shape == (2, 40, 14, 4) and counts.min() > 0


def test_people_are_bit_identical_with_the_profiler_on_and_off(model, images):
    eng = engine(model, device="cpu")
    off = eng.process_batch_square(images)
    with profile(activities=[ProfilerActivity.CPU]):
        on = eng.process_batch_square(images)
    assert off[2].min() > 0  # the trained weights find people in every scene
    for a, b in zip(off, on):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_every_span_is_opened_by_the_engine():
    """The engine opens the six ``litepose.engine.*`` spans, HigherHRNet's
    forward the five ``litepose.hrnet.*`` ones, EfficientHRNet's the two
    ``litepose.effhrnet.*`` ones, and ``SPANS`` is the three."""
    assert len(set(spans.SPANS)) == len(spans.SPANS) == 13
    assert spans.SPANS == spans.ENGINE_SPANS + spans.HRNET_SPANS + spans.EFFHRNET_SPANS
    for path, names, prefix in ((ENGINE_PY, spans.ENGINE_SPANS, "litepose.engine."),
                                (HRNET_PY, spans.HRNET_SPANS, "litepose.hrnet."),
                                (EFFHRNET_PY, spans.EFFHRNET_SPANS, "litepose.effhrnet.")):
        with open(path) as f:
            source = f.read()
        for name in names:
            assert name.startswith(prefix) and f'"{name}"' in source, name


def _event(name, device_type, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device_type, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_timing_counts_no_span_mirrored_on_the_card_as_a_kernel():
    events = [_event("litepose.engine.forward", DeviceType.CPU, 0.0, 900.0, True),
              _event("litepose.engine.forward", DeviceType.CUDA, 10.0, 800.0, True),
              _event("aten::conv2d", DeviceType.CPU, 5.0, 50.0),
              _event("conv_depthwise2d_forward_kernel", DeviceType.CUDA, 10.0, 410.0),
              _event("conv_depthwise2d_forward_kernel", DeviceType.CUDA, 420.0, 620.0),
              _event("Memcpy HtoD (Pageable -> Device)", DeviceType.CUDA, 0.0, 10.0),
              _event("empty_kernel", DeviceType.CUDA, 700.0, 700.0)]
    rows = timing.kernel_rows(events)
    assert rows == {"conv_depthwise2d_forward_kernel": [2, pytest.approx(0.6)],
                    "Memcpy HtoD (Pageable -> Device)": [1, pytest.approx(0.01)]}
    assert timing.by_family(rows, 2) == {"depthwise conv": pytest.approx(0.3),
                                         "memcpy / memset": pytest.approx(0.005)}
