"""The port's data-parallel ``PoseEngine(mesh=...)`` and the eval CLI's
``--devices`` on the CPU, against the single-device engine and the JAX one
(the counterpart of tests/test_engine_multichip.py).

The mesh is ``make_mesh(2, "cpu")``: two replicas of the model on the host,
each shard on a thread of its own.  The model is the trained Auto-XS
(``assets/bench_ckpt_xs.msgpack``) at fp32, on 128-px bench scenes, as
tests/test_torch_engine.py holds it at 256 px.  The sharding contract is
the JAX one: a shard's people equal, bit for bit, the single-device
engine's on the same chunk of images (a batch of another size may take
other convolution paths, so a whole-batch run is not comparable bit for
bit).  Checked in serving (greedy) and in the exact decode (exact top-M,
Hungarian, adjust, refine) with flip test, in ``run_batch`` and in the
eval protocol (``process_many``, a padded last chunk, a batch size that
rounds down); against JAX's single-device engine on the same chunks
within tests/test_torch_engine.py's tolerances; an indivisible batch
raises.  The eval CLI with ``--devices 2 --device cpu`` gives the
predictions and AP of ``--devices 1`` at half the batch; with
``--batch-size 1`` it warns and runs on one device.  The launch counter
the shard threads share loses no count under contention."""

import glob
import os
import sys
import threading

import numpy as np
import pytest
import torch

from litepose_tpu_torch.arch import get_arch
from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
from litepose_tpu_torch.core.inference import InferenceFlags
from litepose_tpu_torch.data.flip import flip_index_for
from litepose_tpu_torch.data.synthetic import bench_scene_batch
from litepose_tpu_torch.models.convert import litepose_from_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.ops.group import GroupParams
from litepose_tpu_torch.parallel import make_mesh
from litepose_tpu_torch.train.checkpoint import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_XS = os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
CFG = os.path.join(REPO, "configs", "crowd_pose", "mobilenet", "mobile.yaml")
SIZE = 128
FLAGS = dict(num_joints=14, with_heatmaps_loss=(True, True), with_ae_loss=(True, False),
             test_with_heatmaps=(True, True), test_with_ae=(True, False),
             flip_index=tuple(flip_index_for("crowd_pose")))
# (engine config, flip test): serving, and the exact decode with flip
MODES = {
    "greedy": (dict(input_size=SIZE, assignment="greedy", topk_method="approx",
                    with_adjust=False, with_refine=False, project2image=False), False),
    "hungarian-flip": (dict(input_size=SIZE, assignment="hungarian", topk_method="exact",
                            project2image=False), True),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return load_params(CKPT_XS)


@pytest.fixture(scope="module")
def model(weights):
    return litepose_from_jax(*weights, ModelSpec(num_joints=14), get_arch("auto-XS"),
                             compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def images():
    return bench_scene_batch(4, SIZE, seed=3)


def engines(model, mode, eval_defaults=False):
    """(single-device engine, engine on a mesh of two host replicas)."""
    kw, flip = MODES[mode]
    cfg = EngineConfig(input_size=SIZE) if eval_defaults else EngineConfig(**kw)
    flags = InferenceFlags(**FLAGS, flip_test=flip or eval_defaults)
    group = GroupParams(num_joints=14, detection_threshold=0.1)
    return (PoseEngine(model, flags, group, cfg, device="cpu"),
            PoseEngine(model, flags, group, cfg, mesh=make_mesh(2, "cpu")))


def chunked(fn, images, per):
    outs = [fn(images[i:i + per]) for i in range(0, len(images), per)]
    return [np.concatenate([o[j] for o in outs]) for j in range(len(outs[0]))]


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_serving_equals_single_device_chunks(model, images, mode):
    single, mesh = engines(model, mode)
    try:
        got = mesh.process_batch_square(images)
    finally:
        mesh.close()
    want = chunked(single.process_batch_square, images, 2)
    assert got[0].shape == (4, 40, 14, 4 if mode == "greedy" else 5)
    assert want[2].min() > 0  # the trained weights find people in every scene
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mesh_run_batch_gathers_the_shards(model, images):
    single, mesh = engines(model, "greedy")
    try:
        got = mesh.run_batch(images)
    finally:
        mesh.close()
    want = chunked(lambda x: [t.numpy() for t in single.run_batch(x)], images, 2)
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mesh_batch,per_device", [(4, 2), (3, 1)])
def test_mesh_eval_protocol_equals_single_device_chunks(model, images, mesh_batch, per_device):
    """``process_many`` with the eval defaults (flip, projection, Hungarian,
    adjust, refine) over two shape buckets, the wide one's last batch
    padded: every image's people and scores equal the single-device
    engine's at the per-device batch (a mesh batch of 3 rounds down to 2)."""
    wide = [np.pad(im, ((0, 0), (0, 64), (0, 0))) for im in images[:3]]
    sources = list(images) + wide
    single, mesh = engines(model, "greedy", eval_defaults=True)
    try:
        got = mesh.process_many(sources, batch_size=mesh_batch)
    finally:
        mesh.close()
    want = single.process_many(sources, batch_size=per_device)
    assert sum(len(p) for p, _ in want) > 0
    for (gp, gs), (wp, ws) in zip(got, want):
        assert gs == ws and len(gp) == len(wp)
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_matches_jax_engine_on_chunks(model, weights, images, mode):
    """JAX's single-device engine (fp32, ``Policy.exact()``) on the mesh's
    chunks: counts equal, joints within 1e-3 px, scores and the rest within
    1e-4 (the fp32 forwards differ by summation order)."""
    from litepose_tpu.arch.zoo import get_arch as jget_arch
    from litepose_tpu.core.engine import EngineConfig as JConfig
    from litepose_tpu.core.engine import PoseEngine as JEngine
    from litepose_tpu.core.inference import InferenceFlags as JFlags
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import apply_litepose
    from litepose_tpu.ops.group_ref import GroupParams as JGroup

    kw, flip = MODES[mode]
    arch = jget_arch("auto-XS")

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, JSpec(num_joints=14), arch, policy=Policy.exact())[0]

    jax_engine = JEngine(apply_fn, *weights, JFlags(**FLAGS, flip_test=flip),
                         JGroup(num_joints=14, detection_threshold=0.1), JConfig(**kw))
    _, mesh = engines(model, mode)
    try:
        got = mesh.process_batch_square(images)
    finally:
        mesh.close()
    want = chunked(jax_engine.process_batch_square, images, 2)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0][..., :2], want[0][..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[0][..., 2:], want[0][..., 2:], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)


def test_mesh_refusals(model, images, monkeypatch):
    """An indivisible batch raises; the mesh copies a module, not a
    function; ``make_mesh`` raises without a card and when asked for more
    cards than are visible, and on the host gives replicas."""
    _, mesh = engines(model, "greedy")
    try:
        with pytest.raises(ValueError, match="not divisible"):
            mesh.process_batch_square(images[:3])
    finally:
        mesh.close()
    with pytest.raises(TypeError, match="nn.Module"):
        PoseEngine(lambda x: model(x), InferenceFlags(**FLAGS), GroupParams(), EngineConfig(),
                   mesh=make_mesh(2, "cpu"))
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="only 2 visible"):
        make_mesh(4)


def test_launch_counter_loses_no_count():
    """The shard threads of a mesh engine count launches on shared
    wrappers: 16 threads of 2000 counts each, with the interpreter
    switching threads as often as it can, lose none."""
    from litepose_tpu_torch.ops.library import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(wrapper) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert wrapper.launches == 16 * 2000


# -- the eval CLI -------------------------------------------------------------------


def _cli(out, arch_json, *extra):
    from litepose_tpu_torch.tools.valid import main

    return main(["--cfg", CFG, "--superconfig", arch_json,
                 "--ann-file", os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE,
                 "--max-images", "4", "--device", "cpu", *extra,
                 "TEST.MODEL_FILE", CKPT_XS, "TPU.COMPUTE_DTYPE", "float32",
                 "OUTPUT_DIR", os.path.join(out, "output"), "LOG_DIR", os.path.join(out, "log")])


@pytest.fixture(scope="module")
def arch_json(tmp_path_factory):
    import json

    path = str(tmp_path_factory.mktemp("arch") / "auto-XS.json")
    with open(path, "w") as f:
        json.dump(get_arch("auto-XS").to_dict(), f)
    return path


def test_eval_cli_devices_equals_one_device(arch_json, tmp_path):
    """``--devices 2 --batch-size 4`` on the fixture's first 4 images:
    every prediction and every AP stat of ``--devices 1 --batch-size 2``."""
    two = _cli(str(tmp_path / "two"), arch_json, "--devices", "2", "--batch-size", "4")
    one = _cli(str(tmp_path / "one"), arch_json, "--devices", "1", "--batch-size", "2")
    assert two.stats == one.stats
    assert two.scores == one.scores and sum(len(s) for s in one.scores) > 0
    for gp, wp in zip(two.preds, one.preds):
        assert len(gp) == len(wp)
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b)
    (log,) = glob.glob(str(tmp_path / "two" / "output" / "**" / "valid_*.log"), recursive=True)
    assert "img/s on cpu, cpu)" in open(log).read()


def test_eval_cli_devices_needs_the_batched_path(arch_json, tmp_path):
    """With ``--batch-size 1`` the CLI warns, in the JAX CLI's words, and
    evaluates on one device."""
    run = _cli(str(tmp_path), arch_json, "--devices", "2", "--batch-size", "1",
               "--max-images", "2")
    assert len(run.preds) == 2
    (log,) = glob.glob(str(tmp_path / "output" / "**" / "valid_*.log"), recursive=True)
    text = open(log).read()
    assert ("--devices ignored: data-parallel eval needs --batch-size > 1 and single-scale "
            "TEST.SCALE_FACTOR [1]") in text
    assert "img/s on cpu)" in text
