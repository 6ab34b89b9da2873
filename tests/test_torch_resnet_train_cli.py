"""The ResNet search space through the port's CLIs on the CPU: the train
CLI on the committed fixture for ``pose_superresnet``
(configs/crowd_pose/resnet/superresnet.yaml) and ``pose_resnet``
(resnet.yaml) at 64 px, b4, two epochs and a resume, and what the eval CLI
does with the weights each writes.

* The super-ResNet trains at the 32/64-px elastic sizes (the MobileNet
  ``ArchManager`` narrowed to them, as tests/test_torch_train_cli.py
  narrows it) with a desc drawn per step: its (size, desc) sequence is
  JAX's ``train_epoch``'s with the JAX CLI's sampler
  (``arch_to_mask_desc(ArchManager(...).random_sample(rng))``, the MobileNet
  space, whose stem and stage widths are the ResNet space's); its
  ``final_state.msgpack`` loads in JAX's ``load_params``.
* ``pose_resnet`` trains at the config's size; its ``final_state.msgpack``
  evaluates through the port's eval CLI.
* A super-ResNet ``.msgpack``: the JAX eval CLI fails in ``load_params``
  (it evaluates every "super" model as ``pose_mobilenet``); the port's
  raises ``ValueError`` before it builds an engine."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from litepose_tpu_torch.arch import ArchManager
from litepose_tpu_torch.models.litepose_resnet import LitePoseResNet, SuperLitePoseResNet
from litepose_tpu_torch.train.checkpoint import load_params
from litepose_tpu_torch.train.trainer import StepFns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
RESNET = os.path.join(REPO, "configs", "crowd_pose", "resnet")
SIZES = (32, 64)
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Elastic(ArchManager):
    """The MobileNet space with 32/64-px elastic sizes."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **dict(kw, img_sizes=SIZES))


def _argv(cfg, tmp, end_epoch):
    return ["--cfg", os.path.join(RESNET, cfg), "--ann-file",
            os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE, "--device", "cpu",
            "DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]",
            "TRAIN.IMAGES_PER_GPU", "4", "TRAIN.END_EPOCH", str(end_epoch), "PRINT_FREQ", "1",
            "SEED", str(SEED), "TPU.COMPUTE_DTYPE", "float32",
            "OUTPUT_DIR", str(tmp / "output"), "LOG_DIR", str(tmp / "log")]


def _train(cfg, tmp):
    """Two runs of the train CLI: epoch 0, then epochs 1-2 resumed.
    Returns (first run, second run, the (size, desc) of every step)."""
    import litepose_tpu_torch.arch as parch
    from litepose_tpu_torch.tools import train

    drawn = []
    get = StepFns.get

    def recording_get(self, img_size=None):
        step = get(self, img_size)

        def recorded(ts, batch, extra=None):
            drawn.append((img_size, None if extra is None else extra.tolist()))
            return step(ts, batch, extra)
        return recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parch, "ArchManager", _Elastic)
        mp.setattr(StepFns, "get", recording_get)
        first = train.main(_argv(cfg, tmp, 1))
        second = train.main(_argv(cfg, tmp, 3))
    return first, second, drawn


@pytest.fixture(scope="module")
def super_run(tmp_path_factory):
    return _train("superresnet.yaml", tmp_path_factory.mktemp("superresnet"))


@pytest.fixture(scope="module")
def resnet_run(tmp_path_factory):
    return _train("resnet.yaml", tmp_path_factory.mktemp("resnet"))


def _log(out_dir):
    return "".join(open(os.path.join(out_dir, f)).read()
                   for f in os.listdir(out_dir) if f.endswith(".log"))


@pytest.mark.parametrize("which", ["super", "fixed"])
def test_train_cli_trains_then_resumes(super_run, resnet_run, which):
    """Each config trains an epoch of 3 steps (12 fixture images at b4),
    writes its checkpoint and final weights, and a second run auto-resumes
    from the checkpoint for two more epochs."""
    first, second, drawn = super_run if which == "super" else resnet_run
    cls = SuperLitePoseResNet if which == "super" else LitePoseResNet
    assert isinstance(first.ts.model, cls) and first.ts.model.compute_dtype == torch.float32
    assert (first.ts.step, first.ts.epoch) == (3, 1)
    assert (second.ts.step, second.ts.epoch, len(second.epochs)) == (9, 3, 2)
    assert len(drawn) == 9
    losses = [m["total"] for m in first.epochs + second.epochs]
    assert np.isfinite(losses).all() and min(losses) > 0
    assert {"checkpoint.msgpack", "final_state.msgpack"} <= set(os.listdir(first.out_dir))
    assert "auto-resumed from epoch 1" in _log(first.out_dir)
    assert isinstance(second.ts.optimizer, torch.optim.Adam)
    assert second.ts.scheduler.last_epoch == 9


def test_super_resnet_draws_jax_sequence(super_run):
    """The super-ResNet's per-step (size, desc) equal JAX's ``train_epoch``
    draws with the JAX CLI's sampler, epoch by epoch; every desc is a width
    of the ResNet space; the fixed net draws neither."""
    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc
    from litepose_tpu.train.trainer import train_epoch as jtrain_epoch

    from litepose_tpu_torch.models.litepose_resnet import resnet_arch_manager

    class Recorder:
        def __init__(self, out):
            self.out = out

        def get(self, size=None, with_extra=False):
            def step(ts, batch, extra=None):
                self.out.append((size, np.asarray(extra).tolist()))
                return ts, {"total": 0.0}
            return step

    jm = JManager(deconv_setting=(64, 48, 32), img_sizes=SIZES, seed=SEED)
    want = []
    for epoch in range(3):
        jtrain_epoch(Recorder(want), None, [{"images": np.zeros((1, 1, 1, 3), np.uint8)}] * 3,
                     epoch=epoch, elastic_sizes=list(jm.img_sizes),
                     arch_sampler=lambda rng: jdesc(jm.random_sample(rng), jm), seed=SEED)
    _, _, drawn = super_run
    assert drawn == want
    assert len({s for s, _ in drawn}) == 2 and len({tuple(d) for _, d in drawn}) > 3
    space = resnet_arch_manager()
    widths = [space.channel_choices(space.input_channel)] + [
        space.channel_choices(c) for c, _, _ in space.stage_setting] + [
        space.channel_choices(c) for c in space.deconv_setting]
    for _, desc in drawn:
        assert all(v in w for v, w in zip(desc, widths)), desc


def test_fixed_resnet_draws_no_size_or_desc(resnet_run):
    _, _, drawn = resnet_run
    assert drawn == [(None, None)] * 9


def test_super_resnet_weights_load_in_jax(super_run):
    """The CLI's ``final_state.msgpack`` loads in JAX's ``load_params`` over
    the JAX init's template, leaf for leaf the trained model's."""
    import jax

    from litepose_tpu.models import litepose_resnet as jres
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.train.checkpoint import load_params as jload

    from litepose_tpu_torch.models.convert import super_resnet_to_jax

    _, second, _ = super_run
    path = os.path.join(second.out_dir, "final_state.msgpack")
    template = jax.eval_shape(lambda: jres.init_super_litepose_resnet(
        jax.random.PRNGKey(0), JSpec(deconv_kernels=(3, 3, 3)), deconv_filters=(64, 48, 32),
        deconv_kernels=(3, 3, 3)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)
    got = jload(path, *template)
    want = super_resnet_to_jax(second.ts.model)
    for (p, u), (_, v) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(np.asarray(u), v, err_msg=jax.tree_util.keystr(p))
    params, _ = load_params(path)
    assert "conv1" in params["first"] and len(params["stage"][3]) == 8


def test_trained_resnet_evaluates_through_the_eval_cli(resnet_run, tmp_path):
    """The fixed net's ``final_state.msgpack`` through the port's eval CLI
    (the CPU twins of K1, K3 and K4): the model it builds holds the trained
    weights, and the AP table comes out."""
    from litepose_tpu_torch.models.convert import litepose_resnet_to_jax
    from litepose_tpu_torch.tools import valid

    _, second, _ = resnet_run
    weights = os.path.join(second.out_dir, "final_state.msgpack")
    built = []
    build_engine = valid.build_engine

    def recording(cfg, model, device, mesh=None):
        built.append(model)
        return build_engine(cfg, model, device, mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(valid, "build_engine", recording)
        run = valid.main(["--cfg", os.path.join(RESNET, "resnet.yaml"), "--ann-file",
                          os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE,
                          "--max-images", "3", "--batch-size", "3", "--device", "cpu",
                          "DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]",
                          "TEST.FLIP_TEST", "False", "TPU.COMPUTE_DTYPE", "float32",
                          "TEST.MODEL_FILE", weights, "OUTPUT_DIR", str(tmp_path / "output"),
                          "LOG_DIR", str(tmp_path / "log")])
    (model,) = built
    assert isinstance(model, LitePoseResNet) and not model.training
    for u, v in zip(litepose_resnet_to_jax(model), litepose_resnet_to_jax(second.ts.model)):
        for a, b in zip(_flat(u), _flat(v)):
            np.testing.assert_array_equal(a, b)
    assert len(run.preds) == 3 and "AP" in run.stats


def _flat(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_super_resnet_msgpack_fails_in_jax_and_is_refused_by_the_port(tmp_path):
    """A ``pose_superresnet`` ``.msgpack`` in the eval CLI: JAX's builds
    ``pose_mobilenet`` (``tools/valid.py:108``) and its ``load_params``
    fails on the super-ResNet tree; the port's raises ``ValueError`` naming
    the cause before it builds a model or an engine."""
    import jax

    from litepose_tpu_torch.models.litepose import ModelSpec
    from litepose_tpu_torch.models.litepose_resnet import init_super_litepose_resnet
    from litepose_tpu_torch.tools import valid
    from litepose_tpu_torch.train.checkpoint import save_params

    path = str(tmp_path / "super.msgpack")
    save_params(path, init_super_litepose_resnet(ModelSpec(deconv_kernels=(3, 3, 3)),
                                                 torch.Generator().manual_seed(0)))
    flags = ["--cfg", os.path.join(RESNET, "superresnet.yaml"), "--ann-file",
             os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE,
             "--max-images", "1"]
    opts = ["DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]",
            "TEST.MODEL_FILE", path, "OUTPUT_DIR", str(tmp_path / "output"),
            "LOG_DIR", str(tmp_path / "log")]
    spec = importlib.util.spec_from_file_location("jax_valid_cli_superresnet",
                                                  os.path.join(REPO, "tools", "valid.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LITEPOSE_XLA_CACHE", jax.config.jax_compilation_cache_dir or "")
        mp.setattr(sys, "argv", ["valid.py"] + flags + opts)
        mp.setattr(cli, "build_engine", _no_engine)
        with pytest.raises(ValueError, match="keys"):
            cli.main()

    built = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(valid, "build_engine", lambda *a, **k: built.append(a))
        with pytest.raises(ValueError, match="pose_superresnet checkpoint"):
            valid.main(flags + ["--device", "cpu"] + opts)
    assert not built


def _no_engine(*args, **kw):
    raise AssertionError("the JAX eval CLI reached its engine")
