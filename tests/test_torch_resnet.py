"""The port's LitePose-ResNet against ``apply_litepose_resnet``.

fp32 with ``Policy.exact()`` against TF32 off, atol 2e-4 / rtol 1e-3, at
64 px (the fixed net keeps its table; the head is narrowed); weights both
ways through ``models.convert``; ``RESNET_SETTING`` against the JAX copy;
every shipped ResNet config; and what a reference ``.pth`` of this family
does in each package: the JAX CLI sends it to ``litepose_from_torch``,
which fails (ROADMAP Queue 3), the port refuses it by name.

Training: one SGD and one Adam step of the net with the CrowdPose head at
64 px, b2, against JAX's ``StepFns`` (the tolerances of
tests/test_torch_train.py, through
``torch_step_check.check_step_against_jax``), and a checkpoint
with the optimizer state crossing both ways."""

import os

import jax
import numpy as np
import pytest
import torch

from litepose_tpu.models import litepose_resnet as jres
from litepose_tpu.models.litepose import ModelSpec as JSpec

from litepose_tpu_torch.models import convert
from litepose_tpu_torch.models import litepose_resnet as res
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.models.litepose_resnet import LitePoseResNet, init_litepose_resnet
from test_torch_hrnet import assert_forward_equal, images, jax_forward, moved, port_forward
from test_torch_super_resnet import LR, OUT, WD, adam_of, batch_b2
from torch_step_check import check_step_against_jax

IMG = 64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "crowd_pose", "resnet", "resnet.yaml")
torch.set_num_threads(2)

CASES = {  # (spec, deconv filters)
    "crowdpose_head": (ModelSpec(deconv_kernels=(3, 3, 3)), (16, 24, 24)),
    "k5_head_one_tag": (ModelSpec(num_joints=5, tag_per_joint=False,
                                  deconv_kernels=(5, 3, 1)), (8, 16, 8)),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False


def seeded_model(spec, filters, seed=0):
    return moved(init_litepose_resnet(spec, torch.Generator().manual_seed(seed), filters,
                                      compute_dtype=torch.float32))


def apply_fn(kernels):
    def fn(p, s, x, spec, policy):
        return jres.apply_litepose_resnet(p, s, x, JSpec(**spec._asdict()),
                                          deconv_kernels=kernels, policy=policy)
    return fn


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_fp32(name):
    spec, filters = CASES[name]
    model = seeded_model(spec, filters)
    params, state = convert.litepose_resnet_to_jax(model)
    x = images()
    want = jax_forward(apply_fn(spec.deconv_kernels), params, state, x, spec)
    assert_forward_equal(port_forward(model, x), want)


def test_jax_init_round_trips_through_the_port():
    spec, filters = CASES["crowdpose_head"]
    params, state = jres.init_litepose_resnet(jax.random.PRNGKey(0), JSpec(**spec._asdict()),
                                              deconv_filters=filters,
                                              deconv_kernels=spec.deconv_kernels)
    model = convert.litepose_resnet_from_jax(jax.device_get(params), jax.device_get(state),
                                             spec, filters, compute_dtype=torch.float32)
    got_p, got_s = convert.litepose_resnet_to_jax(model)
    for a, b in ((got_p, params), (got_s, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, np.asarray(v))
    x = images(1)
    want = jax_forward(apply_fn(spec.deconv_kernels), params, state, x, spec)
    assert_forward_equal(port_forward(model, x), want)


def test_msgpack_crosses_packages(tmp_path):
    from litepose_tpu.train import checkpoint as jckpt

    from litepose_tpu_torch.train.checkpoint import load_model_params, save_params

    spec, filters = CASES["crowdpose_head"]
    src = seeded_model(spec, filters, seed=2)
    params, state = convert.litepose_resnet_to_jax(src)
    jckpt.save_params(str(tmp_path / "j.msgpack"), params, state)
    dst = LitePoseResNet(spec, filters, compute_dtype=torch.float32).eval()
    load_model_params(str(tmp_path / "j.msgpack"), dst)
    x = images(1)
    for a, b in zip(port_forward(dst, x), port_forward(src, x)):
        np.testing.assert_array_equal(a, b)
    save_params(str(tmp_path / "p.msgpack"), src)
    got = jckpt.load_params(str(tmp_path / "p.msgpack"), params, state)
    for u, v in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(u), v)


def test_fold_follows_mode_switches():
    """The conv-BN pairs fold at eval (as the JAX blocks' ``conv_bn``) once,
    drop the folds in training and fold again after."""
    spec, filters = CASES["crowdpose_head"]
    model = seeded_model(spec, filters, seed=3)
    x = torch.from_numpy(images(1).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        a = model(x)
        assert all(hasattr(c, "folded_w") for c, _ in model._conv_bn_pairs())
        model.train()
        assert not any(hasattr(c, "folded_w") for c, _ in model._conv_bn_pairs())
        b = model.eval()(x)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_copies_and_config_match_jax():
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update

    from litepose_tpu_torch.config import default_config, update_config

    assert res.RESNET_SETTING == jres.RESNET_SETTING
    assert res.RESNET_INPUT_CHANNEL == jres.RESNET_INPUT_CHANNEL
    cfg, jcfg = update_config(default_config(), CONFIG), j_update(j_default(), CONFIG)
    assert cfg.to_dict() == jcfg.to_dict()
    assert ModelSpec.from_config(cfg)._asdict() == JSpec.from_config(jcfg)._asdict()


def test_reference_pth_fails_in_jax_and_is_refused_by_the_port(tmp_path):
    """A ``pose_resnet`` ``.pth.tar``: the JAX eval CLI's branch
    (``tools/valid.py:133-140``) calls ``litepose_from_torch``, which reads
    LitePose keys and raises ``KeyError``; the port's CLI raises
    ``NotImplementedError`` naming the ROADMAP item."""
    from litepose_tpu.arch.manager import ArchManager
    from litepose_tpu.models.torch_convert import litepose_from_torch

    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.tools import valid

    spec, filters = CASES["crowdpose_head"]
    sd = seeded_model(spec, filters).state_dict()
    arch = ArchManager(deconv_setting=filters).fixed_sample(reso=256, ratio=1.0)
    with pytest.raises(KeyError):
        litepose_from_torch(sd, JSpec(**spec._asdict()), arch, with_skips=True)
    path = tmp_path / "resnet.pth.tar"
    torch.save({"state_dict": sd}, path)
    cfg = update_config(default_config(), CONFIG, ["TEST.MODEL_FILE", str(path)])
    with pytest.raises(NotImplementedError, match="Queue 3"):
        valid.build_model(cfg, None, "cpu")


# -- the train step and its checkpoints ------------------------------------------------


@pytest.fixture(scope="module")
def trained_trees():
    """(params, state) numpy trees of the moved seeded fixed net (CrowdPose head)."""
    spec, filters = CASES["crowdpose_head"]
    return convert.litepose_resnet_to_jax(seeded_model(spec, filters, seed=4))


def _port_ts(trees, name, dtype=torch.float32):
    from litepose_tpu_torch.train import optim
    from litepose_tpu_torch.train.checkpoint import init_train_state

    spec, filters = CASES["crowdpose_head"]
    model = convert.litepose_resnet_from_jax(*trees, spec, filters, compute_dtype=dtype,
                                             out_dtype=dtype).to(dtype).train()
    opt, sched = optim.make_optimizer(name, model.parameters(),
                                      optim.multistep_lr(LR[name], [100], 0.1, 10),
                                      weight_decay=WD)
    return init_train_state(model, opt, sched)


@pytest.fixture(scope="module")
def jax_steps(trained_trees):
    """{optimizer: JAX's step results (loss, metrics, grads, new BN state,
    params) as numpy}."""
    import jax.numpy as jnp
    import optax

    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns

    spec, _ = CASES["crowdpose_head"]
    params, state = trained_trees

    def apply_fn(p, s, x):
        return jres.apply_litepose_resnet(p, s, x, JSpec(**spec._asdict()),
                                          deconv_kernels=spec.deconv_kernels, train=True,
                                          policy=Policy.exact())

    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    out = {}
    for name in ("sgd", "adam"):
        tx = optax.chain(keep_grads, jopt.make_optimizer(
            name, jopt.multistep_lr(LR[name], [100], 0.1, 10), weight_decay=WD))
        step = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=IMG,
                        base_output_sizes=OUT).get()
        ts = jinit_ts(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                      tx.init(params))
        ts, metrics = step(ts, batch_b2())
        out[name] = jax.tree.map(np.asarray, {"metrics": metrics, "grads": ts.opt_state[0],
                                              "state": ts.model_state, "params": ts.params})
    return out


def _port_step(trees, name, dtype=torch.float32):
    from litepose_tpu_torch.core.losses import LossConfig
    from litepose_tpu_torch.train.trainer import StepFns

    ts = _port_ts(trees, name, dtype)
    batch = batch_b2()
    for key in ("heatmaps", "masks"):
        batch[key] = [torch.from_numpy(x).to(dtype) for x in batch[key]]
    ts, metrics = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu")).get()(
        ts, batch)
    return ts, {k: float(v) for k, v in metrics.items()}, \
        {n: p.grad for n, p in ts.model.named_parameters()}


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_step_matches_jax(trained_trees, jax_steps, name):
    """One step of the fixed net (published table, CrowdPose head, 64 px,
    b2) against JAX's ``StepFns``, at tests/test_torch_super_resnet.py's
    ``check_step_against_jax`` (tests/test_torch_train.py's tolerances)."""
    ts, metrics, grads = _port_step(trained_trees, name)
    assert ts.step == 1 and ts.model.training
    exact = _port_step(trained_trees, name, torch.float64)[2]
    check_step_against_jax(jax_steps[name], ts, metrics, grads, exact,
                           convert.litepose_resnet_entries(ts.model),
                           convert.litepose_resnet_to_jax, adam_of(name, trained_trees[0]))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_checkpoint_with_optimizer_state_crosses_packages(trained_trees, tmp_path, name):
    """The port's ``save_checkpoint`` after a step restores in JAX (weights,
    BN statistics, optax state, counters) bit for bit and optax steps with
    it; JAX's checkpoint of that state resumes in the port bit for bit."""
    import jax.numpy as jnp
    from flax import serialization

    from litepose_tpu.train import checkpoint as jck
    from litepose_tpu.train import optim as jopt

    from litepose_tpu_torch.train import checkpoint as tck

    ts, _, _ = _port_step(trained_trees, name)
    ts = ts._replace(epoch=2)
    tck.save_checkpoint(str(tmp_path / "p"), ts)
    params, state = trained_trees
    tx = jopt.make_optimizer(name, jopt.multistep_lr(LR[name], [100], 0.1, 10), weight_decay=WD)
    template = jck.init_train_state(jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, state), tx.init(params))
    restored = jck.auto_resume(str(tmp_path / "p"), template)
    assert (int(restored.step), int(restored.epoch)) == (1, 2)
    want_p, want_s = convert.litepose_resnet_to_jax(ts.model)
    want_o = serialization.to_state_dict(tck.opt_state_tree(ts))
    got_o = serialization.to_state_dict(jax.tree.map(np.asarray, restored.opt_state))
    for got, want in ((restored.params, want_p), (restored.model_state, want_s), (got_o, want_o)):
        assert jax.tree_util.tree_structure(jax.tree.map(np.asarray, got)) == \
            jax.tree_util.tree_structure(want)
        for u, v in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    tx.update(jax.tree.map(jnp.zeros_like, restored.params), restored.opt_state,
              restored.params)

    jck.save_checkpoint(str(tmp_path / "j"), restored._replace(epoch=restored.epoch + 1))
    back = tck.auto_resume(str(tmp_path / "j"), _port_ts(trained_trees, name))
    assert (back.step, back.epoch, back.scheduler.last_epoch) == (1, 3, 1)
    for k, v in ts.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.model.state_dict()[k], v), k
    got_o = serialization.to_state_dict(tck.opt_state_tree(back))
    for u, v in zip(jax.tree_util.tree_leaves(got_o), jax.tree_util.tree_leaves(want_o)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
