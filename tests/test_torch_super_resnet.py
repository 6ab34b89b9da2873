"""The port's ResNet-space supernet (``SuperLitePoseResNet``,
``pose_superresnet``) against ``litepose_tpu.models.litepose_resnet``'s
``init_super_litepose_resnet`` / ``apply_super_litepose_resnet`` on the CPU.

Published widths and depths (JAX's super-ResNet has no other), the
CrowdPose head (deconv (64, 48, 32), 3x3 kernels), 64-px images, batch 2,
fp32 on both sides (JAX under ``Policy.exact()``, one jit a mode with the
desc a traced argument, so one compile serves every desc).  The weights
are the port's seeded init with every BN's affine and statistics and the
final biases moved off their identities (``test_torch_hrnet.moved``),
reaching JAX through ``models.convert``.

* the copies (``SUPER_RESNET_SETTING``, ``SUPER_RESNET_INPUT_CHANNEL``,
  ``resnet_arch_manager``) and the config against JAX's;
* the masked forward at the max desc, the 0.5x desc (the fixed net's stage
  widths) and a 0.25x desc, eval and train: outputs within atol 2e-4 /
  rtol 1e-3, the new BN statistics within atol 2e-4 (the step's bound
  below: at full depth fp32 summation alone moves them by 1e-5), the
  inactive channels' statistics bit-unchanged;
* the bridge round trip from the JAX init, bit for bit; the init's bounds;
* ``.msgpack`` weights and checkpoints, with Adam's and SGD's state, both
  ways;
* one SGD and one Adam step against JAX's ``StepFns`` at the max and the
  0.25x desc, at tests/test_torch_train.py's tolerances: the loss and its
  metrics rtol 1e-5, each gradient within 1e-4 relative of the port's
  float64 step and of JAX's beyond JAX's own distance from it, the BN
  statistics atol 2e-4, the parameters atol 1e-5 (after Adam's step, to
  optax's update of the port's gradients: ``check_step_against_jax``);
  at the 0.25x desc the
  gradient of every inactive channel is exactly 0 in both packages;
* the elastic sizes 256-512: the outputs at size/4 and size/2, the sizes
  of ``StepFns``' resized targets."""

import numpy as np
import pytest
import torch

from litepose_tpu.models import litepose_resnet as jres
from litepose_tpu.models.litepose import ModelSpec as JSpec

from litepose_tpu_torch.core.losses import LossConfig
from litepose_tpu_torch.models import convert
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.models.litepose_resnet import (SuperLitePoseResNet,
                                                       init_super_litepose_resnet,
                                                       resnet_arch_manager)
from litepose_tpu_torch.models.super_litepose import arch_to_mask_desc
from litepose_tpu_torch.train import optim
from litepose_tpu_torch.train.checkpoint import init_train_state
from litepose_tpu_torch.train.trainer import StepFns
from test_torch_hrnet import images, moved
from torch_step_check import check_step_against_jax, leaves

IMG, B = 64, 2
OUT = [IMG // 4, IMG // 2]
FILTERS = (64, 48, 32)
SPEC = ModelSpec(deconv_kernels=(3, 3, 3))
LR = {"sgd": 0.1, "adam": 2e-3}  # adam: superresnet.yaml's TRAIN.LR
WD = 1e-4
RATIOS = {"max": 1.0, "half": 0.5, "quarter": 0.25}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jspec():
    return JSpec(**SPEC._asdict())


def desc_of(name):
    """The int64 desc of ``resnet_arch_manager().fixed_sample(IMG, ratio)``."""
    return arch_to_mask_desc(resnet_arch_manager(FILTERS).fixed_sample(IMG, RATIOS[name]))


def nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def seeded(seed=0, dtype=torch.float32):
    return moved(init_super_litepose_resnet(SPEC, torch.Generator().manual_seed(seed), FILTERS,
                                            compute_dtype=dtype, out_dtype=dtype))


@pytest.fixture(scope="module")
def trees():
    """(params, state) numpy trees of the moved seeded supernet."""
    return convert.super_resnet_to_jax(seeded())


def port_model(trees, dtype=torch.float32):
    return convert.super_resnet_from_jax(*trees, SPEC, FILTERS, compute_dtype=dtype,
                                         out_dtype=dtype).to(dtype)


def bn_widths(desc) -> dict:
    """{BN state-dict prefix: its active width at ``desc``}."""
    d = desc.tolist()
    out = {"first.2": d[0]}
    cur = d[0]
    for si, (r, _, _, n, _) in enumerate(jres.SUPER_RESNET_SETTING):
        for bi in range(n):
            out[f"stage.{si}.{bi}.inv.1"] = cur * r
            out[f"stage.{si}.{bi}.point_conv.1"] = d[1 + si]
            cur = d[1 + si]
    for i in range(3):
        out[f"deconv_bnrelu.{i}.0"] = d[5 + i]
    return out


def test_copies_and_config_match_jax():
    import os

    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update

    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.models import litepose_resnet as res

    assert res.SUPER_RESNET_SETTING == jres.SUPER_RESNET_SETTING
    assert res.SUPER_RESNET_INPUT_CHANNEL == jres.SUPER_RESNET_INPUT_CHANNEL
    for deconv, seed in (((64, 48, 32), 3), ((16, 24, 24), None)):
        got, want = res.resnet_arch_manager(deconv, seed), jres.resnet_arch_manager(deconv, seed)
        for attr in ("deconv_setting", "input_channel", "stage_setting", "width_mults",
                     "img_sizes"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert got.max_arch(320).to_dict() == want.max_arch(320).to_dict()
        rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(5):
            assert got.random_sample(rng_a).to_dict() == want.random_sample(rng_b).to_dict()
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "crowd_pose", "resnet", "superresnet.yaml")
    cfg, jcfg = update_config(default_config(), path), j_update(j_default(), path)
    assert cfg.to_dict() == jcfg.to_dict()
    assert ModelSpec.from_config(cfg)._asdict() == JSpec.from_config(jcfg)._asdict()
    assert ModelSpec.from_config(cfg).deconv_kernels == SPEC.deconv_kernels


@pytest.fixture(scope="module")
def jax_forwards():
    """{train: jitted (params, state, x, desc) -> (outputs, new state)}."""
    import jax

    from litepose_tpu.models.layers import Policy

    return {train: jax.jit(lambda p, s, x, d, train=train: jres.apply_super_litepose_resnet(
        p, s, x, d, jspec(), train=train, policy=Policy.exact())) for train in (False, True)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(RATIOS))
def test_masked_forward_matches_jax(trees, jax_forwards, name, train):
    import jax.numpy as jnp

    desc = desc_of(name)
    x = images(B, IMG)
    outs, new_state = jax_forwards[train](*trees, jnp.asarray(x), jnp.asarray(desc.numpy()))
    model = port_model(trees).train(train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(nchw(x), desc)
    assert len(got) == len(outs) == 2
    for g, w in zip(got, outs):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=2e-4, rtol=1e-3)
    _, state = convert.super_resnet_to_jax(model)
    for (path, a), (_, b) in zip(leaves(state), leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=0, err_msg=str(path))
    after = model.state_dict()
    if not train:
        assert all(torch.equal(v, before[k]) for k, v in after.items())
        return
    for prefix, n in bn_widths(desc).items():
        for leaf in ("running_mean", "running_var"):
            key = f"{prefix}.{leaf}"
            assert torch.equal(after[key][n:], before[key][n:]), key  # inactive: frozen
            assert not torch.equal(after[key][:n], before[key][:n]), key


def test_default_desc_is_the_max_desc(trees):
    model = port_model(trees)
    x = nchw(images(1, IMG))
    assert model.max_desc.tolist() == [24, 32, 64, 96, 160, 64, 48, 32]
    with torch.no_grad():
        for a, b in zip(model(x), model(x, desc_of("max"))):
            assert torch.equal(a, b)


def test_jax_init_round_trips_through_the_port():
    """The JAX init's pytrees -> the port's model -> the same pytrees, leaf
    for leaf; the model has JAX's 20.06 M parameters."""
    import jax

    params, state = jax.device_get(jres.init_super_litepose_resnet(
        jax.random.PRNGKey(0), jspec(), deconv_filters=FILTERS, deconv_kernels=(3, 3, 3)))
    model = convert.super_resnet_from_jax(params, state, SPEC, FILTERS,
                                          compute_dtype=torch.float32)
    assert isinstance(model, SuperLitePoseResNet) and not model.training
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert 20.0e6 < n < 20.1e6
    got_p, got_s = convert.super_resnet_to_jax(model)
    for a, b in ((got_p, params), (got_s, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, np.asarray(v))


def test_init_bounds_match_jax():
    """Each conv kernel of the seeded init lies within JAX's bound
    sqrt(3 / fan_in) and fills it, like JAX's init; BNs and the final
    biases at their identities; one seed gives one model."""
    import jax

    jp, js = jax.device_get(jres.init_super_litepose_resnet(
        jax.random.PRNGKey(0), jspec(), deconv_filters=FILTERS, deconv_kernels=(3, 3, 3)))
    model = init_super_litepose_resnet(SPEC, torch.Generator().manual_seed(0), FILTERS)
    again = init_super_litepose_resnet(SPEC, torch.Generator().manual_seed(0), FILTERS)
    assert model.training
    jsd = convert.family_state_dict_from_jax(model, jp, js)
    for name, t in model.state_dict().items():
        j = jsd[name]
        assert t.shape == j.shape, name
        assert torch.equal(again.state_dict()[name], t), name
        if name.endswith("num_batches_tracked"):
            continue
        if t.dim() == 1:
            assert torch.equal(t, j), name  # BN identities, zero biases
            continue
        m = model.get_submodule(name.rsplit(".", 1)[0])
        bound = np.sqrt(3.0 / (m.kernel_size[0] * m.kernel_size[1] * m.in_channels))
        for w in (t, j):
            assert float(w.abs().max()) <= bound * (1 + 1e-6), name
            assert float(w.abs().max()) >= 0.85 * bound, name


def test_msgpack_weights_cross_packages(trees, tmp_path):
    import jax

    from litepose_tpu.train import checkpoint as jckpt

    from litepose_tpu_torch.train.checkpoint import load_model_params, save_params

    params, state = trees
    jckpt.save_params(str(tmp_path / "j.msgpack"), params, state)
    dst = SuperLitePoseResNet(SPEC, FILTERS, compute_dtype=torch.float32).eval()
    load_model_params(str(tmp_path / "j.msgpack"), dst)
    x = nchw(images(1, IMG))
    with torch.no_grad():
        for a, b in zip(dst(x, desc_of("half")), port_model(trees).eval()(x, desc_of("half"))):
            assert torch.equal(a, b)
    save_params(str(tmp_path / "p.msgpack"), dst)
    got = jckpt.load_params(str(tmp_path / "p.msgpack"), params, state)
    for u, v in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(u), v)


def _port_ts(trees, name, dtype=torch.float32):
    model = port_model(trees, dtype).train()
    opt, sched = optim.make_optimizer(name, model.parameters(),
                                      optim.multistep_lr(LR[name], [100], 0.1, 10),
                                      weight_decay=WD)
    return init_train_state(model, opt, sched)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_checkpoints_cross_packages_with_optimizer_state(trees, tmp_path, name):
    """A JAX ``save_checkpoint`` after three optax updates resumes in the
    port with bit-equal weights, moments and counts; the port's checkpoint
    of that state restores in JAX to the same trees, and optax steps with
    it."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import serialization

    from litepose_tpu.train import checkpoint as jck
    from litepose_tpu.train import optim as jopt

    from litepose_tpu_torch.train import checkpoint as tck

    params, state = trees
    tx = jopt.make_optimizer(name, jopt.multistep_lr(LR[name], [100], 0.1, 10),
                             weight_decay=WD)
    rng = np.random.default_rng(5)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    update = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u), o))(
        *tx.update(g, o, p)))
    for _ in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 1, x.shape).astype(np.float32)),
                         params)
        jp, opt_state = update(g, opt_state, jp)
    jts = jck.init_train_state(jp, jax.tree.map(jnp.asarray, state), opt_state, step=3)
    jck.save_checkpoint(str(tmp_path / "j"), jts._replace(epoch=jts.epoch + 2))

    ts = tck.auto_resume(str(tmp_path / "j"), _port_ts(trees, name))
    assert (ts.step, ts.epoch, ts.scheduler.last_epoch) == (3, 2, 3)
    want_p = jax.tree.map(np.asarray, jp)
    got_p, got_s = convert.super_resnet_to_jax(ts.model)
    for a, b in ((got_p, want_p), (got_s, state)):
        for (path, u), (_, v) in zip(leaves(a), leaves(b)):
            np.testing.assert_array_equal(u, v, err_msg=str(path))
    want_o = serialization.to_state_dict(jax.tree.map(np.asarray, opt_state))
    got_o = serialization.to_state_dict(tck.opt_state_tree(ts))
    assert jax.tree_util.tree_structure(got_o) == jax.tree_util.tree_structure(want_o)
    for (path, u), (_, v) in zip(leaves(got_o), leaves(want_o)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=str(path))

    tck.save_checkpoint(str(tmp_path / "p"), ts)
    restored = jck.auto_resume(str(tmp_path / "p"), jck.init_train_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state), tx.init(jp)))
    assert (int(restored.step), int(restored.epoch)) == (3, 2)
    for (path, u), (_, v) in zip(leaves(serialization.to_state_dict(
            jax.tree.map(np.asarray, restored.opt_state))), leaves(want_o)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=str(path))
    for (path, u), (_, v) in zip(leaves(restored.params), leaves(want_p)):
        np.testing.assert_array_equal(np.asarray(u), v, err_msg=str(path))
    update(jax.tree.map(jnp.zeros_like, restored.params), restored.opt_state, restored.params)


# -- the train step against JAX's ----------------------------------------------------


def batch_b2():
    from test_torch_train_cli import _batch

    return _batch(IMG, B)


@pytest.fixture(scope="module")
def jax_steps(trees):
    """{(optimizer, desc name): JAX's step results: loss, metrics, grads,
    new BN state and params, as numpy}.  One compile an optimizer."""
    import jax
    import jax.numpy as jnp
    import optax

    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns

    params, state = trees

    def apply_fn(p, s, x, desc):
        return jres.apply_super_litepose_resnet(p, s, x, desc, jspec(), train=True,
                                                policy=Policy.exact())

    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    out = {}
    for name in ("sgd", "adam"):
        tx = optax.chain(keep_grads, jopt.make_optimizer(
            name, jopt.multistep_lr(LR[name], [100], 0.1, 10), weight_decay=WD))
        step = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=IMG,
                        base_output_sizes=OUT).get(None, True)
        for d in ("max", "quarter"):
            ts = jinit_ts(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                          tx.init(params))
            ts, metrics = step(ts, batch_b2(), jnp.asarray(desc_of(d).numpy()))
            out[name, d] = jax.tree.map(np.asarray, {
                "metrics": metrics, "grads": ts.opt_state[0], "state": ts.model_state,
                "params": ts.params})
    return out


def port_step(trees, name, desc, dtype=torch.float32):
    """One step of the port; float64 gives the exact reference."""
    ts = _port_ts(trees, name, dtype)
    batch = batch_b2()
    for key in ("heatmaps", "masks"):
        batch[key] = [torch.from_numpy(x).to(dtype) for x in batch[key]]
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"))
    ts, metrics = sfns.get()(ts, batch, desc)
    grads = {n: p.grad for n, p in ts.model.named_parameters()}
    return ts, {k: float(v) for k, v in metrics.items()}, grads


def adam_of(name, params):
    """``check_step_against_jax``'s ``adam`` for optimizer ``name``."""
    if name != "adam":
        return None
    from litepose_tpu.train import optim as jopt

    return jopt.make_optimizer("adam", jopt.multistep_lr(LR["adam"], [100], 0.1, 10)), params


@pytest.mark.parametrize("desc", ["max", "quarter"])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_step_matches_jax(trees, jax_steps, name, desc):
    want = jax_steps[name, desc]
    ts, metrics, grads = port_step(trees, name, desc_of(desc))
    assert ts.step == 1 and ts.scheduler.last_epoch == 1
    exact = port_step(trees, name, desc_of(desc), torch.float64)[2]
    table = convert.super_resnet_entries(ts.model)
    g_tree = check_step_against_jax(want, ts, metrics, grads, exact, table,
                                    convert.super_resnet_to_jax, adam_of(name, trees[0]))
    if desc != "quarter":
        return
    # an inactive channel's weights and BN affine get exactly no gradient
    g = convert.named_from_tree(g_tree, table)
    w = convert.named_from_tree(want["grads"], table)
    for prefix, n in bn_widths(desc_of(desc)).items():
        conv = {"first.2": "first.1"}.get(prefix, prefix.rsplit(".", 1)[0] + ".0")
        for key, sl in ((f"{prefix}.weight", np.s_[n:]), (f"{prefix}.bias", np.s_[n:]),
                        (f"{conv}.weight", np.s_[n:])):
            assert not g[key][sl].any() and not w[key][sl].any(), key


@pytest.mark.parametrize("size", [256, 320, 384, 448, 512])
def test_outputs_match_the_resized_targets(size):
    """At every elastic size the outputs are size/4 and size/2, the sizes
    ``StepFns`` resizes the targets to (shapes on the meta device)."""
    model = SuperLitePoseResNet(SPEC, FILTERS, compute_dtype=torch.float32).to("meta").train()
    with torch.no_grad():
        outs = model(torch.empty(2, 3, size, size, device="meta"),
                     desc_of("quarter").to("meta"))
    assert [tuple(o.shape) for o in outs] == [(2, 28, size // 4, size // 4),
                                              (2, 14, size // 2, size // 2)]
