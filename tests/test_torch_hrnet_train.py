"""Training of the HRNet families (``HigherHRNet``, ``EfficientHRNet``)
in the port against the JAX package's ``apply_higher_hrnet`` /
``apply_efficient_hrnet`` with ``train=True`` and its ``StepFns``, on the
CPU.

The narrow specs of tests/test_torch_hrnet.py (``basic``, ``zero_blocks``:
0-block branches, the None slots of the fuse layers and transitions) and
tests/test_torch_efficient_hrnet.py (H-3: the EfficientNet backbone at its
table, SE, TF SAME padding), 64-px images, b2, fp32 (JAX under
``Policy.exact()``), the port's seeded init with every BN's affine and
statistics and the final biases moved off their identities
(``test_torch_hrnet.moved``), reaching JAX through ``models.convert``.

* the train-mode forward and the BN statistics it moves: atol 2e-4, rtol
  1e-3;
* one SGD and one Adam step against JAX's ``StepFns`` at
  tests/test_torch_train.py's tolerances
  (``torch_step_check.check_step_against_jax``): the loss and its metrics
  rtol 1e-5, each gradient within 1e-4 relative, the BN statistics atol
  2e-4, the parameters atol 1e-5 (to optax's update of the port's
  gradients, the metrics beyond JAX's own distance from the
  float64 step: ``test_step_matches_jax``).  One JAX step a model: its
  loss, gradients and BN statistics do not depend on the optimizer, so the
  Adam case holds the port's to the same ones;
* ``remat`` (``TPU.REMAT``) on EfficientHRNet: the plain step's loss,
  gradients, parameters and BN statistics;
* the init's bounds, as JAX's, for both families;
* checkpoints with Adam's and SGD's state crossing both ways, None slots
  included;
* two gloo ranks at b1 each equal to one process at b2 (float64)."""

import numpy as np
import pytest
import torch

from litepose_tpu.models import efficient_hrnet as jeff
from litepose_tpu.models import higher_hrnet as jhr
from litepose_tpu.models.layers import Policy

from litepose_tpu_torch.core.losses import LossConfig
from litepose_tpu_torch.models import convert
from litepose_tpu_torch.models.efficient_hrnet import (EffHRNetSpec, EfficientHRNet,
                                                       init_efficient_hrnet)
from litepose_tpu_torch.models.higher_hrnet import HigherHRNet, init_higher_hrnet
from litepose_tpu_torch.train import optim
from litepose_tpu_torch.train.checkpoint import init_train_state
from litepose_tpu_torch.train.trainer import StepFns
from test_torch_efficient_hrnet import spec_of
from test_torch_hrnet import SPECS, images, jax_spec, moved
from test_torch_super_resnet import LR, WD
from test_torch_train_cli import _batch
from torch_step_check import check_step_against_jax, jax_sgd_step, leaves

IMG, B = 64, 2
OUT = [IMG // 4, IMG // 2]
MODELS = {"basic": SPECS["basic"], "zero_blocks": SPECS["zero_blocks"], "H-3": spec_of("H-3")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_module(name):
    """(the JAX module, its spec) of ``MODELS[name]``."""
    spec = MODELS[name]
    if isinstance(spec, EffHRNetSpec):
        return jeff.apply_efficient_hrnet, jax_spec(spec, jeff, jeff.EffHRNetSpec)
    return jhr.apply_higher_hrnet, jax_spec(spec)


def seeded(name, seed=0):
    spec = MODELS[name]
    init = init_efficient_hrnet if isinstance(spec, EffHRNetSpec) else init_higher_hrnet
    return moved(init(spec, torch.Generator().manual_seed(seed), compute_dtype=torch.float32))


def port_model(trees, name, dtype=torch.float32):
    spec = MODELS[name]
    cls = EfficientHRNet if isinstance(spec, EffHRNetSpec) else HigherHRNet
    model = cls(spec, compute_dtype=dtype, out_dtype=dtype)
    model.load_state_dict(convert.family_state_dict_from_jax(model, *trees))
    return model.to(dtype).train()


_TREES = {}


def trees_of(name):
    """(params, state) numpy trees of the moved seeded model ``name``."""
    if name not in _TREES:
        _TREES[name] = convert.to_jax(seeded(name))
    return _TREES[name]


def nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("name", list(MODELS))
def test_train_forward_matches_jax(name):
    """The train-mode forward (batch statistics) and the running statistics
    it leaves, against ``apply_*(train=True)``."""
    import jax
    import jax.numpy as jnp

    apply_fn, jspec = jax_module(name)
    params, state = trees_of(name)
    x = images(B, IMG, seed=5)
    outs, new_state = jax.jit(lambda p, s, x: apply_fn(p, s, x, jspec, train=True,
                                                       policy=Policy.exact()))(
        params, state, jnp.asarray(x))
    model = port_model((params, state), name)
    with torch.no_grad():
        got = model(nchw(x))
    assert len(got) == len(outs) == 2
    for g, w in zip(got, outs):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-3)
    got_state = convert.to_jax(model)[1]
    assert len(leaves(got_state)) == len(leaves(new_state))
    for (path, g), (_, w) in zip(leaves(got_state), leaves(new_state)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


# -- the train step against JAX's ------------------------------------------------------


_JAX_STEPS = {}


def jax_step(name):
    """JAX's SGD step of ``name`` on the b2 batch (one compile a model)."""
    if name not in _JAX_STEPS:
        apply_fn, jspec = jax_module(name)

        def train_apply(p, s, x):
            return apply_fn(p, s, x, jspec, train=True, policy=Policy.exact())

        _JAX_STEPS[name] = jax_sgd_step(train_apply, *trees_of(name), _batch(IMG, B), IMG, OUT,
                                        LR["sgd"], WD)
    return _JAX_STEPS[name]


def _port_ts(trees, name, opt_name, dtype=torch.float32):
    model = port_model(trees, name, dtype)
    opt, sched = optim.make_optimizer(opt_name, model.parameters(),
                                      optim.multistep_lr(LR[opt_name], [100], 0.1, 10),
                                      weight_decay=WD)
    return init_train_state(model, opt, sched)


def port_step(trees, name, opt_name, dtype=torch.float32, remat=False, batch=None):
    """One step of the port (float64 gives the exact reference): (ts,
    metrics as floats, gradients by parameter name)."""
    ts = _port_ts(trees, name, opt_name, dtype)
    batch = dict(batch if batch is not None else _batch(IMG, B))
    for key in ("heatmaps", "masks"):
        batch[key] = [torch.from_numpy(x).to(dtype) for x in batch[key]]
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"), remat=remat)
    ts, metrics = sfns.get()(ts, batch)
    assert ts.step == 1 and ts.scheduler.last_epoch == 1
    return ts, {k: float(v) for k, v in metrics.items()}, \
        {n: p.grad for n, p in ts.model.named_parameters()}


def optax_of(opt_name, params):
    """(the step's optax optimizer, the parameters before it)."""
    from litepose_tpu.train import optim as jopt

    return jopt.make_optimizer(opt_name, jopt.multistep_lr(LR[opt_name], [100], 0.1, 10),
                               weight_decay=WD), params


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("name", list(MODELS))
def test_step_matches_jax(name, opt_name):
    """One step against JAX's: the parameters held to optax's update of the
    port's gradients and the metrics beyond JAX's own distance from the
    float64 step (``check_step_against_jax``'s ``update`` and
    ``exact_metrics``): the stems' gradients reach 5, where both packages'
    fp32 gradients lie 1e-5 relative from the float64 step's, and the AE
    pull of this batch is 9e-5 to 3e-3, where JAX's fp32 pull lies up to
    1.2e-4 from the float64 one."""
    trees = trees_of(name)
    ts, metrics, grads = port_step(trees, name, opt_name)
    _, exact_metrics, exact = port_step(trees, name, opt_name, torch.float64)
    check_step_against_jax(jax_step(name), ts, metrics, grads, exact,
                           convert.family_entries(ts.model), convert.to_jax,
                           optax_of(opt_name, trees[0]), exact_metrics)


def test_remat_step_equals_plain():
    """Recomputing EfficientHRNet's forward in the backward (its SE, SAME
    pads and the Higher head's concatenated prediction included) changes
    nothing: the loss, gradients, parameters and BN statistics
    (``num_batches_tracked`` included) equal the plain step's."""
    trees = trees_of("H-3")
    ts_a, m_a, g_a = port_step(trees, "H-3", "sgd")
    ts_r, m_r, g_r = port_step(trees, "H-3", "sgd", remat=True)
    assert m_a == m_r
    for n in g_a:
        torch.testing.assert_close(g_r[n], g_a[n], rtol=0, atol=1e-7, msg=n)
    sd_a, sd_r = ts_a.model.state_dict(), ts_r.model.state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_r[k], sd_a[k], rtol=0, atol=1e-7, msg=k)
    assert int(sd_r["features.0.2.num_batches_tracked"]) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_se_mean_takes_at_least_fp32(dtype):
    """The squeeze-excitation's mean is taken in fp32 for bf16 and fp32
    activations, as JAX's ``_mbconv`` takes it, and in float64 for float64
    ones, so that a float64 step (the exact reference of the step tests
    and of ``chip_smoke.py`` phase 18) has no fp32 rounding in it."""
    from litepose_tpu_torch.models.efficient_hrnet import SqueezeExcitation

    gen = torch.Generator().manual_seed(0)
    se = SqueezeExcitation(16, 4)
    with torch.no_grad():
        for p in se.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    y = (torch.randn(2, 16, 9, 7, generator=gen) * 3 + 1).to(dtype)
    acc = torch.promote_types(dtype, torch.float32)
    m = y.to(acc).mean(dim=(2, 3)).to(dtype)
    h = m @ se.se[1].weight.flatten(1).t().to(dtype) + se.se[1].bias.to(dtype)
    h = h * torch.sigmoid(h)
    h = h @ se.se[3].weight.flatten(1).t().to(dtype) + se.se[3].bias.to(dtype)
    want = y * torch.sigmoid(h)[:, :, None, None]
    got = se(y)
    assert got.dtype == dtype
    assert torch.equal(got, want)


# -- the init and the checkpoints -----------------------------------------------------


@pytest.mark.parametrize("name", ["zero_blocks", "H-3"])
def test_init_bounds_match_jax(name):
    """Each conv kernel of the seeded init lies within JAX's bound
    sqrt(3 / fan_in) and fills it, like JAX's init (fan_in k*k*cin/groups,
    k*k*cout for a transposed conv); BNs and conv biases at their
    identities; one seed gives one model."""
    import jax

    spec = MODELS[name]
    if isinstance(spec, EffHRNetSpec):
        jp, js = jeff.init_efficient_hrnet(jax.random.PRNGKey(0), jax_module(name)[1])
        model, again = (init_efficient_hrnet(spec, torch.Generator().manual_seed(0))
                        for _ in range(2))
    else:
        jp, js = jhr.init_higher_hrnet(jax.random.PRNGKey(0), jax_module(name)[1])
        model, again = (init_higher_hrnet(spec, torch.Generator().manual_seed(0))
                        for _ in range(2))
    assert model.training
    jsd = convert.family_state_dict_from_jax(model, *jax.device_get((jp, js)))
    for key, t in model.state_dict().items():
        j = jsd[key]
        assert t.shape == j.shape, key
        assert torch.equal(again.state_dict()[key], t), key
        if key.endswith("num_batches_tracked"):
            continue
        if t.dim() == 1:
            assert torch.equal(t, j), key  # BN identities, zero biases
            continue
        m = model.get_submodule(key.rsplit(".", 1)[0])
        k = m.kernel_size[0] * m.kernel_size[1]
        fan_in = k * m.out_channels if isinstance(m, torch.nn.ConvTranspose2d) \
            else k * m.in_channels // m.groups
        bound = np.sqrt(3.0 / fan_in)
        for w in (t, j):
            assert float(w.abs().max()) <= bound * (1 + 1e-6), key
            assert float(w.abs().max()) >= 0.85 * bound, key


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("name", ["zero_blocks", "H-3"])
def test_checkpoints_cross_packages_with_optimizer_state(name, opt_name, tmp_path):
    """A JAX ``save_checkpoint`` after three optax updates resumes in the
    port with bit-equal weights, moments and counts (the optax trees' None
    slots where a fuse or transition has no layer); the port's checkpoint
    of that state restores in JAX to the same trees, and optax steps with
    it."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import serialization

    from litepose_tpu.train import checkpoint as jck
    from litepose_tpu.train import optim as jopt

    from litepose_tpu_torch.train import checkpoint as tck

    params, state = trees_of(name)
    tx = jopt.make_optimizer(opt_name, jopt.multistep_lr(LR[opt_name], [100], 0.1, 10),
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
    if name == "zero_blocks":  # the None slots reach the optimizer's state
        assert opt_state[1][0].trace["stage3"][0]["fuse"][1][1] is None if opt_name == "sgd" \
            else opt_state[0].mu["stage3"][0]["fuse"][1][1] is None
    jts = jck.init_train_state(jp, jax.tree.map(jnp.asarray, state), opt_state, step=3)
    jck.save_checkpoint(str(tmp_path / "j"), jts._replace(epoch=jts.epoch + 2))

    ts = tck.auto_resume(str(tmp_path / "j"), _port_ts((params, state), name, opt_name))
    assert (ts.step, ts.epoch, ts.scheduler.last_epoch) == (3, 2, 3)
    want_p = jax.tree.map(np.asarray, jp)
    got_p, got_s = convert.to_jax(ts.model)
    for a, b in ((got_p, want_p), (got_s, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
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
    got_o = serialization.to_state_dict(jax.tree.map(np.asarray, restored.opt_state))
    assert jax.tree_util.tree_structure(got_o) == jax.tree_util.tree_structure(want_o)
    for (path, u), (_, v) in zip(leaves(got_o), leaves(want_o)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=str(path))
    for (path, u), (_, v) in zip(leaves(restored.params), leaves(want_p)):
        np.testing.assert_array_equal(np.asarray(u), v, err_msg=str(path))
    update(jax.tree.map(jnp.zeros_like, restored.params), restored.opt_state, restored.params)


# -- a process group ------------------------------------------------------------------


def test_two_rank_step_equals_one_rank(tmp_path):
    """HigherHRNet's SGD step on two gloo ranks, one image each (every BN
    takes both images' statistics: ``layers.bn_train``), against one
    process on both images: loss and metrics rtol 1e-5, BN statistics atol
    2e-4, parameters atol 1e-5; the ranks end bit-equal.  In float64, as
    tests/test_torch_parallel.py holds the super-ResNet: in fp32 this
    batch's AE pull (2.3e-4, the square of a tag difference) moves by more
    than 1e-5 relative with the summation order alone."""
    from test_torch_parallel import port_step as one_step, run_ranks

    trees = trees_of("zero_blocks")
    batch = {k: [np.asarray(x, np.float64) for x in v] if k in ("heatmaps", "masks") else v
             for k, v in _batch(IMG, B).items()}
    ranks = run_ranks(tmp_path, {"kind": "step", "batch": batch, "desc": None,
                                 "model": port_model(trees, "zero_blocks", torch.float64)})
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    model = port_model(trees, "zero_blocks", torch.float64)
    metrics = one_step(model, batch)
    assert sorted(metrics) == sorted(ranks[0]["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k, w in model.state_dict().items():
        g = ranks[0]["state"][k]
        if "num_batches_tracked" in k:
            assert torch.equal(g, w), k
        else:
            torch.testing.assert_close(g, w, atol=2e-4 if "running" in k else 1e-5, rtol=0,
                                       msg=k)
