"""The port's train step against ``litepose_tpu.train.trainer.StepFns``.

Tiny arch (``fixed_sample(reso=64, ratio=0.25)``, two blocks a stage),
batch 4, the batch of tests/test_train.py.  fp32 on both sides
(``Policy.exact()`` in JAX): the two differ in summation order only, so
one step agrees to rtol 1e-5 on the loss and its metrics, atol 2e-4 on the
new BN statistics and atol 1e-5 on the parameters after an SGD step; each
gradient tensor is within 1e-4 relative of the port's own float64 step,
and of JAX's beyond JAX's distance from that step (see
``_check_against_jax``).  (Adam's first step is about lr * sign(g), so a
gradient near zero flips a whole step; Adam is held through the gradients
here and through tests/test_torch_optim.py.)

The JAX steps run under the JAX ``StepFns`` with an optax chain whose
first link keeps the gradients in its state, so one compiled step yields
loss, metrics, gradients, BN statistics and parameters.  Three such steps
are compiled, once per module: native size, elastic size 32, and
distillation.

The ``cuda``-marked test holds the step on the card against the CPU; the
machine with the card has no jax, so only fixtures import it."""

import dataclasses

import numpy as np
import pytest
import torch

from litepose_tpu.arch.manager import ArchManager
from test_torch_arch import port_arch

from litepose_tpu_torch.core.losses import LossConfig
from litepose_tpu_torch.models.convert import (entries, jax_from_state_dict, litepose_from_jax,
                                               tree_from_named)
from litepose_tpu_torch.models.litepose import ModelSpec, init_litepose
from litepose_tpu_torch.train import optim
from litepose_tpu_torch.train.checkpoint import init_train_state
from litepose_tpu_torch.train.trainer import StepFns, remap_joint_indices, train_epoch

IMG, B = 64, 4
OUT = [IMG // 4, IMG // 2]
LR, WD = 0.1, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tier-1 run shares the host's cores among six workers; torch's
    default of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(img=IMG, batch=B):
    """The batch of tests/test_train.py:_tiny_setup."""
    rng = np.random.default_rng(0)
    data = {
        "images": rng.integers(0, 255, (batch, img, img, 3)).astype(np.uint8),
        "heatmaps": [rng.random((batch, 14, img // 4, img // 4)).astype(np.float32) * 0.5,
                     rng.random((batch, 14, img // 2, img // 2)).astype(np.float32) * 0.5],
        "masks": [np.ones((batch, img // 4, img // 4), np.float32),
                  np.ones((batch, img // 2, img // 2), np.float32)],
        "joints": [np.zeros((batch, 30, 14, 2), np.int32), np.zeros((batch, 30, 14, 2), np.int32)],
    }
    for b in range(batch):
        data["joints"][0][b, 0, 0] = (5 * (img // 4) + 5, 1)
        data["joints"][0][b, 0, 1] = ((img // 4) ** 2 + 3 * (img // 4) + 8, 1)
    return data


def _arch():
    """The tiny arch with every stage cut to its first two blocks.  At its
    full 34 blocks, fp32 rounding in the backward through the train-mode
    BNs leaves each side's gradients 2e-2 from a float64 step, so no two
    fp32 implementations can agree at 1e-4; at two blocks each side is
    within 1e-5 of float64."""
    arch = ArchManager().fixed_sample(reso=IMG, ratio=0.25)
    return dataclasses.replace(arch, backbone_setting=tuple(
        dataclasses.replace(s, num_blocks=2, block_setting=s.block_setting[:2])
        for s in arch.backbone_setting))


def _port_arch():
    """``_arch()`` as the port's ``ArchConfig``."""
    return port_arch(_arch())


@pytest.fixture(scope="module")
def jax_weights():
    """(params, state) of the JAX init with BN statistics off identity,
    and a teacher's, as numpy trees."""
    import jax

    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import init_litepose as jinit

    def perturbed(seed):
        params, state = jinit(jax.random.PRNGKey(seed), JSpec(), _arch())
        rng = np.random.default_rng(seed + 10)

        def perturb(path, x):
            x = np.asarray(x)
            if "'var'" in jax.tree_util.keystr(path):
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            if x.ndim == 1:  # BN biases far from 0: no BN scale is near scale-invariant
                sd = 0.5 if "'bias'" in jax.tree_util.keystr(path) else 0.2
                return (x + rng.normal(0, sd, x.shape)).astype(np.float32)
            return x.copy()

        return (jax.tree_util.tree_map_with_path(perturb, params),
                jax.tree_util.tree_map_with_path(perturb, state))

    return perturbed(0), perturbed(1)


@pytest.fixture(scope="module")
def jax_steps(jax_weights):
    """The JAX step's results for each case: loss, metrics, grads, new BN
    state and params after one SGD step, as numpy."""
    import jax
    import jax.numpy as jnp
    import optax

    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import apply_litepose
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns

    arch, spec = _arch(), JSpec()
    (params, state), (t_params, t_state) = jax_weights

    def keep_grads():
        return optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, spec, arch, train=True, policy=Policy.exact())

    def teacher_fn(x):
        return apply_litepose(t_params, t_state, x, spec, arch, policy=Policy.exact())[0]

    tx = optax.chain(keep_grads(), jopt.make_optimizer(
        "sgd", jopt.multistep_lr(LR, [100], 0.1, 10), weight_decay=WD))
    out = {}
    for case, img_size, teacher in (("plain", None, None), ("elastic32", 32, None),
                                    ("distill", None, teacher_fn)):
        sfns = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=IMG,
                        base_output_sizes=OUT, teacher_fn=teacher, teacher_size=96)
        ts = jinit_ts(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                      tx.init(params))
        ts, metrics = sfns.get(img_size)(ts, _batch())
        out[case] = jax.tree.map(np.asarray, {
            "metrics": metrics, "grads": ts.opt_state[0], "state": ts.model_state,
            "params": ts.params})
    return out


def _port_model(params, state, compute_dtype=torch.float32):
    return litepose_from_jax(params, state, ModelSpec(), _port_arch(),
                             compute_dtype=compute_dtype).train()


def _port_step(params, state, img_size=None, teacher=None, device="cpu", remat=False,
               batch=None, dtype=torch.float32):
    """One SGD step of the port; dtype float64 gives the exact reference."""
    model = _port_model(params, state).to(device, dtype)
    model.compute_dtype = model.out_dtype = dtype
    if teacher is not None and dtype != torch.float32:
        teacher = litepose_from_jax(*jax_from_state_dict(teacher.state_dict(), ModelSpec(), _port_arch()),
                                    ModelSpec(), _port_arch(), compute_dtype=dtype,
                                    out_dtype=dtype).to(dtype)
    opt, sched = optim.make_optimizer("sgd", model.parameters(),
                                      optim.multistep_lr(LR, [100], 0.1, 10), weight_decay=WD)
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device(device),
                   teacher_fn=teacher, teacher_size=96, remat=remat)
    batch = dict(batch if batch is not None else _batch())
    for key in ("heatmaps", "masks"):
        batch[key] = [torch.from_numpy(np.asarray(x)).to(dtype) for x in batch[key]]
    ts, metrics = sfns.get(img_size)(init_train_state(model, opt, sched), batch)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return ts, {k: float(v) for k, v in metrics.items()}, grads


def _leaves(tree):
    import jax

    return jax.tree_util.tree_leaves_with_path(tree)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_against_jax(want, ts, metrics, grads, exact_grads):
    """exact_grads: the same step of the port in float64.  Each gradient
    tensor is within 1e-4 relative of the float64 one, and within 1e-4 of
    JAX's beyond JAX's own distance from float64: the BN scales whose
    effect the next BN nearly normalizes away get gradients that are small
    residues, and there JAX's fp32 step alone lies up to about 1e-4 from the
    exact value (the port's, 1e-5)."""
    import jax

    assert sorted(metrics) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
    table = entries(ModelSpec(), _port_arch())
    g_tree = tree_from_named(grads, table)
    x_tree = tree_from_named({n: g.double().numpy() for n, g in exact_grads.items()}, table)
    for (path, g), (_, w), (_, x) in zip(_leaves(g_tree), _leaves(want["grads"]), _leaves(x_tree)):
        name = jax.tree_util.keystr(path)
        assert _rel(g, x) <= 1e-4, (name, _rel(g, x))
        assert _rel(g, w) <= 1e-4 + _rel(w, x), (name, _rel(g, w), _rel(w, x))
    p_tree, s_tree = jax_from_state_dict(ts.model.state_dict(), ModelSpec(), _port_arch())
    assert len(_leaves(s_tree)) == len(_leaves(want["state"]))
    for (path, s), (_, w) in zip(_leaves(s_tree), _leaves(want["state"])):
        np.testing.assert_allclose(s, w, atol=2e-4, rtol=0, err_msg=jax.tree_util.keystr(path))
    for (path, p), (_, w) in zip(_leaves(p_tree), _leaves(want["params"])):
        np.testing.assert_allclose(p, w, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case,img_size", [("plain", None), ("elastic32", 32)])
def test_step_matches_jax(jax_weights, jax_steps, case, img_size):
    (params, state), _ = jax_weights
    ts, metrics, grads = _port_step(params, state, img_size=img_size)
    assert ts.step == 1
    exact = _port_step(params, state, img_size=img_size, dtype=torch.float64)[2]
    _check_against_jax(jax_steps[case], ts, metrics, grads, exact)


def test_distillation_step_matches_jax(jax_weights, jax_steps):
    (params, state), (t_params, t_state) = jax_weights
    teacher = litepose_from_jax(t_params, t_state, ModelSpec(), _port_arch(),
                                compute_dtype=torch.float32)
    ts, metrics, grads = _port_step(params, state, teacher=teacher)
    assert "distill" in metrics and metrics["distill"] > 0
    exact = _port_step(params, state, teacher=teacher, dtype=torch.float64)[2]
    _check_against_jax(jax_steps["distill"], ts, metrics, grads, exact)
    assert not teacher.training and all(p.grad is None for p in teacher.parameters())


def test_remap_joint_indices_matches_jax():
    import jax.numpy as jnp

    from litepose_tpu.train.trainer import remap_joint_indices as jremap

    rng = np.random.default_rng(3)
    joints = np.stack([rng.integers(0, 14 * 32 * 32, (2, 30, 14)),
                       rng.integers(0, 2, (2, 30, 14))], -1).astype(np.int32)
    for src, dst in ((32, 16), (32, 8), (32, 40)):
        want = np.asarray(jremap(jnp.asarray(joints), src, dst))
        got = remap_joint_indices(torch.from_numpy(joints), src, dst)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    one = np.zeros((1, 1, 2, 2), np.int32)
    one[0, 0, 0] = (1 * 16 * 16 + 10 * 16 + 6, 1)  # joint 1 at (y=10, x=6) in res 16
    assert remap_joint_indices(torch.from_numpy(one), 16, 8)[0, 0, 0].tolist() == [64 + 40 + 3, 1]


def test_remat_step_equals_plain(jax_weights):
    """Recomputing the forward in the backward changes nothing: the loss,
    gradients, parameters and BN running statistics (``num_batches_tracked``
    included) equal the plain step's."""
    (params, state), _ = jax_weights
    ts_a, m_a, g_a = _port_step(params, state)
    ts_r, m_r, g_r = _port_step(params, state, remat=True)
    assert m_a == m_r
    for n in g_a:
        torch.testing.assert_close(g_r[n], g_a[n], rtol=0, atol=1e-7)
    sd_a, sd_r = ts_a.model.state_dict(), ts_r.model.state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_r[k], sd_a[k], rtol=0, atol=1e-7, msg=k)
    assert int(sd_r["first.3.num_batches_tracked"]) == 1


def test_loss_falls_over_four_steps():
    torch.manual_seed(0)
    model = init_litepose(ModelSpec(), _port_arch(), torch.Generator().manual_seed(0))
    opt, sched = optim.make_optimizer("adam", model.parameters(),
                                      optim.multistep_lr(1e-3, [100], 0.1, 10))
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"))
    ts = init_train_state(model, opt, sched)
    losses = []
    for _ in range(4):
        ts, metrics = sfns.get()(ts, _batch())
        losses.append(float(metrics["total"]))
    assert losses[-1] < losses[0]
    assert ts.step == 4 and sched.last_epoch == 4


def test_init_bounds_match_jax():
    """The port's seeded init draws each kernel within the JAX bound
    sqrt(3 / fan_in) and fills it (both packages' largest draws come within
    15% of it), with BNs at their identities."""
    import jax

    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import init_litepose as jinit
    from litepose_tpu_torch.models.convert import state_dict_from_jax

    jsd = state_dict_from_jax(*jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), JSpec(),
                                                                _arch())), ModelSpec(), _port_arch())
    model = init_litepose(ModelSpec(), _port_arch(), torch.Generator().manual_seed(0))
    again = init_litepose(ModelSpec(), _port_arch(), torch.Generator().manual_seed(0))
    assert model.training
    for name, t in model.state_dict().items():
        j = jsd[name]
        assert t.shape == j.shape, name
        torch.testing.assert_close(again.state_dict()[name], t, rtol=0, atol=0)
        if name.endswith("num_batches_tracked"):
            continue
        if t.dim() == 1:
            torch.testing.assert_close(t, j, rtol=0, atol=0, msg=name)  # BN identities
            continue
        m = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(m, torch.nn.ConvTranspose2d):
            fan_in = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
        else:
            fan_in = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        bound = np.sqrt(3.0 / fan_in)
        for w in (t, j):
            assert float(w.abs().max()) <= bound * (1 + 1e-6), name
            assert float(w.abs().max()) >= 0.85 * bound, name


def test_eval_after_training_serves_the_trained_weights(jax_weights):
    """The stale-fold trap: a model folded for eval, trained, then switched
    back to eval serves what a model rebuilt from its saved weights serves."""
    (params, state), _ = jax_weights
    model = litepose_from_jax(params, state, ModelSpec(), _port_arch(), compute_dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 3, IMG, IMG)).astype(np.float32))
    with torch.no_grad():
        before = model(x)[1]
    opt, sched = optim.make_optimizer("sgd", model.parameters(),
                                      optim.multistep_lr(LR, [100], 0.1, 10))
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"))
    sfns.get()(init_train_state(model, opt, sched), _batch())
    assert model.training and not hasattr(model.first[2], "folded_w")
    model.eval()
    p_tree, s_tree = jax_from_state_dict(model.state_dict(), ModelSpec(), _port_arch())
    rebuilt = litepose_from_jax(p_tree, s_tree, ModelSpec(), _port_arch(), compute_dtype=torch.float32)
    with torch.no_grad():
        after, want = model(x)[1], rebuilt(x)[1]
    assert torch.equal(after, want)
    assert not torch.equal(after, before)


def test_train_epoch_draws_elastic_sizes_like_jax(jax_weights):
    (params, state), _ = jax_weights
    model = _port_model(params, state)
    opt, sched = optim.make_optimizer("sgd", model.parameters(),
                                      optim.multistep_lr(1e-3, [100], 0.1, 10))
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"))
    drawn = []
    get = sfns.get
    sfns.get = lambda size=None: drawn.append(size) or get(size)
    ts, avg = train_epoch(sfns, init_train_state(model, opt, sched), [_batch()] * 3, epoch=2,
                          print_freq=1, elastic_sizes=[32, 64], seed=5)
    rng = np.random.default_rng((5, 2))
    assert drawn == [int(rng.choice(np.asarray([32, 64]))) for _ in range(3)]
    assert ts.step == 3 and np.isfinite(avg["total"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card-vs-CPU step runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_on_card_matches_cpu(cuda):
    """fp32 with TF32 off: one SGD step on the card equals the CPU's within
    rtol 1e-4 on the loss and the BN running statistics, and within 1e-3
    relative L2 per gradient tensor beyond the CPU step's own distance from
    a float64 step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_litepose(ModelSpec(), _port_arch(), torch.Generator().manual_seed(0),
                          compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # BN affines off identity, as the JAX-held tests have them
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.add_(torch.randn(m.weight.shape, generator=gen) * 0.2)
                m.bias.add_(torch.randn(m.bias.shape, generator=gen) * 0.5)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for device, dtype in (("cpu", torch.float32), (cuda, torch.float32), ("cpu", torch.float64)):
        m = init_litepose(ModelSpec(), _port_arch(), torch.Generator().manual_seed(1),
                          compute_dtype=dtype, out_dtype=dtype)
        m.load_state_dict(sd)
        m.to(device, dtype)
        opt, sched = optim.make_optimizer("sgd", m.parameters(),
                                          optim.multistep_lr(LR, [100], 0.1, 10))
        batch = _batch()
        for key in ("heatmaps", "masks"):
            batch[key] = [torch.from_numpy(x).to(dtype) for x in batch[key]]
        sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device(device))
        _, metrics = sfns.get()(init_train_state(m, opt, sched), batch)
        results.append((float(metrics["total"]),
                        {n: p.grad.cpu().double() for n, p in m.named_parameters()},
                        {k: v.cpu() for k, v in m.state_dict().items() if "running" in k}))
    (l_cpu, g_cpu, s_cpu), (l_dev, g_dev, s_dev), (_, g_64, _) = results
    assert l_dev == pytest.approx(l_cpu, rel=1e-4)
    for n in g_cpu:
        err = float((g_dev[n] - g_cpu[n]).norm() / g_cpu[n].norm().clamp_min(1e-30))
        cpu_err = float((g_cpu[n] - g_64[n]).norm() / g_64[n].norm().clamp_min(1e-30))
        assert err <= 1e-3 + cpu_err, (n, err, cpu_err)
    for k in s_cpu:
        torch.testing.assert_close(s_dev[k], s_cpu[k], rtol=1e-4, atol=1e-6, msg=k)


def test_make_bench_ckpt_writes_weights_both_packages_load(tmp_path):
    """The entry point at a CPU size (Auto-XS@256, 2 steps of batch 2)."""
    import jax

    from litepose_tpu.train.checkpoint import load_params as jload

    from litepose_tpu_torch.models.litepose import get_arch
    from litepose_tpu_torch.tools import make_bench_ckpt
    from litepose_tpu_torch.train.checkpoint import load_params

    out = str(tmp_path / "bench.msgpack")
    args = make_bench_ckpt.build_parser().parse_args(
        ["--arch", "auto-XS", "--steps", "2", "--batch", "2", "--images", "4",
         "--device", "cpu", "--out", out])
    run = make_bench_ckpt.train(args, log=lambda msg: None)
    assert len(run.cached) == 4 * 2 and len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert run.ts.step == 2 and run.ts.model.compute_dtype == torch.bfloat16
    p_tree, s_tree = jax_from_state_dict(run.ts.model.state_dict(), ModelSpec(), get_arch("auto-XS"))
    params, state = load_params(out)
    j_params, j_state = jload(out, jax.tree.map(np.zeros_like, p_tree),
                              jax.tree.map(np.zeros_like, s_tree))
    for got in ((params, state), jax.tree.map(np.asarray, (j_params, j_state))):
        for (path, a), (_, b) in zip(_leaves(got), _leaves((p_tree, s_tree))):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_make_bench_ckpt_never_falls_back_to_the_cpu(monkeypatch):
    from litepose_tpu_torch.tools import make_bench_ckpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        make_bench_ckpt.main(["--device", "cuda", "--steps", "1"])
