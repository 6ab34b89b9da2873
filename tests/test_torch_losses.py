"""The port's training losses against ``litepose_tpu.core.losses``.

The same seeded numpy inputs go to both: NCHW to the port, NHWC to JAX.
Values and gradients (``torch.autograd`` against ``jax.grad``) agree within
atol 1e-6 / rtol 1e-5: both sides compute in float32 and differ only in
the order of their reductions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepose_tpu.core import losses as jl

from litepose_tpu_torch.core import losses as tl

TOL = dict(atol=1e-6, rtol=1e-5)
B, K, P, R = 3, 4, 5, 8


def _joints(rng, res):
    """(B, P, K, 2) int32 indices: a person with no visible joint, one with
    one, one with all, two on the same pixels (duplicated indices), and in
    image 2 a single person (no push pairs)."""
    j = np.zeros((B, P, K, 2), np.int32)
    for b in range(B):
        for p in range(P if b < 2 else 1):
            n_vis = [0, 1, K, K, 2][p]
            for k in range(n_vis):
                j[b, p, k] = (k * res * res + int(rng.integers(0, res * res)), 1)
        if b < 2:
            j[b, 3] = j[b, 2]  # a duplicate of an all-visible person
    return j


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    out0 = rng.normal(0, 1, (B, 2 * K, R, R)).astype(np.float32)
    out1 = rng.normal(0, 1, (B, K, 2 * R, 2 * R)).astype(np.float32)
    hms = [rng.uniform(0, 1, (B, K, r, r)).astype(np.float32) for r in (R, 2 * R)]
    masks = [(rng.uniform(0, 1, (B, r, r)) > 0.2).astype(np.float32) for r in (R, 2 * R)]
    joints = [_joints(rng, R), _joints(rng, 2 * R)]
    return [out0, out1], hms, masks, joints


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_heatmap_loss_value_and_grad():
    outs, hms, masks, _ = _inputs()
    pred = outs[1]

    def jf(p):
        return jnp.sum(jl.heatmap_loss(p, jnp.asarray(hms[1]), jnp.asarray(masks[1]))
                       * jnp.arange(1.0, B + 1))

    want, want_g = jax.value_and_grad(jf)(_nhwc(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = (tl.heatmap_loss(p, torch.from_numpy(hms[1]), torch.from_numpy(masks[1]))
           * torch.arange(1.0, B + 1)).sum()
    got.backward()
    _close(got, want)
    _close(p.grad, np.transpose(np.asarray(want_g), (0, 3, 1, 2)))


@pytest.mark.parametrize("loss_type", ["exp", "max"])
def test_ae_loss_value_and_grad(loss_type):
    outs, _, _, joints = _inputs(1)
    tags = outs[0][:, K:]
    j = joints[0]

    def jf(t):
        push, pull = jl.ae_loss(t, jnp.asarray(j), loss_type)
        return 0.7 * push + 1.3 * pull, (push, pull)

    (_, (want_push, want_pull)), want_g = jax.value_and_grad(jf, has_aux=True)(_nhwc(tags))
    t = torch.from_numpy(tags).requires_grad_()
    push, pull = tl.ae_loss(t, torch.from_numpy(j), loss_type)
    (0.7 * push + 1.3 * pull).backward()
    _close(push, want_push)
    _close(pull, want_pull)
    assert float(push.detach()) != 0.0 and float(pull.detach()) != 0.0
    _close(t.grad, np.transpose(np.asarray(want_g), (0, 3, 1, 2)))


def test_ae_loss_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown AE loss type"):
        tl.ae_loss(torch.zeros(1, K, R, R), torch.zeros(1, 2, K, 2, dtype=torch.int32), "l2")


@pytest.mark.parametrize("ae_type", ["exp", "max"])
def test_multi_loss_metrics_and_grads(ae_type):
    outs, hms, masks, joints = _inputs(2)
    jcfg = jl.LossConfig(num_joints=K, ae_type=ae_type)
    tcfg = tl.LossConfig(num_joints=K, ae_type=ae_type)

    def jf(o0, o1):
        return jl.multi_loss([o0, o1], [jnp.asarray(h) for h in hms],
                             [jnp.asarray(m) for m in masks], [jnp.asarray(x) for x in joints], jcfg)

    (_, want_m), want_g = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        _nhwc(outs[0]), _nhwc(outs[1]))
    ts = [torch.from_numpy(o).requires_grad_() for o in outs]
    total, got_m = tl.multi_loss(ts, [torch.from_numpy(h) for h in hms],
                                 [torch.from_numpy(m) for m in masks],
                                 [torch.from_numpy(x) for x in joints], tcfg)
    total.backward()
    assert sorted(got_m) == sorted(want_m) == sorted(
        ["stage0_heatmap", "stage0_push", "stage0_pull", "stage1_heatmap", "total"])
    for k in want_m:
        _close(got_m[k], want_m[k])
    for t, g in zip(ts, want_g):
        _close(t.grad, np.transpose(np.asarray(g), (0, 3, 1, 2)))


def test_distill_loss_value_and_grad():
    outs, hms, masks, _ = _inputs(3)
    cfg_j, cfg_t = jl.LossConfig(num_joints=K), tl.LossConfig(num_joints=K)
    teacher = [h[::-1].copy() for h in hms]

    def jf(o0, o1):
        return jl.distill_loss([o0, o1], [jnp.asarray(h) for h in teacher],
                               [jnp.asarray(m) for m in masks], cfg_j)

    want, want_g = jax.value_and_grad(jf, argnums=(0, 1))(_nhwc(outs[0]), _nhwc(outs[1]))
    ts = [torch.from_numpy(o).requires_grad_() for o in outs]
    th = [torch.from_numpy(h).requires_grad_() for h in teacher]
    got = tl.distill_loss(ts, th, [torch.from_numpy(m) for m in masks], cfg_t)
    got.backward()
    _close(got, want)
    for t, g in zip(ts, want_g):
        _close(t.grad, np.transpose(np.asarray(g), (0, 3, 1, 2)))
    assert all(h.grad is None for h in th)  # the teacher's maps are detached
