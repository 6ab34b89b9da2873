"""The port's ``LitePose`` forward against ``apply_litepose``.

fp32 with ``Policy.exact()`` on the JAX side and TF32 off on the port's:
the two differ only in convolution summation order, so the bound is the one
of tests/test_litepose_torch_parity.py (atol 2e-4, rtol 1e-3)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepose_tpu.arch.manager import ArchManager
from litepose_tpu.arch.zoo import get_arch
from litepose_tpu.models.layers import Policy
from litepose_tpu.models.litepose import ModelSpec as JSpec
from litepose_tpu.models.litepose import apply_litepose, init_litepose

from litepose_tpu_torch.models.convert import litepose_from_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.train.checkpoint import load_params
from test_torch_arch import port_arch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_weights(arch, with_skips):
    """JAX init with BN affines and statistics off their identities."""
    params, state = init_litepose(jax.random.PRNGKey(0), JSpec(), arch,
                                  with_skips=with_skips)
    rng = np.random.default_rng(1)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if x.ndim == 1:
            return (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
        return x

    return (jax.tree_util.tree_map_with_path(perturb, params),
            jax.tree_util.tree_map_with_path(perturb, state))


def _case(name):
    """(arch, params, state, with_skips, batch images NHWC)."""
    rng = np.random.default_rng(2)
    if name == "xs_trained":
        arch = get_arch("auto-XS")
        params, state = load_params(os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack"))
        with_skips = True
    else:
        arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
        with_skips = name == "small"
        params, state = _random_weights(arch, with_skips)
    x = rng.standard_normal((2, arch.img_size, arch.img_size, 3)).astype(np.float32)
    return arch, params, state, with_skips, x


def _forward_pair(name, dtype):
    arch, params, state, with_skips, x = _case(name)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    policy = Policy.exact() if dtype == torch.float32 else Policy()
    want, _ = apply_litepose(params, state, jnp.asarray(x), JSpec(), arch,
                             with_skips=with_skips, policy=policy, out_dtype=jdt)
    model = litepose_from_jax(params, state, ModelSpec(), port_arch(arch), with_skips,
                              compute_dtype=dtype, out_dtype=dtype)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(got) == len(want) == 2
    pairs = []
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 3, 1, 2)
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        pairs.append((g.float().numpy(), w))
    return pairs


@pytest.mark.parametrize("name", ["small", "small_no_skips", "xs_trained"])
def test_forward_matches_jax_fp32(name):
    torch.backends.cudnn.allow_tf32 = False
    for got, want in _forward_pair(name, torch.float32):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_forward_matches_jax_bf16():
    """bf16 keeps 8 significant bits (a relative step of 2^-8 = 3.9e-3).
    XLA's CPU backend evaluates each fused elementwise chain in fp32 and
    rounds once; torch rounds after every op.  Across some 40 layers the
    outputs then drift apart by a few bf16 steps: bound the relative RMS
    error by 3e-2 and the largest error by 6e-2 of the output's peak."""
    for got, want in _forward_pair("xs_trained", torch.bfloat16):
        err = got - want
        assert np.linalg.norm(err) <= 3e-2 * np.linalg.norm(want)
        assert np.abs(err).max() <= 6e-2 * np.abs(want).max()


def test_stage_output_shapes():
    arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
    from litepose_tpu_torch.models.litepose import LitePose

    model = LitePose(ModelSpec(), port_arch(arch)).eval()
    with torch.no_grad():
        outs = model(torch.zeros(1, 3, 128, 96))
    assert [tuple(o.shape) for o in outs] == [(1, 28, 32, 24), (1, 14, 64, 48)]
    assert all(o.dtype == torch.float32 for o in outs)


def test_fold_cache_follows_weight_updates():
    """Weights folded once by ``fold_bn_`` give the per-call fold's output
    bit for bit, stay out of the state dict, and follow an in-place weight
    write once folded again."""
    arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
    from litepose_tpu_torch.models.litepose import LitePose

    model = LitePose(ModelSpec(), port_arch(arch), compute_dtype=torch.float32).eval()
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(x)[1]  # folded at every call
        model.fold_bn_()
        assert torch.equal(model(x)[1], a)
        assert not any("folded" in k for k in model.state_dict())
        model.first[3].running_var.mul_(4.0)
        assert torch.equal(model(x)[1], a)  # the folds hold until refolded
        b = model.fold_bn_()(x)[1]
        model.first[3].running_var.div_(4.0)
        c = model.fold_bn_()(x)[1]
    assert not torch.equal(a, b)
    assert torch.equal(a, c)
