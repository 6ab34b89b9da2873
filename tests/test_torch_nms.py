"""K5: the port's suppressed-map NMS against the JAX package.

On the CPU ``nms_suppress`` runs its plain twin ``nms_suppress_ref``; it must
equal the Pallas kernel ``heatmap_nms_pallas`` (TPU interpret mode) bit for
bit, in fp32 and in bf16 (a bf16 map stays bf16), on random, tied,
negative, signed-zero and non-square planes and on planes smaller than the
window, at windows 3, 5 and 7.  Two faults of the JAX package are pinned,
not copied: the TPU kernel pads with -3e38 where the XLA ``heatmap_nms``
and the port pad with -inf, and the XLA path writes -0.0 (``det * 0``) for
a suppressed negative cell where the TPU kernel and the port write +0.0.
The CUDA kernel ``csrc/heatmap_nms.cu`` is held against the twin on the
card (marked ``cuda``, skipped without one), NaN included.

The machine with the card has no jax: only the ``jk5`` fixture imports the
JAX package, so ``pytest --noconftest -m cuda`` runs this file there."""

import numpy as np
import pytest
import torch

from litepose_tpu_torch.ops.nms import heatmap_nms, nms_suppress, nms_suppress_ref

CASES = ["random", "ties", "negative", "signed_zeros", "non_square", "small"]
KERNELS = [3, 5, 7]


@pytest.fixture(scope="module")
def jk5():
    """(jax.numpy, JAX's K5 in TPU interpret mode, JAX's XLA heatmap_nms)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from litepose_tpu.ops.nms import heatmap_nms as xla_nms
    from litepose_tpu.ops.pallas_nms import heatmap_nms_pallas

    def k5(det, kernel):
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(heatmap_nms_pallas(det, kernel))

    return jnp, k5, xla_nms


def _planes(case: str, kernel: int) -> np.ndarray:
    """(N, H, W) fp32 planes for one named case."""
    rng = np.random.default_rng(CASES.index(case) * 10 + kernel)
    if case == "random":
        return rng.standard_normal((3, 24, 32)).astype(np.float32)
    if case == "ties":  # equal maxima within one window, a plateau, an empty plane
        det = (0.5 * rng.random((3, 20, 18))).astype(np.float32)
        det[0, 4, 4] = det[0, 4, 6] = det[0, 6, 5] = 0.9
        det[1, 8:14, 2:9] = 0.75
        det[2] = 0.0
        return det
    if case == "negative":  # kept negative maxima, suppressed cells +0
        return (-np.abs(rng.standard_normal((2, 12, 20)))).astype(np.float32)
    if case == "signed_zeros":  # -0.0 and +0.0 maxima are equal: both kept as they are
        det = -np.abs(rng.standard_normal((2, 16, 24))).astype(np.float32)
        det[0, 2:9, 3:20:4] = -0.0
        det[0, 5, 1] = 0.0
        det[1] = np.where(rng.random((16, 24)) < 0.5, -0.0, 0.0).astype(np.float32)
        return det
    if case == "non_square":
        return rng.uniform(0, 1, (3, 7, 40)).astype(np.float32)
    if case == "small":  # H and W below the window (the TPU kernel needs them >= r)
        r = kernel // 2
        return rng.standard_normal((4, max(r, 1), kernel - 1)).astype(np.float32)
    raise KeyError(case)


def _bits(a) -> np.ndarray:
    """An fp32 or bf16 array's bits, so that -0.0 differs from +0.0."""
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int16)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("case", CASES)
def test_twin_matches_pallas_kernel(jk5, case, kernel, dtype):
    jnp, k5, _ = jk5
    det = jnp.asarray(_planes(case, kernel)).astype(dtype)
    want = k5(det, kernel)
    got = nms_suppress(torch.from_numpy(np.array(det.astype(jnp.float32)))
                       .to(getattr(torch, dtype)), kernel)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def test_twin_matches_pallas_kernel_with_nan(jk5):
    """Single NaNs, a NaN at a border and a NaN plane: the window max
    carries the NaN, so the NaN and every cell within r of it become +0."""
    jnp, k5, _ = jk5
    det = np.random.default_rng(9).standard_normal((3, 16, 20)).astype(np.float32)
    det[0, 5, 5] = det[0, 12, 15] = np.nan
    det[1, 0, 7] = det[1, 9, 19] = np.nan
    det[2] = np.nan
    for kernel in KERNELS:
        got = nms_suppress(torch.from_numpy(det), kernel)
        np.testing.assert_array_equal(_torch_bits(got), _bits(k5(jnp.asarray(det), kernel)))
        assert not torch.isnan(got).any()
        r = kernel // 2
        assert (got[0, 5 - r:6 + r, 5 - r:6 + r] == 0).all()


def test_border_padding_differs_from_the_tpu_kernel(jk5):
    """JAX's K5 pads with -3e38 (pallas_nms.py:24): on a plane of -inf with
    one peak it zeroes the border cells that the XLA ``heatmap_nms`` keeps
    at -inf, and on a plane of -3.2e38 it zeroes the border cells that XLA
    keeps.  The port pads with -inf, as XLA and torch's max_pool2d do."""
    jnp, k5, xla_nms = jk5
    det = np.full((2, 12, 14), -np.inf, np.float32)
    det[0, 6, 7] = 1.0
    det[1] = -3.2e38
    got = nms_suppress(torch.from_numpy(det), 5).numpy()
    border = np.ones((12, 14), bool)
    border[2:-2, 2:-2] = False
    # (XLA's -inf * 0 is NaN at the suppressed -inf cells around the peak)
    xla = np.asarray(xla_nms(jnp.asarray(det), 5, 2))
    np.testing.assert_array_equal(_bits(got)[:, border], _bits(xla)[:, border])
    tpu = k5(jnp.asarray(det), 5)
    differ = _bits(got) != _bits(tpu)
    assert differ.any(axis=0)[border].all()  # every border cell, in one plane or the other
    assert not differ[:, ~border].any()
    assert (tpu[:, border] == 0).all()
    assert (got[0][border] == -np.inf).all() and (got[1][border] == np.float32(-3.2e38)).all()


def test_negative_zero_of_the_xla_path(jk5):
    """The JAX CPU path suppresses with ``det * (max == det)``, which gives
    -0.0 for a suppressed negative cell; JAX's K5 and the port give +0.0
    (``lax.top_k`` then orders the two paths' zeros differently)."""
    jnp, k5, xla_nms = jk5
    det = _planes("negative", 5)
    got = _torch_bits(nms_suppress(torch.from_numpy(det), 5))
    xla = _bits(xla_nms(jnp.asarray(det), 5, 2))
    tpu = _bits(k5(jnp.asarray(det), 5))
    np.testing.assert_array_equal(got, tpu)
    neg_zero = np.float32(-0.0).view(np.int32)
    assert (xla == neg_zero).sum() > 0 and not (got == neg_zero).any()
    np.testing.assert_array_equal(np.where(xla == neg_zero, 0, xla), got)


def test_twin_is_k1s_nms_in_the_input_dtype():
    det = torch.from_numpy(_planes("random", 5)).to(torch.bfloat16)
    got = nms_suppress_ref(det, 5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float().view(torch.int32), heatmap_nms(det, 5).view(torch.int32))


def test_wrapper_shapes_and_rejects_bad_input():
    det = torch.from_numpy(_planes("random", 3)).reshape(1, 3, 24, 32)
    before = nms_suppress.launches
    got = nms_suppress(det, 3)
    assert nms_suppress.launches == before  # the CPU twin launches nothing
    assert got.shape == det.shape
    assert torch.equal(got[0], nms_suppress_ref(det[0], 3))
    with pytest.raises(ValueError):
        nms_suppress(torch.zeros(16), 5)
    with pytest.raises(TypeError):
        nms_suppress(torch.zeros(2, 8, 8, dtype=torch.float16), 5)
    with pytest.raises(ValueError):
        nms_suppress(torch.zeros(2, 8, 8), 4)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    return torch.device("cuda")


def _assert_kernel_is_twin(det: torch.Tensor, kernel: int, device) -> None:
    want = nms_suppress_ref(det, kernel)
    before = nms_suppress.launches
    got = nms_suppress(det.to(device), kernel)
    torch.cuda.synchronize()
    assert nms_suppress.launches == before + 1
    assert got.dtype == det.dtype and got.shape == det.shape
    assert np.array_equal(_torch_bits(got.cpu()), _torch_bits(want))


def _nan_inf_planes() -> torch.Tensor:
    det = np.random.default_rng(11).standard_normal((4, 20, 36)).astype(np.float32)
    det[0, 5, 5] = det[0, 14, 30] = np.nan
    det[0, 0, 0] = det[0, 19, 35] = np.nan  # corners
    det[1, 3, 3] = np.inf
    det[1, 10, :] = -np.inf
    det[1, 15, 20] = det[1, 15, 22] = np.inf  # tied +inf maxima
    det[2] = np.nan
    det[3] = np.where(np.random.default_rng(12).random((20, 36)) < 0.5, -0.0, 0.0)
    return torch.from_numpy(det)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES + ["nan_inf"])
def test_kernel_matches_twin_on_card(cuda, case, dtype):
    for kernel in KERNELS:
        det = _nan_inf_planes() if case == "nan_inf" else torch.from_numpy(_planes(case, kernel))
        _assert_kernel_is_twin(det.to(dtype), kernel, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 224, 224), (1, 448, 448), (2, 512, 704), (1, 45, 103),
                                   (3, 1, 1), (2, 1, 300), (2, 300, 1), (1, 33, 129)])
@pytest.mark.parametrize("kernel", [1, 3, 5, 7, 9, 15])
def test_kernel_on_card_shapes(cuda, shape, kernel):
    """Serving, eval and trap planes, planes of one row or one column, a
    width no 16-byte vector divides (the scalar loads) and one past a tile
    edge, each window from 1 to 15: fp32 and bf16, with planted ties."""
    rng = np.random.default_rng(kernel)
    det = (0.3 * rng.random(shape)).astype(np.float32)
    det[0, ::5, min(11, shape[2] - 1)] = 0.9
    det[-1, : shape[1] // 2] = -0.0
    for dtype in (torch.float32, torch.bfloat16):
        _assert_kernel_is_twin(torch.from_numpy(det).to(dtype), kernel, cuda)


@pytest.mark.cuda
def test_kernel_unaligned_input_on_card(cuda):
    """A contiguous view that starts off a 16-byte boundary takes the scalar
    loads; a batch of (B, K, H, W) maps goes through as B * K planes."""
    det = torch.from_numpy(_planes("random", 5)).to(cuda)
    flat = torch.cat([torch.zeros(1, device=cuda), det.flatten()])[1:].view(det.shape)
    assert flat.data_ptr() % 16 != 0
    assert torch.equal(nms_suppress(flat, 5).cpu(), nms_suppress_ref(det.cpu(), 5))
    maps = det.reshape(1, 3, 24, 32)
    assert torch.equal(nms_suppress(maps, 5).cpu(), nms_suppress_ref(maps.cpu(), 5))


@pytest.mark.cuda
def test_kernel_limits_on_card(cuda):
    with pytest.raises(ValueError, match="windows up to 15"):
        nms_suppress(torch.zeros(1, 8, 8, device=cuda), 17)
    assert nms_suppress(torch.zeros(0, 8, 8, device=cuda), 5).shape == (0, 8, 8)
