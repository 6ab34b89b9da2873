"""K1: the port's fused NMS + exact top-M against the JAX package.

On the CPU ``nms_topk`` runs its plain twin; it must equal the Pallas kernel
``nms_topk_pallas`` (interpret mode) and ``top_k_peaks_batch`` bit for bit,
values and flat indices, tie order included.  The CUDA kernel is held
against the twin on the card (marked ``cuda``, skipped without one).

The machine with the card has no jax: only the ``jref`` fixture imports the
JAX package, so ``pytest --noconftest -m cuda`` runs this file there."""

import numpy as np
import pytest
import torch

from litepose_tpu_torch.ops.nms import heatmap_nms
from litepose_tpu_torch.ops.topk import nms_topk, nms_topk_ref, top_k_peaks_batch


@pytest.fixture(scope="module")
def jref():
    """(jax.numpy, the JAX package's pallas_topk module)."""
    import jax.numpy as jnp
    from litepose_tpu.ops import pallas_topk

    return jnp, pallas_topk


CASES = ["random", "ties", "dominant_row", "few_peaks", "negative", "non_square"]
M = 8


def _planes(case: str) -> np.ndarray:
    """(B, K, H, W) fp32 planes for one named case."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "random":
        return rng.standard_normal((2, 3, 24, 32)).astype(np.float32)
    if case == "ties":  # equal maxima in several rows, and one empty plane
        det = rng.standard_normal((1, 2, 24, 32)).astype(np.float32)
        det[0, 0, 3, 5] = det[0, 0, 12, 3] = det[0, 0, 20, 30] = 4.0
        det[0, 1] = 0.0
        return det
    if case == "dominant_row":  # one row holds more tied peaks than M
        det = (0.1 * rng.standard_normal((1, 1, 20, 40))).astype(np.float32)
        det[0, 0, 9, ::4] = 5.0
        return det
    if case == "few_peaks":  # fewer than M positive peaks: zeros in flat order
        det = np.zeros((1, 2, 16, 16), np.float32)
        det[0, 0, 4, 4] = 0.9
        det[0, 0, 10, 12] = 0.5
        det[0, 1] = -1.0 - rng.uniform(0, 1, (16, 16)).astype(np.float32)
        return det
    if case == "negative":  # kept negative maxima rank below suppressed zeros
        return (-np.abs(rng.standard_normal((1, 2, 12, 20)))).astype(np.float32)
    if case == "non_square":
        return rng.uniform(0, 1, (2, 2, 12, 36)).astype(np.float32)
    raise KeyError(case)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", [3, 5])
def test_twin_matches_pallas_kernel(jref, case, kernel):
    jnp, pallas_topk = jref
    det = _planes(case)
    val, pos = nms_topk(torch.from_numpy(det), M, kernel)
    want_v, want_p = pallas_topk.nms_topk_pallas(jnp.asarray(det), M, kernel,
                                                 _interp=True)
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("case", ["random", "ties"])
def test_twin_matches_pallas_kernel_bf16(jref, case):
    """bf16 planes: compared after the upcast to fp32, as the kernel does."""
    jnp, pallas_topk = jref
    det16 = jnp.asarray(_planes(case)).astype(jnp.bfloat16)
    det = torch.from_numpy(np.array(det16.astype(jnp.float32))).to(torch.bfloat16)
    val, pos = nms_topk(det, M, 5)
    want_v, want_p = pallas_topk.nms_topk_pallas(det16, M, 5, _interp=True)
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("T", [1, 2])
def test_top_k_peaks_batch_matches_jax(jref, T):
    """Peaks with the tag gather and x/y decode, "thw" tag layout."""
    jnp, pallas_topk = jref
    rng = np.random.default_rng(T)
    det = _planes("non_square")
    B, K, H, W = det.shape
    tag = rng.standard_normal((B, K, T, H, W)).astype(np.float32)
    got = top_k_peaks_batch(torch.from_numpy(det), torch.from_numpy(tag), M, 5)
    want = pallas_topk.top_k_peaks_batch(jnp.asarray(det), jnp.asarray(tag), M, 5,
                                         interpret=True, tag_layout="thw")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_heatmap_nms_is_maxpool_equality():
    det = torch.from_numpy(_planes("ties"))
    sup = heatmap_nms(det, 5)
    pooled = torch.nn.functional.max_pool2d(det[0], 5, 1, 2)
    assert torch.equal(sup[0], torch.where(pooled == det[0], det[0], 0.0))


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        nms_topk(torch.zeros(2, 16, 16), M)
    with pytest.raises(TypeError):
        nms_topk(torch.zeros(1, 1, 16, 16, dtype=torch.float16), M)
    with pytest.raises(ValueError):
        nms_topk(torch.zeros(1, 1, 2, 2), M)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twin_on_card(cuda, case, dtype):
    det = torch.from_numpy(_planes(case)).to(dtype)
    for kernel in (3, 5):
        want_v, want_p = nms_topk_ref(det, M, kernel)
        before = nms_topk.launches
        val, pos = nms_topk(det.to(cuda), M, kernel)
        torch.cuda.synchronize()
        assert nms_topk.launches == before + 1
        assert torch.equal(val.cpu(), want_v)
        assert torch.equal(pos.cpu(), want_p)
