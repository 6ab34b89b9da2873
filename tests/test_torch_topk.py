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


CASES = ["random", "ties", "dominant_row", "few_peaks", "negative", "non_square",
         "signed_zeros", "band_ties", "skewed_plateau"]
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
    if case == "signed_zeros":  # -0.0 and +0.0 maxima: equal, so flat order
        det = -np.abs(rng.standard_normal((1, 2, 16, 24))).astype(np.float32)
        det[0, 0, 2:9, 3:20:4] = -0.0
        det[0, 0, 5, 1] = 0.0
        det[0, 1] = np.where(rng.random((16, 24)) < 0.5, -0.0, 0.0).astype(np.float32)
        return det
    if case == "band_ties":  # tied peaks down columns, across every row band
        det = (0.2 * rng.random((1, 2, 40, 24))).astype(np.float32)
        det[0, 0, ::3, 5] = det[0, 0, 1::3, 17] = 0.9
        det[0, 1, 7::8, ::6] = 0.5  # fewer than M peaks in some bands
        return det
    if case == "skewed_plateau":  # most pixels tie at the top: long candidate lists
        return skewed_plateau((1, 2, 16, 64))
    raise KeyError(case)


def skewed_plateau(shape) -> np.ndarray:
    """Planes whose columns below 7/8 of the width are a plateau of 1.0 and
    the rest 0.5; at width 512 a band CTA's threads below 448 hold only
    1.0 pixels, so its threshold falls to a 0.5 key and every 1.0 pixel of
    the band is a candidate."""
    det = np.full(shape, 0.5, np.float32)
    det[..., : shape[-1] * 7 // 8] = 1.0
    return det


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


# -- the banded kernel's decomposition, emulated in torch -------------------


def pack_keys(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit order key of fp32 values at flat indices, as int64
    with the top bit flipped (int64 order = the key's unsigned order):
    orderable value (-0.0 as +0.0) << 32 | (0x7FFFFFFF - idx) << 1 | negzero."""
    bits = v.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    negzero = bits == 0x80000000
    bits = torch.where(negzero, 0, bits)
    ord_ = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return ((ord_ - 2**31) << 32) | ((0x7FFFFFFF - idx.long()) << 1) | negzero.long()


SENTINEL = torch.iinfo(torch.int64).min  # unsigned key 0, below every pixel


def unpack_keys(key: torch.Tensor):
    """(fp32 values, int32 flat indices) of int64 keys, -0.0 restored."""
    ord_ = (key >> 32) + 2**31
    low = key & 0xFFFFFFFF
    bits = torch.where(ord_ >= 0x80000000, ord_ & 0x7FFFFFFF, ~ord_ & 0xFFFFFFFF)
    bits = torch.where((low & 1) == 1, 0x80000000, bits)
    val = (bits - ((bits >= 2**31).long() << 32)).to(torch.int32).view(torch.float32)
    return val, (0x7FFFFFFF - (low >> 1)).to(torch.int32)


def select_top(keys: torch.Tensor, m: int, threads: int, pix: int):
    """The kernel's ``select_top`` on one CTA's keys (element j of thread t
    at t + j * threads, SENTINEL where absent): warp tops, the threshold
    tau, the candidates at or above it, their ranks."""
    n = keys.numel()
    held = torch.full((pix * threads,), SENTINEL, dtype=torch.int64)
    held[:n] = keys
    tmax = held.reshape(pix, threads).amax(0)  # per thread
    warps = threads // 32
    q = -(-m // warps)
    tops = tmax.reshape(warps, 32).sort(dim=1, descending=True).values[:, :q].flatten()
    real = tops[tops != SENTINEL].sort(descending=True).values
    tau = real[m - 1] if real.numel() >= m else SENTINEL
    cand = keys[(keys != SENTINEL) & (keys >= tau)]
    top_keys = keys[keys != SENTINEL].sort(descending=True).values[:m]
    # the candidates hold the true top-m (the threshold argument)
    assert torch.equal(cand.sort(descending=True).values[:m], top_keys)
    out = torch.full((m,), SENTINEL, dtype=torch.int64)
    rank = (cand[None, :] > cand[:, None]).sum(1)
    keep = rank < m
    out[rank[keep]] = cand[keep]
    return out


def banded_nms_topk(det: torch.Tensor, m: int, kernel: int, band_h: int,
                    threads: int = 512, pix: int = 16):
    """K1 as the kernel decomposes it: per row band, NMS over the band and an
    r-row halo (vertical then horizontal max), the band's top-m keys; then
    per plane the same selection over the n_bands x m band keys."""
    r = kernel // 2
    x = det.float()
    B, K, H, W = x.shape
    val = torch.empty((B, K, m), dtype=torch.float32)
    pos = torch.empty((B, K, m), dtype=torch.int32)
    for b in range(B):
        for k in range(K):
            lists = []
            for y0 in range(0, H, band_h):
                rows = min(band_h, H - y0)
                raw = torch.full((rows + 2 * r, W), float("-inf"))
                lo, hi = max(y0 - r, 0), min(y0 + rows + r, H)
                raw[lo - (y0 - r):hi - (y0 - r)] = x[b, k, lo:hi]
                vm = torch.stack([raw[d:d + rows] for d in range(2 * r + 1)]).amax(0)
                padded = torch.nn.functional.pad(vm, (r, r), value=float("-inf"))
                hm = torch.stack([padded[:, d:d + W] for d in range(2 * r + 1)]).amax(0)
                own = raw[r:r + rows]
                s = torch.where(hm == own, own, torch.zeros_like(own))
                assert rows * W <= threads * pix
                keys = pack_keys(s.flatten(), y0 * W + torch.arange(rows * W))
                lists.append(select_top(keys, m, threads, pix))
            merged = torch.cat(lists)
            assert merged.numel() <= threads * pix
            val[b, k], pos[b, k] = unpack_keys(select_top(merged, m, threads, pix))
    return val, pos


def test_keys_round_trip_and_order():
    v = torch.tensor([0.5, -0.0, 0.0, -1.5, float("inf"), -float("inf"), 1e-45, -1e-45])
    idx = torch.tensor([3, 0, 7, 2, 9, 1, 4, 5])
    got_v, got_i = unpack_keys(pack_keys(v, idx))
    assert torch.equal(got_v.view(torch.int32), v.view(torch.int32))
    assert torch.equal(got_i, idx.int())
    # value descending, -0.0 == +0.0 in flat order, then lower index first
    order = pack_keys(v, idx).argsort(descending=True)
    assert order.tolist() == [4, 0, 6, 1, 2, 7, 3, 5]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("geometry", [(None, 512, 16), (1, 64, 8), (5, 64, 4), (8, 32, 8)])
def test_banded_emulation_matches_twin(case, geometry):
    """Bands of the kernel's height (one band: at these widths the kernel
    takes min(H, 8192 // W) rows) and of heights that do and do not divide
    H, with the kernel's CTA shape and with small ones (many bands, warps
    and candidates), NMS windows 3 and 5: bit for bit, -0.0 included."""
    det = torch.from_numpy(_planes(case))
    band_h, threads, pix = geometry
    for kernel in (3, 5):
        H, W = det.shape[-2:]
        bh = min(band_h or H, threads * pix // W)
        got_v, got_p = banded_nms_topk(det, M, kernel, bh, threads, pix)
        want_v, want_p = nms_topk_ref(det, M, kernel)
        assert torch.equal(got_p, want_p)
        assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))


@pytest.mark.parametrize("case", ["ties", "few_peaks", "negative", "band_ties"])
def test_banded_emulation_bf16(case):
    """bf16 planes (ties at bf16 resolution), 3-row bands of a small CTA."""
    det = torch.from_numpy(_planes(case)).to(torch.bfloat16)
    got_v, got_p = banded_nms_topk(det, M, 5, 3, threads=64, pix=4)
    want_v, want_p = nms_topk_ref(det, M, 5)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))


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
        assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))
        assert torch.equal(pos.cpu(), want_p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 512, 704), (2, 2, 448, 448), (1, 2, 45, 224)])
@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_kernel_matches_twin_on_card_shapes(cuda, shape, kernel):
    """Multi-scale eval planes, a height no band height divides and NMS
    windows 3 to 7: tied plateaus, a plane with fewer than M peaks over
    several bands, signed zeros."""
    rng = np.random.default_rng(kernel)
    det = (0.3 * rng.random(shape)).astype(np.float32)
    det[0, 0, ::5, 11] = 0.9  # ties down a column, across every band
    det[0, 1] = 0.0
    det[0, 1, 3::40, 7::90] = 0.5  # a few peaks, the rest zeros in flat order
    det[-1, -1, : shape[2] // 2] = -0.0
    det = torch.from_numpy(det)
    for dtype in (torch.float32, torch.bfloat16):
        want_v, want_p = nms_topk_ref(det.to(dtype), 30, kernel)
        val, pos = nms_topk(det.to(dtype).to(cuda), 30, kernel)
        torch.cuda.synchronize()
        assert torch.equal(pos.cpu(), want_p)
        assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_kernel_skewed_plateau_on_card(cuda, kernel):
    """512-wide 16-row bands in which every 1.0 pixel is a candidate: 7168
    candidates a band CTA, the most its list ever holds."""
    det = torch.from_numpy(skewed_plateau((1, 2, 64, 512)))
    for dtype in (torch.float32, torch.bfloat16):
        want_v, want_p = nms_topk_ref(det.to(dtype), 30, kernel)
        val, pos = nms_topk(det.to(dtype).to(cuda), 30, kernel)
        torch.cuda.synchronize()
        assert torch.equal(pos.cpu(), want_p)
        assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.cuda
def test_kernel_limits_on_card(cuda):
    """The band counts of the eval shapes, and the widest plane the shared
    memory allows, stated in the wrapper's error."""
    from litepose_tpu_torch.kernels import build

    lib = build.load()
    assert lib.lp_nms_topk_bands(512, 704, 30, 2) == 47  # 11-row bands
    assert lib.lp_nms_topk_bands(448, 448, 30, 2) == 25  # 18-row bands
    with pytest.raises(ValueError, match="widest the K1 kernel takes for nms_kernel=7: 7103"):
        nms_topk(torch.zeros(1, 1, 4, 7200, device=cuda), 30, 7)
    with pytest.raises(ValueError, match="merge of 8192 band keys"):
        nms_topk(torch.zeros(1, 1, 4096, 4096, device=cuda), 30, 5)
