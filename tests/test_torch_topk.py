"""K1: the port's fused NMS + exact top-M against the JAX package.

On the CPU ``nms_topk`` runs its plain twin; it must equal the Pallas kernel
``nms_topk_pallas`` (interpret mode) and ``top_k_peaks_batch`` bit for bit,
values and flat indices, tie order included, on planes with NaNs too (the
window max carries a NaN, so its finite neighbours are suppressed).  The
CUDA kernels are held against the twin on the card (marked ``cuda``,
skipped without one).

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


def nan_planes(shape=(2, 3, 24, 32), seed=5) -> np.ndarray:
    """(B, K >= 3, H, W >= 2) fp32 planes with NaNs: a single NaN beside
    the largest finite value of its window (two on planes of 6 x 6 and
    more), NaNs on the borders and corners, a NaN plane, NaN rows and
    columns (NaN rows across any row band)."""
    rng = np.random.default_rng(seed)
    det = rng.standard_normal(shape).astype(np.float32)
    B, K, H, W = shape
    for y, x, v in nan_traps(H, W):
        det[0, 0, y, x] = np.nan
        det[0, 0, y, x + 1] = v  # its window's largest finite value: suppressed by the NaN
    det[0, 1, 0, 0] = det[0, 1, H - 1, W - 1] = det[0, 1, 0, W // 2] = np.nan
    det[0, 1, H // 2, W // 2] = 6.0
    det[0, 2] = np.nan
    det[1 % B, 0, 2::7] = np.nan
    det[1 % B, 1, :, 5::9] = np.nan
    return det


def nan_traps(H: int, W: int) -> list:
    """(y, x, value) of plane (0, 0)'s NaNs in ``nan_planes``: the cell at
    (y, x + 1) holds ``value``, which a max that drops the NaN would keep."""
    traps = [(min(10, H - 1), min(10, W - 2), 5.0)]
    if H >= 6 and W >= 6:
        traps.append((4, 3, 4.0))
    return traps


@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_twin_matches_pallas_kernel_with_nan(jref, kernel):
    """A NaN spreads through the window max in the TPU kernel (jnp.maximum)
    and in the twin (max_pool2d): the NaN and every cell within r of it
    become +0, its finite neighbours included."""
    jnp, pallas_topk = jref
    det = nan_planes()
    val, pos = nms_topk(torch.from_numpy(det), M, kernel)
    want_v, want_p = pallas_topk.nms_topk_pallas(jnp.asarray(det), M, kernel, _interp=True)
    np.testing.assert_array_equal(val.numpy().view(np.int32), np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_p))
    assert not torch.isnan(val).any()
    W = det.shape[3]
    assert not {y * W + x + 1 for y, x, _ in nan_traps(*det.shape[2:])} & set(pos[0, 0].tolist())
    assert (val[0, 2] == 0).all() and torch.equal(pos[0, 2], torch.arange(M, dtype=torch.int32))


@pytest.mark.parametrize("T", [1, 2])
def test_top_k_peaks_batch_matches_jax(jref, T):
    """Peaks with the tag gather and x/y decode, "thw" tag layout."""
    jnp, pallas_topk = jref
    rng = np.random.default_rng(T)
    det = _planes("non_square")
    B, K, H, W = det.shape
    tag = rng.standard_normal((B, K, T, H, W)).astype(np.float32)
    got = top_k_peaks_batch(torch.from_numpy(det), torch.from_numpy(tag), M, 5, tag_layout="thw")
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
@pytest.mark.parametrize("gather", ["vec", "sum", "dot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_twin_with_nan_on_card(cuda, gather, dtype):
    """K1 ("vec") and K1's staged instance ("sum", "dot") on NaN planes:
    equal to the twin, the NaNs' finite neighbours suppressed."""
    det = torch.from_numpy(nan_planes()).to(dtype)
    for kernel in (3, 5, 7):
        want_v, want_p = nms_topk_ref(det, M, kernel)
        val, pos = nms_topk(det.to(cuda), M, kernel, _gather=gather)
        torch.cuda.synchronize()
        assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))
        assert torch.equal(pos.cpu(), want_p)
        W = det.shape[3]
        assert not ({y * W + x + 1 for y, x, _ in nan_traps(*det.shape[2:])}
                    & set(pos[0, 0].tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel", [((2, 3, 448, 448), 5), ((1, 3, 512, 704), 7),
                                          ((1, 3, 40, 6000), 5), ((1, 3, 6600, 3), 3),
                                          ((1, 3, 50, 90), 65)])
def test_kernels_match_twin_with_nan_on_card_shapes(cuda, shape, kernel):
    """NaNs across K1's row bands at eval and trap shapes, and through the
    lean instance of K1' (planes too wide or too tall for the staged one,
    and a window wider than its shuffles, which takes the row buffer); K1
    on the same planes."""
    det = torch.from_numpy(nan_planes(shape, seed=kernel))
    for dtype in (torch.float32, torch.bfloat16):
        want_v, want_p = nms_topk_ref(det.to(dtype), 30, kernel)
        for gather in ("vec", "sum"):
            val, pos = nms_topk(det.to(dtype).to(cuda), 30, kernel, _gather=gather)
            torch.cuda.synchronize()
            assert torch.equal(pos.cpu(), want_p), gather
            assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32)), gather


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


# -- K1': the per-plane loop over a row-max vector -------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("gather", ["sum", "dot"])
def test_loop_variant_matches_pallas_sum(jref, case, gather):
    """``_gather="sum"`` and ``"dot"`` (K1' on the card) run the twin on the
    CPU: equal to the Pallas loop kernel ``_gather="sum"`` in interpret
    mode (the exact variant; "dot" is inexact only on the TPU's MXU)."""
    jnp, pallas_topk = jref
    det = _planes(case)
    val, pos = nms_topk(torch.from_numpy(det), M, 5, _gather=gather)
    want_v, want_p = pallas_topk.nms_topk_pallas(jnp.asarray(det), M, 5, _gather="sum",
                                                 _interp=True)
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_p))


def test_wrapper_rejects_unknown_gather():
    with pytest.raises(ValueError, match="_gather"):
        nms_topk(torch.zeros(1, 1, 8, 8), M, _gather="mxu")


def row_suppressed(x: torch.Tensor, y: int, r: int) -> torch.Tensor:
    """Row y of the suppressed plane, computed from the input as the K1'
    kernel does: the vertical max over rows y - r .. y + r, r columns of
    -inf on each side, the horizontal max, the equality test."""
    H, W = x.shape
    vm = x[max(y - r, 0):min(y + r, H - 1) + 1].amax(0)
    padded = torch.nn.functional.pad(vm, (r, r), value=float("-inf"))
    m = torch.stack([padded[d:d + W] for d in range(2 * r + 1)]).amax(0)
    return torch.where(m == x[y], x[y], torch.zeros_like(x[y]))


# (the keys pass 1 leaves a row, the keys a refill leaves): kFirst and kCache
# of the kernel's staged instance; the lean one keeps one key a row
LOOP_INSTANCES = {"staged": (2, 4), "lean": (1, 1)}
NO_ROW = -(2**32)  # below every row key's value word


def top_below(keys: torch.Tensor, last, n: int) -> list:
    """The n largest of a row's cell keys below ``last`` (None: all),
    descending: what the kernel's ``row_top`` leaves in the row's cache."""
    if last is not None:
        keys = keys[keys < last]
    return keys.sort(descending=True).values[:n].tolist()


def loop_nms_topk(det: torch.Tensor, m: int, kernel: int, instance=(2, 4)):
    """K1' as the kernel computes it, ``instance`` = (first, cache): (2, 4)
    staged, (1, 1) lean -> (val, pos, refills).  Pass 1 leaves each row its
    ``first`` largest cell keys (K1's key with the column for the flat
    index).  Then m rounds: a row's key is the value word of its cache's
    head (none when the cache is spent); the largest, on the lowest row
    holding it (the two warp reductions), gives the row; its head is slot
    i; a row whose last fill was all taken refills from the plane with its
    next ``cache`` keys below the one just taken, and a row whose fill held
    fewer keys than it asked for has no cell left."""
    first, cache = instance
    r = kernel // 2
    x = det.float()
    B, K, H, W = x.shape
    val = torch.empty((B, K, m), dtype=torch.float32)
    pos = torch.empty((B, K, m), dtype=torch.int32)
    refills = 0
    for b in range(B):
        for k in range(K):
            keys = [pack_keys(row_suppressed(x[b, k], y, r), torch.arange(W)) for y in range(H)]
            cached = [top_below(kk, None, first) for kk in keys]
            head, fill = [0] * H, [first] * H
            for i in range(m):
                words = [c[h] >> 32 if h < len(c) else NO_ROW for c, h in zip(cached, head)]
                y = words.index(max(words))
                key = cached[y][head[y]]
                v, c = unpack_keys(torch.tensor([key]))
                val[b, k, i], pos[b, k, i] = v[0], y * W + c[0]
                head[y] += 1
                if head[y] == fill[y]:
                    cached[y], head[y], fill[y] = top_below(keys[y], key, cache), 0, cache
                    refills += 1
    return val, pos, refills


def _assert_loop_equals_twin(det: torch.Tensor, m: int, kernel: int, instance) -> int:
    got_v, got_p, refills = loop_nms_topk(det, m, kernel, instance)
    want_v, want_p = nms_topk_ref(det, m, kernel)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    return refills


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_loop_emulation_matches_twin(case, kernel):
    """The row-cache design, emulated in both instances, against the twin
    bit for bit (-0.0 included), fp32 and bf16 planes, NMS windows 3 to 7."""
    for dtype in (torch.float32, torch.bfloat16):
        det = torch.from_numpy(_planes(case)).to(dtype)
        for instance in LOOP_INSTANCES.values():
            _assert_loop_equals_twin(det, M, kernel, instance)


def test_loop_emulation_narrow_planes():
    """Planes narrower than the NMS window and a single column: rows of one
    cell run out, and the next round takes the next row."""
    rng = np.random.default_rng(9)
    for shape in ((1, 2, 9, 3), (1, 1, 12, 1), (1, 1, 1, 12)):
        det = torch.from_numpy(rng.integers(0, 3, shape).astype(np.float32))
        for kernel in (3, 7):
            for instance in LOOP_INSTANCES.values():
                _assert_loop_equals_twin(det, min(M, shape[2] * shape[3]), kernel, instance)


STRESS = ["one_row", "crowded_row", "row_plateau", "negative_zero", "few_peaks"]


def _stress_planes(case: str) -> np.ndarray:
    """(1, 2, H, W) fp32 planes that work the row caches and their refills."""
    rng = np.random.default_rng(20 + STRESS.index(case))
    det = (0.05 * rng.random((1, 2, 12, 48))).astype(np.float32)
    if case == "one_row":  # all M peaks in one row: its cache empties and refills
        det[0, :, 6, ::3] = np.linspace(0.9, 0.5, 16, dtype=np.float32)
    elif case == "crowded_row":  # more peaks than a cache in one row, between other rows'
        det[0, :, 3, 2::5] = np.float32(0.7) - 0.02 * np.arange(10, dtype=np.float32)
        det[0, :, 8, 7::9] = np.float32(0.69) - 0.02 * np.arange(5, dtype=np.float32)
        det[0, 1, 10, ::4] = 0.7  # ties with the crowded row's first peak
    elif case == "row_plateau":  # equal values across rows: flat order through the block
        det[0, 0, 2:9, 3:40] = 0.5
        det[0, 1] = 0.25
    elif case == "negative_zero":  # -0.0 everywhere, +0.0 and negatives here and there
        det[0, 0] = -0.0
        det[0, 0, 5, 7::11] = 0.0
        det[0, 1] = np.where(rng.random((12, 48)) < 0.3, -0.0, -rng.random((12, 48)))
    elif case == "few_peaks":  # fewer than M peaks: the zeros in flat order, then negatives
        det[0] = -1.0 - rng.random((2, 12, 48)).astype(np.float32)
        det[0, 0, 4, 9] = 0.8
        det[0, 0, 10, 30] = 0.3
    else:
        raise KeyError(case)
    return det


@pytest.mark.parametrize("instance", list(LOOP_INSTANCES))
@pytest.mark.parametrize("case", STRESS)
def test_loop_emulation_stress(case, instance):
    """The caches' refills: one row holding every peak, a row with more
    peaks than its cache, a plateau across rows, -0.0 planes, fewer than M
    peaks; equal to the twin in fp32 and bf16, windows 3 to 7.  M = 12: the
    staged instance refills in every case."""
    refills = 0
    for dtype in (torch.float32, torch.bfloat16):
        det = torch.from_numpy(_stress_planes(case)).to(dtype)
        for kernel in (3, 5, 7):
            refills += _assert_loop_equals_twin(det, 12, kernel, LOOP_INSTANCES[instance])
    assert refills > 0


# The K1' kernel's choice of instance (csrc/nms_topk_loop.cu: plan, layout),
# and the shared memory the earlier row-recompute kernel needed, for the
# limits tests.
LOOP_BUDGET = 227 * 1024  # a CTA's dynamic shared memory
OLD_LOOP_BUDGET = 226 * 1024


def _up16(b: int) -> int:
    return (b + 15) // 16 * 16


def loop_layout_bytes(H: int, W: int, r: int, elem: int, chunk: int, cache: int,
                      buffer: bool) -> int:
    """Ring, row caches (with their value words, heads and fills when
    cache > 1), and the lean instance's row buffer."""
    pitch = (W + 63) // 64 * 64  # a ring row: W rounded up to a warp's 64-column tile
    ring = _up16((2 * chunk + 2 * r if chunk else 0) * pitch * elem)
    rows = _up16(H * cache * 8) + (_up16(H * 4) + 2 * _up16(H) if cache > 1 else 0)
    return ring + rows + (_up16(4 * (W + 2 * r)) if buffer else 0)


def loop_plan(H: int, W: int, r: int, elem: int):
    """(1 staged / 2 lean / -1, shared memory bytes): for windows up to 63
    (the shuffle horizontal max), chunks of 16 rows while a staged CTA fits
    a quarter of the budget, else 8, else the lean instance."""
    if r <= 31:
        for chunk in (16, 8):  # 2 and 1 rows a warp of 8
            b = loop_layout_bytes(H, W, r, elem, chunk, 4, False)
            if b <= (LOOP_BUDGET // 4 if chunk == 16 else LOOP_BUDGET):
                return 1, b
    b = loop_layout_bytes(H, W, r, elem, 0, 1, True)
    return (2 if b <= LOOP_BUDGET else -1), b


def old_loop_smem(H: int, W: int, M: int, r: int) -> int:
    """The earlier kernel's CTA: H row keys, 8 warps' rows of W + 2r floats, M
    taken positions."""
    return 8 * H + 8 * 4 * (W + 2 * r) + 4 * M


def old_loop_shapes():
    """(H, W, M, r) the earlier kernel took: a grid, and at each W and r the
    tallest plane, at each H and r the widest."""
    out = []
    for r in (0, 1, 2, 3):
        for H in (1, 2, 45, 224, 448, 512, 1000, 6000, 20000):
            for W in (1, 3, 224, 448, 704, 2900, 4200, 7000):
                for M in (1, 30, 1000):
                    out.append((H, W, M, r))
        for W in (1, 2, 33, 448, 3000, 7000):
            out.append(((OLD_LOOP_BUDGET - old_loop_smem(0, W, 1, r)) // 8, W, 1, r))
        for H in (1, 64, 448, 10000):
            out.append((H, (OLD_LOOP_BUDGET - old_loop_smem(H, 0, 1, r)) // 32 - 2 * r, 1, r))
    return [(H, W, M, r) for H, W, M, r in out
            if H >= 1 and W >= 1 and M <= H * W and old_loop_smem(H, W, M, r) <= OLD_LOOP_BUDGET]


def test_loop_plan_takes_every_old_shape():
    """Every shape the earlier kernel took is taken by the redesign (mostly by
    its staged instance; the widest, the tallest and windows wider than 63
    by its lean one), and the serving, eval and 512x704 planes by the
    staged one; the lean one takes 40x6000 fp32, 6600x3 and k = 65."""
    shapes = old_loop_shapes()
    assert len(shapes) > 500
    seen = set()
    for H, W, M, r in shapes:
        for elem in (2, 4):
            instance, _ = loop_plan(H, W, r, elem)
            assert instance > 0, (H, W, M, r, elem)
            seen.add(instance)
    assert seen == {1, 2}
    for H, W in ((224, 224), (448, 448), (512, 704), (45, 224), (300, 1)):
        for elem in (2, 4):
            assert loop_plan(H, W, 2, elem)[0] == 1
    assert loop_plan(40, 6000, 2, 4)[0] == 2 and loop_plan(40, 6000, 1, 2)[0] == 1
    assert loop_plan(6600, 3, 3, 4)[0] == loop_plan(6600, 3, 1, 2)[0] == 2
    assert loop_plan(50, 90, 32, 4)[0] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("gather", ["sum", "dot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_loop_kernel_matches_twin_and_k1_on_card(cuda, case, dtype, gather):
    """K1' bit-equal to the twin and to K1, counted by its own counter."""
    det = torch.from_numpy(_planes(case)).to(dtype)
    for kernel in (3, 5, 7):
        want_v, want_p = nms_topk_ref(det, M, kernel)
        before, k1_before = nms_topk.loop_launches, nms_topk.launches
        val, pos = nms_topk(det.to(cuda), M, kernel, _gather=gather)
        torch.cuda.synchronize()
        assert (nms_topk.loop_launches, nms_topk.launches) == (before + 1, k1_before)
        assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))
        assert torch.equal(pos.cpu(), want_p)
        k1_v, k1_p = nms_topk(det.to(cuda), M, kernel)
        assert torch.equal(val.view(torch.int32), k1_v.view(torch.int32))
        assert torch.equal(pos, k1_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STRESS)
def test_loop_kernel_stress_on_card(cuda, case):
    """The emulation's refill cases on the card, bit-equal to the twin."""
    for dtype in (torch.float32, torch.bfloat16):
        det = torch.from_numpy(_stress_planes(case)).to(dtype)
        for kernel in (3, 5, 7):
            want_v, want_p = nms_topk_ref(det, 12, kernel)
            val, pos = nms_topk(det.to(cuda), 12, kernel, _gather="sum")
            torch.cuda.synchronize()
            assert torch.equal(pos.cpu(), want_p)
            assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 14, 448, 448), (1, 3, 512, 704), (1, 2, 45, 224),
                                   (1, 1, 300, 1), (1, 2, 40, 6000), (1, 1, 6600, 3)])
def test_loop_kernel_on_card_shapes(cuda, shape):
    """Eval planes, a plane of one column (every row runs out after its one
    cell), the K1 traps, and planes too wide (40x6000 fp32) or too tall
    (6600x3) for the staged instance, which the lean one takes: bit-equal to
    the twin, fp32 and bf16, windows 3-7."""
    rng = np.random.default_rng(3)
    det = (0.3 * rng.random(shape)).astype(np.float32)
    if shape[3] > 11:
        det[0, 0, ::5, 11] = 0.9
    det[-1, -1, : shape[2] // 2] = -0.0
    det = torch.from_numpy(det)
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in (3, 5, 7):
            want_v, want_p = nms_topk_ref(det.to(dtype), 30, kernel)
            val, pos = nms_topk(det.to(dtype).to(cuda), 30, kernel, _gather="sum")
            torch.cuda.synchronize()
            assert torch.equal(pos.cpu(), want_p)
            assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [65, 101])
def test_loop_kernel_wide_window_on_card(cuda, kernel):
    """Windows wider than the shuffle horizontal max takes (r > 31) go to
    the lean instance's row buffer: bit-equal to the twin."""
    rng = np.random.default_rng(kernel)
    det = torch.from_numpy((0.3 * rng.random((1, 3, 50, 90))).astype(np.float32))
    det[0, 1, 20:, :40] = -0.0
    for dtype in (torch.float32, torch.bfloat16):
        want_v, want_p = nms_topk_ref(det.to(dtype), 30, kernel)
        val, pos = nms_topk(det.to(dtype).to(cuda), 30, kernel, _gather="sum")
        torch.cuda.synchronize()
        assert torch.equal(pos.cpu(), want_p)
        assert torch.equal(val.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.cuda
def test_loop_kernel_limits_on_card(cuda):
    """The kernel's plan equals the formula above on every shape the earlier
    kernel took (so each is still taken), and a plane beyond the lean
    instance raises naming the limit."""
    import ctypes

    from litepose_tpu_torch.kernels import build

    lib = build.load()
    smem, budget = ctypes.c_int(), ctypes.c_int()
    for H, W, M, r in old_loop_shapes():
        for is_bf16 in (0, 1):
            instance = lib.lp_nms_topk_loop_plan(H, W, r, is_bf16, ctypes.byref(smem),
                                                 ctypes.byref(budget))
            assert instance > 0, (H, W, M, r, is_bf16)
            assert (instance, smem.value) == loop_plan(H, W, r, 2 if is_bf16 else 4)
    assert budget.value == LOOP_BUDGET
    assert lib.lp_nms_topk_loop_plan(30000, 1, 2, 0, ctypes.byref(smem),
                                     ctypes.byref(budget)) == -1
    with pytest.raises(ValueError, match="shared memory of the K1' kernel"):
        nms_topk(torch.zeros(1, 1, 30000, 1, device=cuda), 30, 5, _gather="sum")
