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
card (marked ``cuda``, skipped without one), NaN included, in both its
instances; its ring instance's walk (each CTA's share of rows across
planes, the register window, the bf16 pair arithmetic) and launch plan
are emulated here and held to the twin on the CPU.

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


# -- the ring instance's walk, emulated on the CPU -----------------------------

# kStages, kMaxStageBytes and kMinRows in csrc/heatmap_nms.cu
RING_STAGES, RING_MAX_STAGE_BYTES, RING_MIN_ROWS = 2, 16384, 8


def ring_threads(r: int) -> int:
    """ring_threads in csrc/heatmap_nms.cu: the widest row (16-byte chunks)."""
    return 512 if r <= 3 else 256


def ring_plan(shape, itemsize: int, r: int, resident: int, budget: int, aligned: bool = True):
    """The ring instance's launch (plan_r in csrc/heatmap_nms.cu) for
    ``resident`` CTAs on the card, each allowed ``budget`` bytes of ring,
    or None where the tiled instance runs."""
    planes, H, W = shape
    row_bytes = W * itemsize
    if not aligned or row_bytes % 16 or row_bytes // 16 > ring_threads(r):
        return None
    stage_rows = max(1, min(budget // RING_STAGES, RING_MAX_STAGE_BYTES) // row_bytes)
    rows = planes * H
    per = max(RING_MIN_ROWS, -(-rows // resident))
    return {"instance": "ring", "threads": -(-(row_bytes // 16) // 32) * 32,
            "smem_bytes": RING_STAGES * stage_rows * row_bytes, "stage_rows": stage_rows,
            "stages": RING_STAGES, "grid": -(-rows // per), "rows_per_cta": per,
            "ring_budget": budget}


def _words(det: torch.Tensor) -> np.ndarray:
    """(planes * H, chunks, 4) uint32: each row as the kernel's 16-byte
    chunks of 32-bit words (a bf16 word: cell 2i low, 2i + 1 high)."""
    planes, H, W = det.shape
    if det.dtype == torch.float32:
        bits = det.contiguous().view(torch.int32).numpy().astype(np.uint32)
    else:
        half = det.contiguous().view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
        bits = half[..., 0::2] | (half[..., 1::2] << 16)
    return bits.reshape(planes * H, -1, 4)


def _cells(words: np.ndarray, bf16: bool):
    """The fp32 values of words: one array, or the (low, high) bf16 halves."""
    if not bf16:
        return words.view(np.float32)
    return (words << 16).view(np.float32), (words & 0xFFFF0000).view(np.float32)


def _max2(a: np.ndarray, b: np.ndarray, bf16: bool) -> np.ndarray:
    """max.NaN.f32 / max.NaN.bf16x2 on words."""
    with np.errstate(invalid="ignore"):
        if not bf16:
            return np.maximum(a.view(np.float32), b.view(np.float32)).view(np.uint32)
        (alo, ahi), (blo, bhi) = _cells(a, True), _cells(b, True)
        lo = np.maximum(alo, blo).view(np.uint32) >> 16
        hi = np.maximum(ahi, bhi).view(np.uint32) & 0xFFFF0000
        return (lo | hi).astype(np.uint32)


def _keep(m: np.ndarray, x: np.ndarray, bf16: bool) -> np.ndarray:
    """x where it equals m (fp32 ==, or set.eq.u32.bf16x2's halves), else +0."""
    if not bf16:
        return np.where(m.view(np.float32) == x.view(np.float32), x, 0).astype(np.uint32)
    (mlo, mhi), (xlo, xhi) = _cells(m, True), _cells(x, True)
    mask = np.where(mlo == xlo, 0xFFFF, 0) | np.where(mhi == xhi, 0xFFFF0000, 0)
    return (mask.astype(np.uint32) & x).astype(np.uint32)


def _row_max(row: np.ndarray, r: int, bf16: bool) -> np.ndarray:
    """row_max in csrc/heatmap_nms.cu for every chunk of one row
    (chunks, 4): its side chunks either side (-inf past the row's ends),
    then the words' windows; bf16 pairs shifted by one cell as
    __byte_perm(w[i], w[i + 1], 0x5432)."""
    neg = np.uint32(0xFF80FF80 if bf16 else 0xFF800000)
    side = -(-r // (8 if bf16 else 4))
    chunks = row.shape[0]
    pad = np.full((chunks + 2 * side, 4), neg, np.uint32)
    pad[side:side + chunks] = row
    w = np.stack([pad[s:s + chunks] for s in range(2 * side + 1)], 1).reshape(chunks, -1)
    own = 4 * side
    h = np.empty((chunks, 4), np.uint32)
    if not bf16:
        for j in range(4):
            m = w[:, own + j]
            for d in range(1, r + 1):
                m = _max2(_max2(m, w[:, own + j - d], False), w[:, own + j + d], False)
            h[:, j] = m
        return h
    q = (w[:, :-1] >> 16) | ((w[:, 1:] << 16) & 0xFFFFFFFF)
    for k in range(4):
        i = own + k
        m = w[:, i]
        for s in range(1, r + 1):
            m = _max2(m, q[:, i + (s - 1) // 2] if s & 1 else w[:, i + s // 2], True)
            m = _max2(m, q[:, i - (s + 1) // 2] if s & 1 else w[:, i - s // 2], True)
        h[:, k] = m
    return h


def ring_nms(det: torch.Tensor, kernel: int, plan: dict) -> torch.Tensor:
    """heatmap_nms_ring_kernel as each of its CTAs walks its rows: the
    staged rows [a, b) (r more either side in the same plane), r rows of
    -inf pushed after a plane's last row (the -inf above the next plane's
    first too), row i - r written when it is the CTA's and in row i's
    plane.  Raises if a row is written twice or never."""
    r = kernel // 2
    bf16 = det.dtype == torch.bfloat16
    planes, H, W = det.shape
    words = _words(det)
    rows = planes * H
    neg = np.full(words.shape[1:], 0xFF80FF80 if bf16 else 0xFF800000, np.uint32)
    out = np.zeros_like(words)
    written = np.zeros(rows, np.int64)
    per = plan["rows_per_cta"]
    for cta in range(plan["grid"]):
        g0, g1 = cta * per, min(rows, (cta + 1) * per)
        assert g0 < g1
        a = max(g0 - g0 % H, g0 - r)
        b = min(g1 - 1 - (g1 - 1) % H + H, g1 + r)
        assert b - a <= per + 2 * r
        h = [neg] * (2 * r + 1)
        x = [neg] * (r + 1)
        yl = a % H
        for i in range(b - a):
            h = h[1:] + [_row_max(words[a + i], r, bf16)]
            x = x[1:] + [words[a + i]]
            top = i - yl
            for f in range(r + 1 if yl == H - 1 else 1):
                if f:
                    h, x = h[1:] + [neg], x[1:] + [neg]
                o = i - r + f
                if g0 - a <= o < g1 - a and o >= top:
                    m = h[0]
                    for hh in h[1:]:
                        m = _max2(m, hh, bf16)
                    out[a + o] = _keep(m, x[0], bf16)
                    written[a + o] += 1
            yl = 0 if yl == H - 1 else yl + 1
    assert (written == 1).all(), f"rows written {np.unique(written)} times"
    flat = out.reshape(planes, H, -1)
    if not bf16:
        return torch.from_numpy(flat.view(np.int32).copy()).view(torch.float32)
    half = np.stack([flat & 0xFFFF, flat >> 16], -1).reshape(planes, H, W).astype(np.uint16)
    return torch.from_numpy(half.view(np.int16).copy()).view(torch.bfloat16)


def _seam_planes(shape, seams, seed: int) -> torch.Tensor:
    """Random planes with maxima, NaN, +-inf and signed zeros planted on and
    beside the global rows ``seams`` (a CTA's first rows), and tied maxima
    on the cells either side of a chunk boundary."""
    planes, H, W = shape
    rng = np.random.default_rng(seed)
    det = (0.5 * rng.random(shape)).astype(np.float32).reshape(planes * H, W)
    for n, g in enumerate(s for s in seams if 0 < s < planes * H):
        c = (7 * n + 3) % W
        det[g, c] = 0.9  # a maximum on the seam row
        det[g - 1, (c + 2) % W] = 0.95  # one just above it, in the other CTA
        det[g, (c + 5) % W] = (np.nan, np.inf, -np.inf, -0.0)[n % 4]
        det[g - 1, (c + 9) % W] = (0.0, -0.0, np.nan, np.inf)[n % 4]
    det[:, 7:9] = np.maximum(det[:, 7:9], 0.97) if W > 8 else det[:, 7:9]  # 8 bf16 cells a chunk
    det[::3, 3:5] = 0.99 if W > 4 else det[::3, 3:5]  # 4 fp32 cells a chunk
    return torch.from_numpy(det.reshape(shape))


RING_SHAPES = [(3, 24, 32), (4, 7, 40), (2, 1, 64), (1, 45, 104), (6, 3, 16)]


def test_plan_takes_only_a_card_tensor():
    """The plan is the card's launch: a CPU tensor, or one not (N, H, W),
    raises before any library is built."""
    from litepose_tpu_torch.ops.library import heatmap_nms_plan

    with pytest.raises(ValueError, match="CUDA"):
        heatmap_nms_plan(torch.zeros(2, 8, 8), 5)
    with pytest.raises(ValueError, match="CUDA"):
        heatmap_nms_plan(torch.zeros(8, 8), 5)


@pytest.mark.parametrize("resident", [1, 4, 7, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", [1, 3, 5, 7, 9, 11, 13, 15])
def test_ring_walk_is_the_twin(kernel, dtype, resident):
    """The ring instance's rows, windows, plane restarts and flushes, and
    its bf16 pair arithmetic, bit for bit with the twin: CTA shares that
    cross planes, start or end within r of a plane's edge, planes of one
    row, planes shorter than the window, with seeded maxima, NaN, +-inf and
    signed zeros on the seams and on chunk boundaries."""
    for n, shape in enumerate(RING_SHAPES):
        plan = ring_plan(shape, dtype.itemsize, kernel // 2, resident, 6112)
        assert plan is not None
        seams = range(plan["rows_per_cta"], shape[0] * shape[1], plan["rows_per_cta"])
        det = _seam_planes(shape, seams, 100 * kernel + n).to(dtype)
        got = ring_nms(det, kernel, plan)
        want = nms_suppress_ref(det, kernel)
        assert np.array_equal(_torch_bits(got), _torch_bits(want)), (shape, plan)


def test_ring_plan_covers_the_shapes():
    """The serving, eval, trap and per-image planes take the ring; a row
    that is no 16-byte multiple, a base off 16 bytes or a row wider than
    the ring's threads take the tiled instance.  A stage is whole rows of
    16-byte multiples within the CTA's budget (one row at least, 16 KB at
    most), so a ring under the budget leaves the registers' occupancy be;
    a CTA writes at least kMinRows rows and the grid never exceeds the
    resident CTAs."""
    # H100 (228 KB an SM, 1 KB reserved a CTA): 32 CTAs an SM by registers
    # for 32 threads, 8 for 128, 2 for 512
    for budget in (6112, 28000, 115712):
        for shape, itemsize in [((896, 224, 224), 2), ((448, 448, 448), 4), ((8, 512, 704), 4),
                                ((8, 512, 704), 2), ((14, 224, 224), 2), ((14, 448, 448), 4),
                                ((3, 5, 2048), 4)]:
            for r in range(8):
                plan = ring_plan(shape, itemsize, r, 132 * 4, budget)
                if shape[2] * itemsize > 16 * ring_threads(r):
                    assert plan is None
                    continue
                row_bytes = shape[2] * itemsize
                assert plan["smem_bytes"] <= max(budget, RING_STAGES * row_bytes)
                assert plan["stage_rows"] * row_bytes <= max(RING_MAX_STAGE_BYTES, row_bytes)
                assert plan["grid"] <= 132 * 4 and plan["rows_per_cta"] >= RING_MIN_ROWS
                assert (plan["grid"] - 1) * plan["rows_per_cta"] < shape[0] * shape[1]
    assert ring_plan((896, 224, 224), 2, 2, 132 * 32, 6112)["stage_rows"] == 6
    assert ring_plan((448, 448, 448), 4, 2, 132 * 8, 28000)["stage_rows"] == 7
    assert ring_plan((2, 45, 103), 4, 2, 100, 6112) is None  # 412-byte rows
    assert ring_plan((2, 45, 100), 2, 2, 100, 6112) is None  # 200-byte rows
    assert ring_plan((2, 45, 104), 4, 2, 100, 6112, aligned=False) is None
    assert ring_plan((1, 4, 2048), 4, 3, 100, 6112) is not None
    assert ring_plan((1, 4, 2049 + 3), 4, 3, 100, 6112) is None
    assert ring_plan((1, 4, 1024), 4, 4, 100, 6112) is not None
    assert ring_plan((1, 4, 1028), 4, 4, 100, 6112) is None


# -- the two instances on the card ----------------------------------------------


def _held_on_card(det: torch.Tensor, kernel: int, instance: str) -> None:
    """K5 on a CUDA (N, H, W) ``det``: one launch of ``instance``, whose
    ring plan is the CPU mirror's for the card's SMs, bit for bit with the
    twin run on the card."""
    from litepose_tpu_torch.ops.library import heatmap_nms_plan

    plan = heatmap_nms_plan(det, kernel)
    assert plan["instance"] == instance, plan
    if instance == "ring":
        sms = torch.cuda.get_device_properties(det.device).multi_processor_count
        want = ring_plan(tuple(det.shape), det.element_size(), kernel // 2,
                         sms * plan["ctas_per_sm"], plan["ring_budget"])
        assert {k: v for k, v in plan.items() if k != "ctas_per_sm"} == want
    before = nms_suppress.launches
    got = nms_suppress(det, kernel)
    want = nms_suppress_ref(det, kernel)
    torch.cuda.synchronize()
    assert nms_suppress.launches == before + 1
    assert got.dtype == det.dtype and got.shape == det.shape
    bits = torch.int32 if det.dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits)), (tuple(det.shape), kernel, plan)


ALL_KERNELS = [1, 3, 5, 7, 9, 11, 13, 15]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ALL_KERNELS)
def test_both_instances_on_card(cuda, kernel, dtype):
    """Shapes chosen to force each instance: 16-byte rows take the ring; a
    row of 8 bytes past a 16-byte multiple, a base off 16 bytes and a row
    wider than the ring's threads take the tiled instance."""
    r = kernel // 2
    ring = _seam_planes((3, 24, 32), [8, 16, 24], kernel).to(dtype).to(cuda)
    _held_on_card(ring, kernel, "ring")
    odd = 30 if dtype == torch.float32 else 36  # 120 or 72-byte rows
    _held_on_card(_seam_planes((3, 24, odd), [], kernel).to(dtype).to(cuda), kernel, "tiled")
    shifted = torch.cat([torch.zeros(1, dtype=dtype, device=cuda), ring.flatten()])[1:]
    assert shifted.data_ptr() % 16 != 0
    _held_on_card(shifted.view(ring.shape), kernel, "tiled")
    wide = ring_threads(r) * 16 // dtype.itemsize + 16 // dtype.itemsize
    _held_on_card(_seam_planes((2, 20, wide), [], kernel).to(dtype).to(cuda), kernel, "tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 131, 133, 897])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uneven_work_on_card(cuda, planes, dtype):
    """Plane counts that do not divide over the resident CTAs, planes of 37
    rows (no multiple of a stage's 21 or 42 rows, nor of a CTA's share),
    each window 1 to 15."""
    det = _seam_planes((planes, 37, 48), [], planes).to(dtype).to(cuda)
    for kernel in ALL_KERNELS:
        _held_on_card(det, kernel, "ring")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 45, 64), (5, 300, 96), (896, 9, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seams_on_card(cuda, shape, dtype):
    """Maxima, NaN, +-inf and signed zeros planted on and beside each CTA's
    first row (from the card's own plan), and tied maxima across a chunk
    boundary (cells 7 and 8 of a bf16 chunk, 3 and 4 of an fp32 one)."""
    from litepose_tpu_torch.ops.library import heatmap_nms_plan

    for kernel in ALL_KERNELS:
        probe = torch.empty(shape, dtype=dtype, device=cuda)
        per = heatmap_nms_plan(probe, kernel)["rows_per_cta"]
        det = _seam_planes(shape, range(per, shape[0] * shape[1], per), kernel)
        _held_on_card(det.to(dtype).to(cuda), kernel, "ring")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((14, 224, 224), torch.bfloat16),
                                         ((14, 448, 448), torch.float32)])
def test_per_image_shapes_on_card(cuda, shape, dtype):
    """parse_single's launches, one image's 14 planes, each window 1 to 15."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    det = (torch.rand(shape, generator=gen, device=cuda) * 0.5).to(dtype)
    det[0, 10, 10::9] = 0.9
    det[1, 5::40, 7] = 0.8
    det[2] = 0.0
    for kernel in ALL_KERNELS:
        _held_on_card(det, kernel, "ring")
