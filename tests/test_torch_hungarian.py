"""The exact JV assignment, ``hungarian_prefix``: the port's batched plain
twin of K3 against the JAX solver, bit for bit, and its optimum against
scipy's.

Both JAX forms (the XLA ``while_loop`` solver here, the Pallas kernel in
``tests/test_torch_group.py``) give the same assignment; the twin must give
that assignment, not merely an optimal one, because the grouping's costs
tie often (rounded tag distances times 100).

The K3 kernel's decomposition (``csrc/group_hungarian.cu``: a key-based
first argmin by warp reduction and ballot, row potentials on the row lanes
with an ``in_tree`` flag, the augment by a pre-read ``p[way]``) is emulated
in torch and held to the twin bit for bit; the kernel itself is held to the
twin on the card (marked ``cuda``).  Only fixtures import jax, so
``pytest --noconftest -m cuda`` runs this file on the machine with the card."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from litepose_tpu_torch.ops.group import (GroupParams, StaticGroupCfg, group_hungarian,
                                          match_by_tag)
from litepose_tpu_torch.ops.hungarian import INF, hungarian_prefix


@pytest.fixture(scope="module")
def j_hungarian():
    import jax.numpy as jnp
    from litepose_tpu.ops.hungarian import hungarian_prefix as jh

    return lambda cost, n_rows: np.asarray(jh(jnp.asarray(cost), n_rows))


def _cost(rng, n, kind):
    if kind == "normal":
        return rng.normal(size=(n, n)).astype(np.float32)
    if kind == "grouping":  # rint(distance) * 100 - score, PAD columns
        c = (rng.integers(0, 3, (n, n)) * 100.0 - rng.uniform(0, 1, (n, 1))).astype(np.float32)
        c[:, n - n // 3:] = 1e4
        return c
    if kind == "binary":  # massively tied
        return rng.integers(0, 2, (n, n)).astype(np.float32)
    return np.zeros((n, n), np.float32)  # all tied


@pytest.mark.parametrize("kind", ["normal", "grouping", "binary", "zeros"])
@pytest.mark.parametrize("n", [1, 4, 9])
def test_twin_matches_jax_solver_every_prefix(j_hungarian, kind, n):
    rng = np.random.default_rng(n * 7 + len(kind))
    c = _cost(rng, n, kind)
    got = hungarian_prefix(torch.from_numpy(c)[None].expand(n + 1, n, n),
                           torch.arange(n + 1))
    for n_rows in range(n + 1):
        np.testing.assert_array_equal(got[n_rows].numpy(), j_hungarian(c, n_rows),
                                      err_msg=f"n_rows={n_rows}")


def test_twin_batch_of_grouping_costs(j_hungarian):
    """30 x 30 grouping costs with a different prefix per image: each image
    of the batch as the JAX solver assigns it alone."""
    rng = np.random.default_rng(3)
    B, n = 6, 30
    costs = np.stack([_cost(rng, n, "grouping") for _ in range(B)])
    n_rows = np.array([0, 1, 7, 18, 29, 30])
    got = hungarian_prefix(torch.from_numpy(costs), torch.from_numpy(n_rows)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b], j_hungarian(costs[b], int(n_rows[b])))


@pytest.mark.parametrize("seed", range(4))
def test_twin_reaches_scipy_optimum(seed):
    rng = np.random.default_rng(seed)
    n = 12
    c = rng.normal(size=(n, n)).astype(np.float32)
    assign = hungarian_prefix(torch.from_numpy(c)[None], torch.tensor([n]))[0].numpy()
    assert sorted(assign.tolist()) == list(range(n))  # a permutation
    r, col = linear_sum_assignment(c.astype(np.float64))
    np.testing.assert_allclose(c[np.arange(n), assign].sum(dtype=np.float64),
                               c[r, col].sum(dtype=np.float64), rtol=1e-6)


def test_rows_past_prefix_stay_unassigned():
    c = torch.zeros((2, 5, 5))
    got = hungarian_prefix(c, torch.tensor([2, 0]))
    assert got[0, 2:].tolist() == [5, 5, 5]
    assert sorted(got[0, :2].tolist()) == [0, 1]
    assert got[1].tolist() == [5] * 5


# -- the warp kernel's decomposition, emulated in torch ----------------------

LANES = 32
NO_KEY = 0xFFFFFFFF  # lanes past the problem: above every float's key


def float_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernels' order-preserving u32 key of each float32 (``float_key``
    in ``csrc/group_common.cuh``): a non-negative float's bits with the sign
    bit set, a negative float's bits negated mod 2**32, so -0.0 gets +0.0's
    key; as int64 values in [0, 2**32)."""
    b = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(b < 0x80000000, b | 0x80000000, (2**32 - b) & 0xFFFFFFFF)


def key_floats(k: torch.Tensor) -> torch.Tensor:
    """The float32 of each key (``key_float``)."""
    b = torch.where(k >= 0x80000000, k ^ 0x80000000, (2**32 - k) & 0xFFFFFFFF)
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def warp_first_min(keys: torch.Tensor, tags: torch.Tensor):
    """``first_min`` in ``csrc/group_common.cuh``: ``__reduce_min_sync`` over
    the lanes' keys, then over the tags of the lanes holding the least key
    (NO_KEY elsewhere): (least such tag, least key)."""
    kmin = keys.min()
    return int(torch.where(keys == kmin, tags, NO_KEY).min()), kmin


def twin_first_min(minv: torch.Tensor, used: torch.Tensor):
    """The twin's rule for one image (``hungarian_prefix``): (j1, delta)."""
    n1 = minv.shape[0]
    cols = torch.arange(n1)
    masked = torch.where(used | (cols == 0), INF, minv)
    delta = masked.min()
    return int(torch.where(masked == delta, cols, n1).min()), delta


def kernel_first_min(minv: torch.Tensor, used: torch.Tensor):
    """The kernel's: INF's key for column 0 and used columns, NO_KEY on the
    lanes past the n + 1 columns, the least key and the lowest lane holding
    it (tagged by the lane), delta decoded from the least key."""
    n1 = minv.shape[0]
    keys = torch.full((LANES,), NO_KEY, dtype=torch.int64)
    masked = used | (torch.arange(n1) == 0)
    keys[:n1] = torch.where(masked, float_keys(torch.tensor(INF)), float_keys(minv))
    j1, kmin = warp_first_min(keys, torch.arange(LANES))
    return j1, key_floats(kmin)


def _first_min_case(kind: str, n1: int, rng):
    minv = torch.from_numpy((rng.integers(-3, 4, n1) * 100.0
                             - rng.integers(0, 2, n1) * 0.25).astype(np.float32))
    used = torch.from_numpy(rng.random(n1) < 0.3)
    if kind == "random":
        minv = torch.from_numpy(rng.normal(0, 1e3, n1).astype(np.float32))
    elif kind == "signed_zeros":  # +0.0 before -0.0 in column order: they tie
        minv = torch.abs(minv) + 1.0
        minv[n1 - 1], minv[max(1, n1 // 3)] = -0.0, 0.0
        used[:] = False
    elif kind == "masked_only_low":  # the least values sit on used columns
        used[:] = False
        used[1:n1 // 2] = True
        minv[1:n1 // 2] = -1e6
    elif kind == "all_masked":  # every column used: column 0, delta INF
        used[:] = True
    elif kind == "above_inf":  # unused values above INF lose to column 0
        used[:] = True
        used[n1 - 1] = False
        minv[n1 - 1] = 3e18
    return minv, used


@pytest.mark.parametrize("kind", ["ties", "random", "signed_zeros", "masked_only_low",
                                  "all_masked", "above_inf"])
@pytest.mark.parametrize("n1", [2, 11, 31])
def test_key_first_min_matches_twin_rule(kind, n1):
    """The order-preserving key, its warp minimum and the ballot's lowest
    lane give the twin's j1 and delta: planted ties, +-0.0, INF-masked
    lanes, the all-INF case (column 0) and values above INF."""
    rng = np.random.default_rng(n1 * 13 + len(kind))
    for _ in range(20):
        minv, used = _first_min_case(kind, n1, rng)
        j_twin, d_twin = twin_first_min(minv, used)
        j_kern, d_kern = kernel_first_min(minv, used)
        assert j_kern == j_twin
        assert d_kern == d_twin
        if d_twin != 0:
            assert d_kern.view(torch.int32) == d_twin.view(torch.int32)
    if kind == "all_masked":
        assert j_twin == 0 and d_twin == INF
    if kind == "signed_zeros":
        assert j_twin == max(1, n1 // 3) and d_kern.view(torch.int32) == 0


def jv_lanes(cost: torch.Tensor, n_rows: int):
    """K3's solver for one image as the warp runs it: lane j holds column j
    (v, minv and its key, used, way, p, the row's offset) and up = u[p[j]],
    the potential of the row on it; a sweep shuffles up from j0 and reads
    that row's cost, takes the least masked key and, by a second reduction
    over (lane, p, offset) of the lanes holding it, j1 with p[j1] and the
    next row's offset; adds delta to up and subtracts it from v on the used
    lanes, from minv on the others; the augment pre-reads p[way] and up[way]
    and walks `way`.  Returns (the column of each row, n = unassigned;
    sweeps + augment steps)."""
    n = cost.shape[0]
    stride = LANES + 1  # the kernel's shared cost rows
    lane = torch.arange(LANES)
    column = (lane >= 1) & (lane <= n)
    flat = torch.zeros(LANES * stride, dtype=torch.float32)
    flat.view(LANES, stride)[:n, :n] = cost
    col_of = torch.where(column, lane - 1, 0)
    inf_key = float_keys(torch.tensor(INF))
    zero = torch.zeros((), dtype=torch.float32)
    up = torch.zeros(LANES)
    v = torch.zeros(LANES)
    p = torch.zeros(LANES, dtype=torch.int64)
    roff = torch.zeros(LANES, dtype=torch.int64)
    chain = 0
    for r in range(n_rows):
        i = r + 1
        p[0], roff[0], up[0] = i, r * stride, 0.0
        minv = torch.full((LANES,), INF)
        kminv = torch.full((LANES,), int(inf_key), dtype=torch.int64)
        used = torch.zeros(LANES, dtype=torch.bool)
        way = torch.zeros(LANES, dtype=torch.int64)
        j0, roff0 = 0, r * stride
        for _ in range(i + 1):
            chain += 1
            used |= lane == j0
            a = torch.where(column, flat[roff0 + col_of], zero)
            cur = (a - up[j0]) - v
            better = (cur < minv) & ~used
            minv = torch.where(better, cur, minv)
            kminv = torch.where(better, float_keys(cur), kminv)
            way = torch.where(better, j0, way)
            keys = torch.where(lane > n, NO_KEY, torch.where(used | (lane == 0), inf_key, kminv))
            hit, kmin = warp_first_min(keys, (lane << 24) | (p << 16) | roff)
            delta = key_floats(kmin)
            up = torch.where(used, up + delta, up)
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            kminv = torch.where(used, kminv, float_keys(minv))
            j0, roff0 = hit >> 24, hit & 0xFFFF
            if (hit >> 16) & 0xFF == 0:
                break
        pw, upw = p[way], up[way]
        for _ in range(i + 1):
            if j0 == 0:
                break
            chain += 1
            p[j0], up[j0], roff[j0] = pw[j0], upw[j0], (pw[j0] - 1) * stride
            j0 = int(way[j0])
    assign = torch.full((n,), n, dtype=torch.int64)
    for j in range(1, n + 1):
        if p[j] >= 1:
            assign[p[j] - 1] = j - 1
    return assign, chain


def _hold_jv_lanes(costs: np.ndarray, n_rows) -> None:
    chain = torch.zeros(len(costs), dtype=torch.int64)
    want = hungarian_prefix(torch.from_numpy(costs), torch.as_tensor(n_rows), chain)
    for b, c in enumerate(costs):
        got, steps = jv_lanes(torch.from_numpy(c), int(n_rows[b]))
        assert torch.equal(got, want[b]), f"image {b}, n_rows {n_rows[b]}"
        assert steps == int(chain[b])


@pytest.mark.parametrize("kind", ["normal", "grouping", "binary", "zeros"])
@pytest.mark.parametrize("n", [1, 4, 9, 31])
def test_lane_emulation_matches_twin_every_prefix(kind, n):
    """The kernel's bookkeeping on the tie-heavy costs of the JAX-solver
    tests, every prefix: the twin's assignment and its chain count."""
    c = _cost(np.random.default_rng(n * 7 + len(kind)), n, kind)
    _hold_jv_lanes(np.repeat(c[None], n + 1, 0), list(range(n + 1)))


@pytest.mark.parametrize("seed", range(3))
def test_lane_emulation_matches_twin_grouping_costs(seed):
    """30 x 30 grouping costs with duplicated rows (exact cost ties), full
    prefixes and partial ones."""
    rng = np.random.default_rng(100 + seed)
    costs = np.stack([_cost(rng, 30, "grouping") for _ in range(4)])
    costs[:, 1::2] = costs[:, 0::2]
    _hold_jv_lanes(costs, [30, 30, 17, 1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K3 kernel has no CPU mode")
    return torch.device("cuda")


def _long_chain_inputs(seed, B, K, M, T, duplicated=False):
    """Peaks of a few people per image, every peak of every joint valid
    (the longest chains), optionally with each odd peak a copy of the even
    one before it (exact cost ties)."""
    rng = np.random.default_rng(seed)
    tag = rng.normal(0, 4.0, (B, K, M, T)).astype(np.float32)
    for b in range(B):
        centers = rng.normal(0, 3.0, (int(rng.integers(2, 12)), T))
        pick = rng.integers(0, len(centers), (K, M))
        near = rng.random((K, M)) < 0.6
        tag[b][near] = (centers[pick] + rng.normal(0, 0.2, (K, M, T)))[near]
    val = np.sort(rng.uniform(0.2, 1.0, (B, K, M)), axis=-1)[..., ::-1].astype(np.float32)
    if duplicated:
        tag[:, :, 1::2] = tag[:, :, 0:M - 1:2]
        val[:, :, 1::2] = val[:, :, 0:M - 1:2]
    return torch.from_numpy(tag.copy()), torch.from_numpy(val.copy())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("duplicated", [False, True])
@pytest.mark.parametrize("use_val,ignore_too_much", [(True, False), (False, False),
                                                     (True, True), (False, True)])
def test_kernel_long_chains_on_card(cuda, T, duplicated, use_val, ignore_too_much):
    """Every joint with all 30 peaks valid, at the decode's 14 joints and 30
    people: K3 equal to the twin, cluster ids and counts."""
    cfg = StaticGroupCfg.from_params(
        GroupParams(num_joints=14, max_num_people=30, detection_threshold=0.1,
                    use_detection_val=use_val, ignore_too_much=ignore_too_much),
        assignment="hungarian")
    tag, val = _long_chain_inputs(T, B=6, K=14, M=30, T=T, duplicated=duplicated)
    want_c, want_n = match_by_tag(tag, val, cfg)
    before = group_hungarian.launches
    cid, n = group_hungarian(tag.to(cuda), val.to(cuda), cfg)
    torch.cuda.synchronize()
    assert group_hungarian.launches == before + 1
    assert torch.equal(cid.cpu(), want_c)
    assert torch.equal(n.cpu(), want_n)
