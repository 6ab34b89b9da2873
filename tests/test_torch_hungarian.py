"""The exact JV assignment, ``hungarian_prefix``: the port's batched plain
twin of K3 against the JAX solver, bit for bit, and its optimum against
scipy's.

Both JAX forms (the XLA ``while_loop`` solver here, the Pallas kernel in
``tests/test_torch_group.py``) give the same assignment; the twin must give
that assignment, not merely an optimal one, because the grouping's costs
tie often (rounded tag distances times 100)."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from litepose_tpu_torch.ops.hungarian import hungarian_prefix


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
