"""Min-cost assignment in plain PyTorch (counterpart of
``litepose_tpu/ops/hungarian.py``).

``greedy_assign`` is the greedy serving matcher (the loop inside K2,
``csrc/group_greedy.cu``); ``hungarian_prefix`` is the exact
Jonker-Volgenant solver of the eval decode, the plain twin of K3
(``csrc/group_hungarian.cu``).  Both are batched over images.
"""

from __future__ import annotations

from typing import Optional

import torch

BIG = 3e38
INF = 1e18  # the JV solver's sentinel (litepose_tpu/ops/hungarian.py:INF)


def greedy_assign(cost: torch.Tensor, chain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched fixed-iteration greedy matching.

    cost: (B, M, P) float32; entries >= ``BIG`` never match (the caller sets
    whole rows to BIG to leave them out).  min(M, P) rounds each take the
    globally cheapest live (row, col) pair, ties to the lowest row-major
    index, then retire its row and column.  Returns (B, M) int64: the column
    of each row, M where unassigned.  This is the greedy branch of the TPU
    grouping kernel (``litepose_tpu/ops/pallas_group.py:226-241``) and the
    plain twin of the loop inside ``csrc/group_greedy.cu``.

    chain: an optional (B,) int64 tensor; each image's rounds that assign a
    pair (the kernel's dependent chain) are added to it."""
    B, M, P = cost.shape
    dev = cost.device
    c = cost.reshape(B, M * P).clone()
    flat_ids = torch.arange(M * P, device=dev)
    rows = flat_ids // P
    cols = flat_ids % P
    assign = torch.full((B, M), M, dtype=torch.int64, device=dev)
    row_ids = torch.arange(M, device=dev)
    for _ in range(min(M, P)):
        cmin = c.min(dim=1).values  # (B,)
        first = torch.where(c == cmin[:, None], flat_ids, M * P).min(dim=1).values
        ok = cmin < BIG
        if chain is not None:
            chain += ok
        m_sel = first // P
        g_sel = first % P
        hit = ok[:, None] & (row_ids[None, :] == m_sel[:, None])
        assign = torch.where(hit, g_sel[:, None], assign)
        kill = (rows[None, :] == m_sel[:, None]) | (cols[None, :] == g_sel[:, None])
        c = torch.where(ok[:, None] & kill, torch.full_like(c, BIG), c)
    return assign


def hungarian_prefix(cost: torch.Tensor, n_rows: torch.Tensor,
                     chain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact min-cost assignment of the first ``n_rows[b]`` rows of each
    square cost matrix to distinct columns.

    cost (B, n, n) float32, n_rows (B,) int -> (B, n) int64: the column of
    each row, n for rows >= n_rows (unassigned).

    The potentials + shortest-augmenting-path solver in the form of the TPU
    kernel ``_jv_assign`` (``litepose_tpu/ops/pallas_group.py:56``), op for
    op in fp32: 1-indexed columns with a sentinel column 0; per sweep
    ``cur = (a[i0] - u[i0]) - v``, ``delta`` the first minimum over unused
    columns (column 0 masked to ``INF``), ``u[p[j]] += delta`` and
    ``v[j] -= delta`` for used columns, ``minv -= delta`` for unused ones.
    Row i (1-indexed) runs at most i + 1 sweeps and i + 1 augmenting steps.
    The grouping's ties are degenerate, so the same op order gives the same
    assignment, not merely an optimal one.  An image whose search has ended
    changes nothing in later sweeps, so the loops stop when every image of
    the batch has ended.

    chain: an optional (B,) int64 tensor; each image's sweeps and augment
    steps (the kernel's dependent chain) are added to it."""
    B, n, n2 = cost.shape
    if n != n2:
        raise ValueError(f"hungarian_prefix expects square costs, got {tuple(cost.shape)}")
    dev = cost.device
    n1 = n + 1
    a = torch.zeros((B, n1, n1), dtype=torch.float32, device=dev)
    a[:, 1:, 1:] = cost.float()
    u = torch.zeros((B, n1), dtype=torch.float32, device=dev)
    v = torch.zeros((B, n1), dtype=torch.float32, device=dev)
    p = torch.zeros((B, n1), dtype=torch.int64, device=dev)  # p[j]: row of column j
    cols = torch.arange(n1, device=dev)
    bidx = torch.arange(B, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_rows = n_rows.to(dev).long()

    for r in range(int(n_rows.max()) if B else 0):
        i = r + 1
        act_row = r < n_rows  # (B,)
        p[:, 0] = torch.where(act_row, i, p[:, 0])
        minv = torch.full((B, n1), INF, dtype=torch.float32, device=dev)
        used = torch.zeros((B, n1), dtype=torch.bool, device=dev)
        way = torch.zeros((B, n1), dtype=torch.int64, device=dev)
        j0 = torch.zeros((B,), dtype=torch.int64, device=dev)
        done = ~act_row
        for _ in range(i + 1):
            if bool(done.all()):
                break
            act = ~done
            if chain is not None:
                chain += act
            used = used | ((cols == j0[:, None]) & act[:, None])
            i0 = p.gather(1, j0[:, None])[:, 0]
            cur = a[bidx, i0] - u.gather(1, i0[:, None]) - v
            better = (cur < minv) & ~used & act[:, None]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(used | (cols == 0), INF, minv)
            delta = masked.min(dim=1, keepdim=True).values  # (B, 1)
            j1 = torch.where(masked == delta, cols, n1).min(dim=1).values
            # u[p[j]] += delta for used j: the used columns' rows are
            # distinct, so the one-hot count is 0 or 1
            hits = ((p[:, None, :] == cols[None, :, None]) & used[:, None, :]).float().sum(2)
            u = u + torch.where(act[:, None], hits * delta, zero)
            v = v - torch.where(used & act[:, None], delta, zero)
            minv = torch.where(~used & act[:, None], minv - delta, minv)
            j0 = torch.where(act, j1, j0)
            done = done | (act & (p.gather(1, j1[:, None])[:, 0] == 0))
        for _ in range(i + 1):  # walk back along `way`, flipping the matching
            act_b = (j0 != 0) & act_row
            if not bool(act_b.any()):
                break
            if chain is not None:
                chain += act_b
            j1 = way.gather(1, j0[:, None])[:, 0]
            p_j1 = p.gather(1, j1[:, None])
            p = torch.where((cols == j0[:, None]) & act_b[:, None], p_j1, p)
            j0 = torch.where(act_b, j1, j0)

    # invert: row m holds column j - 1 where p[j] == m + 1; unassigned -> n
    rows = p[:, 1:] - 1  # (B, n): row of column j
    hit = torch.arange(n, device=dev)[None, :, None] == rows[:, None, :]  # (B, m, j)
    col_of = torch.where(hit, torch.arange(n, device=dev), 0).sum(2)
    return torch.where(hit.any(2), col_of, n)
