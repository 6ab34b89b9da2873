"""Greedy min-cost matching, plain PyTorch (counterpart of
``litepose_tpu/ops/hungarian.py:greedy_assign``).

The exact Jonker-Volgenant solver (``hungarian_prefix``, TPU kernel K3)
belongs to the eval slice and is not ported yet (ROADMAP K3).
"""

from __future__ import annotations

import torch

BIG = 3e38


def greedy_assign(cost: torch.Tensor) -> torch.Tensor:
    """Batched fixed-iteration greedy matching.

    cost: (B, M, P) float32; entries >= ``BIG`` never match (the caller sets
    whole rows to BIG to leave them out).  min(M, P) rounds each take the
    globally cheapest live (row, col) pair, ties to the lowest row-major
    index, then retire its row and column.  Returns (B, M) int64: the column
    of each row, M where unassigned.  This is the greedy branch of the TPU
    grouping kernel (``litepose_tpu/ops/pallas_group.py:226-241``) and the
    plain twin of the loop inside ``csrc/group_greedy.cu``."""
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
        m_sel = first // P
        g_sel = first % P
        hit = ok[:, None] & (row_ids[None, :] == m_sel[:, None])
        assign = torch.where(hit, g_sel[:, None], assign)
        kill = (rows[None, :] == m_sel[:, None]) | (cols[None, :] == g_sel[:, None])
        c = torch.where(ok[:, None] & kill, torch.full_like(c, BIG), c)
    return assign
