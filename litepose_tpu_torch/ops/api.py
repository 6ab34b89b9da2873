"""The ops API under JAX's names, with JAX's arguments, shapes and output
dtypes (counterparts of the functions of ``litepose_tpu/ops/__init__.py``
that take one image or one cost matrix).

The port's decode is batched.  Each function here is the batched code at
batch 1, so a CUDA tensor launches the kernel (K2 or K3 in
``match_by_tag``, K4 in ``refine``, K5 in ``heatmap_nms``) and a CPU tensor
runs its plain twin.  The batched functions keep their names in
``ops/group.py``, ``ops/hungarian.py`` and ``ops/nms.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import group, hungarian as hung
from .nms import nms_suppress
from .refine import refine_batch


def heatmap_nms(det: torch.Tensor, kernel: int = 5, padding: int = 2) -> torch.Tensor:
    """Suppress the non-local-maxima of ``det`` (..., H, W), fp32 or bf16:
    torch ``MaxPool2d(kernel, 1, padding)`` equality, the map in ``det``'s
    dtype (K5 on the card).  A suppressed negative cell is +0.0 where
    JAX's XLA path writes -0.0.  ``padding`` must be ``kernel // 2``: with
    any other, JAX's window max no longer has ``det``'s shape and its
    comparison fails; here it is a ValueError."""
    if padding != kernel // 2:
        raise ValueError(f"padding {padding} must be kernel // 2 = {kernel // 2}")
    return nms_suppress(det, kernel)


def _square(name: str, cost: torch.Tensor) -> int:
    if cost.dim() != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"{name} expects one square cost (n, n), got {tuple(cost.shape)}")
    return cost.shape[0]


def greedy_assign(cost: torch.Tensor, n_rows) -> torch.Tensor:
    """Greedy min-cost matching of the first ``n_rows`` rows of one square
    cost: cost (n, n) -> (n,) int32, the column of each row, n where
    unassigned.  n rounds each take the cheapest live (row, column) pair,
    ties to the lowest row-major index; rows >= ``n_rows`` and costs >=
    3e38 never match (JAX's ``greedy_assign``)."""
    n = _square("greedy_assign", cost)
    live = torch.arange(n, device=cost.device) < torch.as_tensor(n_rows, device=cost.device)
    c = torch.where(live[:, None], cost.float(), hung.BIG)
    return hung.greedy_assign(c[None])[0].to(torch.int32)


def hungarian_prefix(cost: torch.Tensor, n_rows) -> torch.Tensor:
    """Exact min-cost assignment of the first ``n_rows`` rows of one square
    cost to distinct columns (JAX's ``hungarian_prefix``, op for op): cost
    (n, n) -> (n,) int32, the column of each row, n for rows >= n_rows."""
    n = _square("hungarian_prefix", cost)
    rows = torch.as_tensor(n_rows).reshape(1).to(cost.device)
    if not 0 <= int(rows) <= n:
        raise ValueError(f"n_rows {int(rows)} not in [0, {n}]")
    return hung.hungarian_prefix(cost[None], rows)[0].to(torch.int32)


def match_by_tag(tag_k: torch.Tensor, loc_k: torch.Tensor, val_k: torch.Tensor,
                 cfg: group.StaticGroupCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """AE grouping of one image's peaks (JAX's ``match_by_tag``): tag_k (K,
    M, T), loc_k (K, M, 2) x/y, val_k (K, M) sorted descending per joint ->
    (clusters (P, K, 3+T) f32 with P = ``cfg.max_clusters``: each cluster's
    (x, y, score, tag...) per joint, zeros where it has none, in creation
    order; n_clusters () int32).  Greedy (K2) or Hungarian (K3) by
    ``cfg.assignment``; the peaks are taken in float32, as ``parse_batch``
    takes them."""
    if tag_k.dim() != 3 or loc_k.shape != (*tag_k.shape[:2], 2) or val_k.shape != tag_k.shape[:2]:
        raise ValueError(f"expected tag_k (K, M, T), loc_k (K, M, 2) and val_k (K, M), got "
                         f"{tuple(tag_k.shape)}, {tuple(loc_k.shape)} and {tuple(val_k.shape)}")
    people, n_cl = group.match_by_tag_batch(*(a[None].float().contiguous()
                                              for a in (tag_k, loc_k, val_k)), cfg)
    return people[0], n_cl[0]


def adjust(people: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Quarter-pixel shift toward the larger neighbour plus the +0.5 centre
    offset of one image's people (JAX's ``adjust``): people (P, K, 3+T),
    det (K, H, W)."""
    return group.adjust(people[None], det[None])[0]


def refine(people: torch.Tensor, det: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """Fill one image's missing joints from the tag-penalized heatmap
    argmax (JAX's ``refine``) through K4: people (P, K, 3+T), det (K, H,
    W), tag (K, H, W, T) -> refined people; a slot with no detected joint
    comes back all zeros."""
    if people.dim() != 3 or det.dim() != 3 or tag.dim() != 4:
        raise ValueError(f"expected people (P, K, 3+T), det (K, H, W) and tag (K, H, W, T), "
                         f"got {tuple(people.shape)}, {tuple(det.shape)} and {tuple(tag.shape)}")
    return refine_batch(people[None], det[None], tag[None], tag_layout="hwt")[0]
