"""The plain reference of the serving decode, batched in PyTorch: NMS by a
max-pool, the exact top-M, greedy associative-embedding grouping in the
configuration's joint order, the people rows and their scores.

It follows the reference implementation's semantics (mit-han-lab/litepose
``lib/core/group.py``, the greedy matcher of the serving path) in fp32,
each product and sum rounded on its own, with these fixed choices:

- NMS keeps a pixel equal to the max of its ``nms_kernel`` window (cells
  outside the plane are -inf) and zeroes the rest; the top-M is a stable
  descending sort, so ties go to the lowest flat index;
- the cost of peak i and cluster c is ``min(round(|tag_i - mean_c|) * 100,
  8000) - val_i``, columns past the clusters so far cost 1e4; the greedy
  matcher takes the cheapest live pair, ties to the lowest row-major index,
  ``min(M, P)`` times; a matched peak joins when its tag distance is below
  ``tag_threshold``, every other peak above the detection threshold opens a
  cluster while the table (``max_clusters``) has room;
- a person's score is its joints' scores summed in joint order, divided
  by the joint count.

``precision="bf16"`` is the control: tag means, costs and scores rounded to
bfloat16 after each operation.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

BIG = 3e38
PAD_COST = 1e4
CLIP_COST = 8e3


def peaks(det: torch.Tensor, tag: torch.Tensor, max_people: int, nms_kernel: int):
    """det (B, J, H, W), tag (B, J, T, H, W) -> tag_k (B, J, M, T), x, y, val
    (B, J, M), fp32."""
    B, J, H, W = det.shape
    T = tag.shape[2]
    d = det.float()
    mx = F.max_pool2d(d.reshape(B * J, 1, H, W), nms_kernel, 1, nms_kernel // 2).reshape(d.shape)
    sup = torch.where(mx == d, d, torch.zeros_like(d)).reshape(B, J, H * W)
    vals, idx = torch.sort(sup, dim=-1, descending=True, stable=True)
    val, ind = vals[..., :max_people], idx[..., :max_people]
    tag_k = torch.gather(tag.float().reshape(B, J, T, H * W), 3,
                         ind[:, :, None, :].expand(B, J, T, max_people)).permute(0, 1, 3, 2)
    return tag_k, (ind % W).float(), (ind // W).float(), val


def greedy(cost: torch.Tensor) -> torch.Tensor:
    """cost (B, M, P) -> the column of each row (B, M), M where none."""
    B, M, P = cost.shape
    c = cost.reshape(B, M * P).clone()
    flat = torch.arange(M * P, device=c.device)
    rows, cols = flat // P, flat % P
    out = torch.full((B, M), M, dtype=torch.long, device=c.device)
    row_ids = torch.arange(M, device=c.device)
    for _ in range(min(M, P)):
        best = c.min(dim=1).values
        first = torch.where(c == best[:, None], flat, M * P).min(dim=1).values
        live = best < BIG
        r, col = first // P, first % P
        out = torch.where(live[:, None] & (row_ids == r[:, None]), col[:, None], out)
        dead = (rows == r[:, None]) | (cols == col[:, None])
        c = torch.where(live[:, None] & dead, torch.full_like(c, BIG), c)
    return out


def decode(det: torch.Tensor, tag: torch.Tensor, cfg: Dict, precision: str = "fp32"
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maps -> (people (B, max_clusters, J, 3 + T): x, y, score, tags of the
    peak each cluster holds of each joint; scores (B, max_clusters); counts
    (B,), int32)."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision is fp32 or bf16, got {precision!r}")

    def r(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if precision == "bf16" else t

    P, PC = cfg["max_people"], cfg["max_clusters"]
    thr, tag_thr = cfg["detection_threshold"], cfg["tag_threshold"]
    order: Sequence[int] = cfg["joint_order"]
    tag_k, xs, ys, val = peaks(det, tag, P, cfg["nms_kernel"])
    B, J, M, T = tag_k.shape
    dev = det.device
    tag_sum = torch.zeros((B, P, T), device=dev)
    tag_cnt = torch.zeros((B, P), device=dev)
    n_cl = torch.zeros((B,), dtype=torch.long, device=dev)
    cid = torch.full((B, J, M), -1, dtype=torch.long, device=dev)
    cols = torch.arange(P, device=dev)
    for step, k in enumerate(order):
        tags, v = tag_k[:, k], val[:, k]
        mask = v > thr
        first = (n_cl == 0) | (step == 0)
        match = ~first
        n_match = torch.clamp(n_cl, max=P)
        mean = r(tag_sum / torch.clamp(tag_cnt, min=1.0)[:, :, None])
        d = tags[:, :, None, :] - mean[:, None, :, :]
        if T == 1:
            dist = r(d[..., 0].abs())
        else:
            acc = r(d[..., 0] * d[..., 0])
            for t in range(1, T):
                acc = r(acc + r(d[..., t] * d[..., t]))
            dist = r(torch.sqrt(acc.double()).float())
        if cfg["use_detection_val"]:
            cost = r(torch.clamp(r(torch.round(dist) * 100.0), max=CLIP_COST) - v[:, :, None])
        else:
            cost = torch.clamp(dist, max=CLIP_COST)
        cost = torch.where((cols < n_match[:, None])[:, None, :], cost,
                           torch.full_like(cost, PAD_COST))
        cost = torch.where((mask & match[:, None])[:, :, None], cost, torch.full_like(cost, BIG))
        pick = greedy(cost)
        picked = torch.gather(dist, 2, torch.clamp(pick, max=P - 1)[:, :, None])[..., 0]
        join = match[:, None] & mask & (pick < n_match[:, None]) & (picked < tag_thr)
        spawn = mask & (first[:, None] | (match[:, None] & ~join))
        slot = n_cl[:, None] + torch.cumsum(spawn.long(), dim=1) - 1
        new = torch.where(spawn & (slot < PC), slot, -1)
        cid[:, k] = torch.where(join, pick, new)
        # a column is joined by one peak at most, so each sum over the peaks
        # adds one tag to zeros
        zero = torch.zeros((), device=dev)
        hit = (pick[:, :, None] == cols) & join[:, :, None]  # (B, M, P)
        added = torch.where(hit[..., None], tags[:, :, None, :], zero).sum(1)
        tag_sum = torch.where(hit.any(1)[..., None], r(tag_sum + added), tag_sum)
        tag_cnt = tag_cnt + hit.sum(1).float()
        born = (new[:, :, None] == cols) & (new >= 0)[:, :, None]
        tag_sum = torch.where(born.any(1)[..., None],
                              torch.where(born[..., None], tags[:, :, None, :], zero).sum(1),
                              tag_sum)
        tag_cnt = torch.where(born.any(1), torch.ones_like(tag_cnt), tag_cnt)
        n_cl = torch.clamp(n_cl + spawn.sum(1), max=PC)

    joints = torch.cat([xs[..., None], ys[..., None], val[..., None], tag_k], dim=-1)
    people = torch.zeros((B, PC, J, 3 + T), device=dev)
    b_i, j_i, m_i = torch.nonzero(cid >= 0, as_tuple=True)
    people[b_i, cid[b_i, j_i, m_i], j_i] = joints[b_i, j_i, m_i]
    v = people[..., 2]
    s = v[..., 0]
    for j in range(1, J):
        s = r(s + v[..., j])
    scores = r(s / torch.full_like(s, float(J)))
    return people, scores, n_cl.to(torch.int32)
