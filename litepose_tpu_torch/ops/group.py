"""Associative-embedding grouping and the batched decode (counterpart of
``litepose_tpu/ops/group.py`` and of ``GroupParams`` in
``litepose_tpu/ops/group_ref.py``, whose package needs jax).

Grouping runs as a kernel on CUDA tensors and as the plain twin
``match_by_tag`` on CPU tensors: ``group_greedy`` (K2,
``csrc/group_greedy.cu``, serving) and ``group_hungarian`` (K3,
``csrc/group_hungarian.cu``, eval), the two modes of the TPU kernel
``litepose_tpu/ops/pallas_group.py:_group_kernel``, both reached through
the registered ops ``torch.ops.litepose.group_greedy`` /
``group_hungarian`` (``ops/library.py``).  ``match_by_tag_batch``
then scatters the peaks into per-person rows.  ``parse_batch`` decodes a
batch from K1's peaks; ``parse_single`` decodes one image from K5's
(``ops/nms.py:top_k_peaks``), as the JAX package's per-image decode does.
The twin follows the TPU kernel, which is what the JAX decode runs: |d|
for one tag dimension, one rounding per multiply and add; greedy rows left
out by their own detection mask, Hungarian rows by the score-sorted prefix
they form.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import library
from .hungarian import BIG, greedy_assign, hungarian_prefix
from .refine import refine_batch, sqrt_rn
from .topk import check_tag_layout, top_k_peaks_batch

# Padding and clipping of the assignment cost, as in the JAX decode
# (litepose_tpu/ops/group.py:33-35): costs stay far from fp32's coarse range.
PAD_COST = 1e4
CLIP_COST = 8e3

# COCO grouping order (torso -> limbs); fewer joints (CrowdPose's 14) take
# the joints that exist, in this order (reference lib/core/group.py:113-120).
# With a kept centre joint (index 17 of 18) the centre groups first.
JOINT_ORDER_17 = [i - 1 for i in (1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11,
                                  14, 15, 16, 17)]
JOINT_ORDER_18 = [i - 1 for i in (18, 1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11,
                                  14, 15, 16, 17)]


def joint_order_for(num_joints: int, with_center_kept: bool = False) -> List[int]:
    order = JOINT_ORDER_18 if with_center_kept else JOINT_ORDER_17
    return [j for j in order if j < num_joints][:num_joints]


@dataclasses.dataclass
class GroupParams:
    """Decode thresholds and capacities (mirror of the JAX ``GroupParams``)."""

    num_joints: int = 14
    max_num_people: int = 30
    detection_threshold: float = 0.1
    tag_threshold: float = 1.0
    use_detection_val: bool = True
    ignore_too_much: bool = False
    nms_kernel: int = 5
    nms_padding: int = 2
    joint_order: Optional[Sequence[int]] = None
    # capacity of the fixed-size cluster table (>= max_num_people)
    max_clusters: int = 40

    def __post_init__(self):
        if self.joint_order is None:
            self.joint_order = joint_order_for(self.num_joints)

    @staticmethod
    def from_config(cfg) -> "GroupParams":
        """The experiment config's decode thresholds; a centre joint the
        decode ignores is dropped, a kept one groups first."""
        num_joints = cfg.DATASET.NUM_JOINTS
        with_center_kept = bool(cfg.DATASET.WITH_CENTER and not cfg.TEST.IGNORE_CENTER)
        if cfg.DATASET.WITH_CENTER and cfg.TEST.IGNORE_CENTER:
            num_joints -= 1
        return GroupParams(
            num_joints=num_joints,
            max_num_people=cfg.DATASET.MAX_NUM_PEOPLE,
            detection_threshold=cfg.TEST.DETECTION_THRESHOLD,
            tag_threshold=cfg.TEST.TAG_THRESHOLD,
            use_detection_val=cfg.TEST.USE_DETECTION_VAL,
            ignore_too_much=cfg.TEST.IGNORE_TOO_MUCH,
            nms_kernel=cfg.TEST.NMS_KERNEL,
            nms_padding=cfg.TEST.NMS_PADDING,
            joint_order=joint_order_for(num_joints, with_center_kept),
        )


class StaticGroupCfg(NamedTuple):
    """The decode configuration (mirror of the JAX ``StaticGroupCfg``).

    assignment: "hungarian" (eval, the default as in the JAX package) or
    "greedy" (serving).
    topk_method: "exact" and "approx" both run exact top-M here, ties to
    the lowest flat index.  Off a TPU ``lax.approx_max_k`` is an exact
    top-k too, but on bf16 planes its tie order is not fixed."""

    joint_order: Tuple[int, ...]
    max_people: int
    max_clusters: int
    detection_threshold: float
    tag_threshold: float
    use_detection_val: bool
    ignore_too_much: bool
    nms_kernel: int
    nms_padding: int
    assignment: str = "hungarian"
    topk_method: str = "exact"

    @staticmethod
    def from_params(p: GroupParams, assignment: str = "hungarian",
                    topk_method: str = "exact") -> "StaticGroupCfg":
        return StaticGroupCfg(
            joint_order=tuple(p.joint_order),
            max_people=p.max_num_people,
            max_clusters=max(p.max_clusters, p.max_num_people),
            detection_threshold=p.detection_threshold,
            tag_threshold=p.tag_threshold,
            use_detection_val=p.use_detection_val,
            ignore_too_much=p.ignore_too_much,
            nms_kernel=p.nms_kernel,
            nms_padding=p.nms_padding,
            assignment=assignment,
            topk_method=topk_method,
        )


def match_by_tag(tag_k: torch.Tensor, val_k: torch.Tensor, cfg: StaticGroupCfg,
                 chain: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-joint clustering over a batch (plain twin of K2 and K3).

    tag_k (B, K, M, T) f32, val_k (B, K, M) f32 (sorted descending per
    joint) -> (cid (B, K, M) int32: cluster of each peak, -1 for none;
    n_cl (B,) int32).  Cluster ids are in creation order.  chain: an
    optional (B,) int64 tensor that counts each image's greedy rounds or JV
    sweeps and augment steps over all joint steps (``greedy_assign``,
    ``hungarian_prefix``)."""
    B, K, M, T = tag_k.shape
    P = cfg.max_people  # assignment columns
    PC = cfg.max_clusters  # cluster table capacity
    dev = tag_k.device
    tag_sum = torch.zeros((B, P, T), dtype=torch.float32, device=dev)
    tag_cnt = torch.zeros((B, P), dtype=torch.float32, device=dev)
    n_cl = torch.zeros((B,), dtype=torch.int64, device=dev)
    cid = torch.full((B, K, M), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(P, device=dev)

    for step, k in enumerate(cfg.joint_order):
        tags = tag_k[:, k].float()  # (B, M, T)
        val = val_k[:, k].float()  # (B, M)
        mask = val > cfg.detection_threshold
        is_first = torch.full_like(mask[:, 0], step == 0) | (n_cl == 0)
        skip = torch.zeros_like(is_first)
        if cfg.ignore_too_much:
            skip = ~is_first & (n_cl >= P)
        do_match = ~is_first & ~skip  # (B,)

        G = torch.clamp(n_cl, max=P)
        mean = tag_sum / torch.clamp(tag_cnt, min=1.0)[:, :, None]  # (B, P, T)
        d = tags[:, :, None, :] - mean[:, None, :, :]  # (B, M, P, T)
        if T == 1:
            diff = d[..., 0].abs()
        else:
            acc = d[..., 0] * d[..., 0]
            for t in range(1, T):
                acc = acc + d[..., t] * d[..., t]
            diff = sqrt_rn(acc)  # (B, M, P)
        if cfg.use_detection_val:
            base = torch.clamp(torch.round(diff) * 100.0, max=CLIP_COST) - val[:, :, None]
        else:
            base = torch.clamp(diff, max=CLIP_COST)
        col_valid = cols[None, :] < G[:, None]  # (B, P)
        cost = torch.where(col_valid[:, None, :], base, torch.full_like(base, PAD_COST))
        if cfg.assignment == "greedy":
            live = mask & do_match[:, None]
            cost = torch.where(live[:, :, None], cost, torch.full_like(cost, BIG))
            assign = greedy_assign(cost, chain)  # (B, M), M = unassigned
        else:
            # exact prefix assignment of the full PAD-padded cost: the scores
            # are sorted, so the valid rows are the first n_valid
            # (pallas_group.py:218-225)
            n_solve = torch.where(do_match, mask.sum(1), 0)
            assign = hungarian_prefix(cost, n_solve, chain)

        matched = torch.gather(diff, 2, torch.clamp(assign, max=P - 1)[:, :, None])[..., 0]
        join = (do_match[:, None] & mask & (assign < G[:, None])
                & (matched < cfg.tag_threshold))
        spawn = mask & (is_first[:, None] | (do_match[:, None] & ~join))
        slot = n_cl[:, None] + torch.cumsum(spawn.long(), dim=1) - 1
        cid_spawn = torch.where(spawn & (slot < PC), slot, -1)
        cid_join = torch.where(join, assign, -1)
        cid[:, k] = torch.maximum(cid_join, cid_spawn)

        # join slots are < G <= n_cl, spawn slots >= n_cl: disjoint
        join_oh = (assign[:, :, None] == cols) & join[:, :, None]  # (B, M, P)
        spawn_oh = (cid_spawn[:, :, None] == cols) & (cid_spawn >= 0)[:, :, None]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        tag_sum = tag_sum + torch.where(join_oh[..., None], tags[:, :, None, :], zero).sum(1)
        tag_cnt = tag_cnt + join_oh.sum(1).float()
        any_spawn = spawn_oh.any(1)  # (B, P)
        spawned = torch.where(spawn_oh[..., None], tags[:, :, None, :], zero).sum(1)
        tag_sum = torch.where(any_spawn[:, :, None], spawned, tag_sum)
        tag_cnt = torch.where(any_spawn, torch.ones_like(tag_cnt), tag_cnt)
        n_cl = torch.clamp(n_cl + spawn.sum(1), max=PC)
    return cid.to(torch.int32), n_cl.to(torch.int32)


def _group_kernel(name: str, tag_k: torch.Tensor, val_k: torch.Tensor,
                  cfg: StaticGroupCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks, then the op ``name``: the CPU twin, or one launch of the
    grouping kernel (counted on ``<name>.launches``)."""
    if tag_k.dim() != 4 or val_k.shape != tag_k.shape[:3]:
        raise ValueError(
            f"expected tag (B,K,M,T) and val (B,K,M), got {tuple(tag_k.shape)} "
            f"and {tuple(val_k.shape)}")
    if tag_k.dtype != torch.float32 or val_k.dtype != torch.float32:
        raise TypeError("tag_k and val_k must be float32")
    if tag_k.device.type not in ("cpu", "cuda") or val_k.device != tag_k.device:
        raise ValueError(f"{name} runs on cpu or cuda, got {tag_k.device} "
                         f"and {val_k.device}")
    return library.call(name, tag_k, val_k, [int(k) for k in cfg.joint_order],
                        cfg.max_people, cfg.max_clusters, cfg.detection_threshold,
                        cfg.tag_threshold, cfg.use_detection_val, cfg.ignore_too_much)


def group_greedy(tag_k: torch.Tensor, val_k: torch.Tensor,
                 cfg: StaticGroupCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy grouping (K2): tag_k (B, K, M, T) f32, val_k (B, K, M) f32 ->
    (cid (B, K, M) int32, -1 = no cluster; n_cl (B,) int32).  A CPU tensor
    takes the plain twin; a CUDA tensor launches the kernel
    (``group_greedy.launches`` counts those launches)."""
    if cfg.assignment != "greedy":
        raise ValueError(f"group_greedy needs assignment='greedy', got {cfg.assignment!r}")
    return _group_kernel("group_greedy", tag_k, val_k, cfg)


def group_hungarian(tag_k: torch.Tensor, val_k: torch.Tensor,
                    cfg: StaticGroupCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouping with the exact JV assignment per joint step (K3); the same
    contract as ``group_greedy``.  The cost is square: M peaks ==
    ``max_people`` columns, as on the TPU."""
    if cfg.assignment != "hungarian":
        raise ValueError(f"group_hungarian needs assignment='hungarian', got "
                         f"{cfg.assignment!r}")
    M = tag_k.shape[2] if tag_k.dim() == 4 else -1
    if M != cfg.max_people or M + 1 > library.MAX_COLUMNS:
        raise ValueError(f"hungarian grouping needs M == max_people <= "
                         f"{library.MAX_COLUMNS - 1}, got M={M}, max_people={cfg.max_people}")
    return _group_kernel("group_hungarian", tag_k, val_k, cfg)


group_greedy.launches = 0
group_hungarian.launches = 0


def match_by_tag_batch(tag_k: torch.Tensor, loc_k: torch.Tensor,
                       val_k: torch.Tensor, cfg: StaticGroupCfg):
    """Group and assemble people: -> (people (B, PC, K, 3+T) f32, n_cl (B,)).

    Row p of an image holds, for each joint, (x, y, score, tag...) of the
    peak in cluster p, zeros where the cluster has none."""
    B, K, M, T = tag_k.shape
    PC = cfg.max_clusters
    group = group_greedy if cfg.assignment == "greedy" else group_hungarian
    cid, n_cl = group(tag_k, val_k, cfg)
    joints = torch.cat([loc_k, val_k[..., None], tag_k], dim=-1)  # (B, K, M, 3+T)
    # slot PC collects the peaks of no cluster and is cut off below
    people = torch.zeros((B, PC + 1, K, 3 + T), dtype=torch.float32, device=tag_k.device)
    slot = torch.where(cid >= 0, cid, PC).long()
    bi = torch.arange(B, device=tag_k.device)[:, None, None].expand(B, K, M)
    ki = torch.arange(K, device=tag_k.device)[None, :, None].expand(B, K, M)
    people.index_put_((bi, slot, ki), joints)
    return people[:, :PC], n_cl


def adjust(people: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Quarter-pixel shift toward the larger neighbour plus the +0.5 centre
    offset, for every joint with score > 0 (reference lib/core/group.py:178-197).

    people (B, P, K, 3+T), det (B, K, H, W)."""
    B, K, H, W = det.shape
    P = people.shape[1]
    x, y, v = people[..., 0], people[..., 1], people[..., 2]  # (B, P, K)
    xi = torch.clamp(x.long(), 0, W - 1)
    yi = torch.clamp(y.long(), 0, H - 1)
    det_flat = det.float().reshape(B, 1, K, H * W).expand(B, P, K, H * W)

    def at(yy, xx):
        idx = torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)
        return torch.gather(det_flat, 3, idx[..., None])[..., 0]

    dx = torch.where(at(yi, xi + 1) > at(yi, xi - 1), 0.25, -0.25)
    dy = torch.where(at(yi + 1, xi) > at(yi - 1, xi), 0.25, -0.25)
    valid = v > 0
    out = people.clone()
    out[..., 0] = torch.where(valid, x + dx + 0.5, x)
    out[..., 1] = torch.where(valid, y + dy + 0.5, y)
    return out


def person_scores(people: torch.Tensor) -> torch.Tensor:
    """Mean joint score per person, bit-equal on the CPU and the card: the
    joints are summed one by one, and the divisor is a tensor, since CUDA
    turns a division by a Python scalar into a product with its reciprocal."""
    v = people[..., 2]
    s = v[..., 0]
    for k in range(1, v.shape[-1]):
        s = s + v[..., k]
    return s / torch.full_like(s, float(v.shape[-1]))


def refine(people: torch.Tensor, det: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """Fill missing joints from the tag-penalized heatmap argmax, person by
    person over whole planes: the plain twin of the JAX reference ``refine``
    (``litepose_tpu/ops/group.py:207-245``), batched, and the oracle of the
    predicated ``ops.refine.refine_batch`` (K4).

    people (B, P, K, 3+T), det (B, K, H, W), tag (B, K, T, H, W); a tag
    in another layout raises ValueError."""
    from .refine import first_argmax, person_mean_tags

    check_tag_layout(det, tag, "thw")
    B, P, K, _ = people.shape
    H, W = det.shape[-2:]
    det = det.float()
    tag = tag.float()
    prev, sel = person_mean_tags(people, tag)  # (B, P, T), (B, P, K)
    det_flat = det.reshape(B * K, H * W)
    bk = torch.arange(B * K, device=det.device)
    out = people.clone()
    for p in range(P):
        d = tag - prev[:, p, None, :, None, None]  # (B, K, T, H, W)
        acc = d[:, :, 0] * d[:, :, 0]
        for t in range(1, d.shape[2]):
            acc = acc + d[:, :, t] * d[:, :, t]
        penal = det - torch.round(sqrt_rn(acc))
        pos = first_argmax(penal.reshape(B * K, H * W))
        py, px = pos // W, pos % W
        val = det_flat[bk, pos]

        def at(yy, xx):
            return det_flat[bk, torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)]

        fx = px.float() + 0.5 + torch.where(at(py, px + 1) > at(py, px - 1), 0.25, -0.25)
        fy = py.float() + 0.5 + torch.where(at(py + 1, px) > at(py - 1, px), 0.25, -0.25)
        kp = people[:, p].reshape(B * K, -1)
        fill = (val > 0) & (kp[:, 2] == 0)
        row = kp.clone()
        row[:, 0] = torch.where(fill, fx, kp[:, 0])
        row[:, 1] = torch.where(fill, fy, kp[:, 1])
        row[:, 2] = torch.where(fill, val, kp[:, 2])
        exists = sel[:, p].any(-1)  # (B,)
        out[:, p] = torch.where(exists[:, None, None], row.reshape(B, K, -1), 0.0)
    return out


def parse_single(det: torch.Tensor, tag: torch.Tensor, cfg: StaticGroupCfg,
                 with_adjust: bool = True, with_refine: bool = True):
    """Decode of one image (counterpart of the JAX ``parse_single``): det
    (K, H, W), tag (K, H, W, T) -> (people (PC, K, 3+T) in heatmap coords,
    scores (PC,), n_people (), int32).

    ``top_k_peaks`` (K5 and the top-M), then the batched decode's steps at
    batch 1: K2 or K3 grouping, adjust, the person scores and K4 (refine).
    It gives what ``parse_batch`` gives for that image.  CUDA tensors launch
    the kernels, CPU tensors run their plain twins."""
    from .nms import top_k_peaks

    tag_k, loc_k, val_k = top_k_peaks(det, tag, cfg.max_people, cfg.nms_kernel,
                                      cfg.nms_padding, cfg.topk_method)
    people, n_cl = match_by_tag_batch(tag_k[None].float(), loc_k[None], val_k[None].float(),
                                      cfg)
    if with_adjust:
        people = adjust(people, det[None])
    scores = person_scores(people)
    if with_refine:
        people = refine_batch(people, det[None], tag.permute(0, 3, 1, 2)[None],
                              tag_layout="thw")
    return people[0], scores[0], n_cl[0]


def parse_batch(det: torch.Tensor, tag: torch.Tensor, cfg: StaticGroupCfg,
                with_adjust: bool = True, with_refine: bool = True, tag_layout: str = "hwt"):
    """Batched decode: det (B, K, H, W), tag (B, K, H, W, T)
    (``tag_layout="hwt"``, the ``core.inference.to_decode_layout`` form and
    JAX's default) or (B, K, T, H, W) (``"thw"``, the layout of
    ``make_infer_fn``, which the engine passes) -> (people (B, PC, K, 3+T)
    in heatmap coords, scores (B, PC), n_people (B,)).

    K1 (NMS + top-M), then K2 (greedy) or K3 (Hungarian) grouping, adjust,
    the person scores (after adjust, before refine, as the reference takes
    them) and K4 (refine).  CUDA tensors launch the kernels, CPU tensors
    run their plain twins."""
    if cfg.nms_padding != cfg.nms_kernel // 2:
        raise ValueError("the fused NMS + top-M assumes nms_padding == nms_kernel // 2")
    check_tag_layout(det, tag, tag_layout)
    if tag_layout == "hwt":  # one transpose for K1's gather and K4
        tag = tag.permute(0, 1, 4, 2, 3).contiguous()
    tag_k, loc_k, val_k = top_k_peaks_batch(det, tag, cfg.max_people, cfg.nms_kernel,
                                            tag_layout="thw")
    people, n_cl = match_by_tag_batch(tag_k, loc_k, val_k, cfg)
    if with_adjust:
        people = adjust(people, det)
    scores = person_scores(people)
    if with_refine:
        people = refine_batch(people, det, tag, tag_layout="thw")
    return people, scores, n_cl
