"""Training losses, NCHW (counterpart of ``litepose_tpu/core/losses.py``):
masked heatmap MSE and associative-embedding push/pull.

The port's stage outputs are NCHW, so the AE gather index
``k*H*W + y*W + x`` of the dataset's (B, P, K, 2) joint arrays addresses a
plain ``reshape(B, K*H*W)`` of the tag maps, with no transpose.  The
indices arrive as int32 (``data/dataset.py``); ``torch.gather`` takes them
as int64.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


def heatmap_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE per image. pred, gt: (B, K, H, W); mask: (B, H, W).
    Returns (B,)."""
    err = (pred - gt) ** 2 * mask[:, None]
    return err.mean(dim=(1, 2, 3))


def ae_loss(tags: torch.Tensor, joints: torch.Tensor,
            loss_type: str = "exp") -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative-embedding (push, pull) scalars.

    tags: (B, K, H, W) predicted tag maps (one channel per joint).
    joints: (B, P, K, 2) int -- (flat index in the K*H*W layout, vis)."""
    B, K, H, W = tags.shape
    P = joints.shape[1]
    flat = tags.reshape(B, K * H * W)

    vis = joints[..., 1].float()  # (B, P, K)
    loc = joints[..., 0].long().reshape(B, P * K)
    tags = torch.gather(flat, 1, loc).reshape(B, P, K) * vis

    joints_cnt = vis.sum(dim=2, keepdim=True)  # (B, P, 1)
    person_exists = (joints_cnt > 0).float()
    person_cnt = torch.clamp(person_exists.squeeze(2).sum(dim=1, keepdim=True), min=1.0)
    safe_cnt = torch.clamp(joints_cnt, min=1.0)

    # pull: per-person tag variance around the person mean
    mean = tags.sum(dim=2, keepdim=True) / safe_cnt  # (B, P, 1)
    pull = torch.sum(vis * (tags - mean) ** 2, dim=2, keepdim=True) / safe_cnt
    pull = torch.where(joints_cnt > 0, pull, 0.0)
    pull = pull.squeeze(2).sum(dim=1, keepdim=True) / person_cnt
    pull = pull.mean()

    # push: pairwise interaction between person mean tags
    pvis = person_exists.squeeze(2)  # (B, P)
    pair_vis = pvis[:, :, None] * pvis[:, None, :]  # (B, P, P)
    mean_mat = mean.expand(B, P, P)
    diff = (mean_mat - mean_mat.transpose(1, 2)) * pair_vis
    n = person_cnt.squeeze(1)  # (B,)
    if loss_type == "exp":
        d = torch.exp(-(diff ** 2)) * pair_vis
    elif loss_type == "max":
        d = torch.clamp(1.0 - diff.abs(), min=0.0) * pair_vis
    else:
        raise ValueError(f"unknown AE loss type {loss_type!r}")
    denom = torch.clamp((n - 1.0) * n, min=1.0)
    per_img = 0.5 * (d.sum(dim=(1, 2)) - n) / denom
    per_img = torch.where(n < 2, 0.0, per_img)
    return per_img.mean(), pull


class LossConfig(NamedTuple):
    num_joints: int
    num_stages: int = 2
    with_heatmaps: Tuple[bool, ...] = (True, True)
    heatmaps_factor: Tuple[float, ...] = (1.0, 1.0)
    with_ae: Tuple[bool, ...] = (True, False)
    ae_type: str = "exp"
    push_factor: Tuple[float, ...] = (0.001, 0.001)
    pull_factor: Tuple[float, ...] = (0.001, 0.001)

    @staticmethod
    def from_config(cfg) -> "LossConfig":
        return LossConfig(
            num_joints=cfg.MODEL.NUM_JOINTS,
            num_stages=cfg.LOSS.NUM_STAGES,
            with_heatmaps=tuple(cfg.LOSS.WITH_HEATMAPS_LOSS),
            heatmaps_factor=tuple(cfg.LOSS.HEATMAPS_LOSS_FACTOR),
            with_ae=tuple(cfg.LOSS.WITH_AE_LOSS),
            ae_type=cfg.LOSS.AE_LOSS_TYPE,
            push_factor=tuple(cfg.LOSS.PUSH_LOSS_FACTOR),
            pull_factor=tuple(cfg.LOSS.PULL_LOSS_FACTOR),
        )


def multi_loss(outputs: Sequence[torch.Tensor],  # per stage (B, C, R, R)
               heatmaps: Sequence[torch.Tensor],  # per stage (B, K, R, R)
               masks: Sequence[torch.Tensor],  # per stage (B, R, R)
               joints: Sequence[torch.Tensor],  # per stage (B, P, K, 2)
               cfg: LossConfig):
    """Combined scalar loss and the per-stage metric dict
    (``stage{i}_heatmap``, ``stage{i}_push``, ``stage{i}_pull``, ``total``)."""
    assert len(outputs) == cfg.num_stages
    total = 0.0
    metrics = {}
    for i, out in enumerate(outputs):
        offset = 0
        if cfg.with_heatmaps[i]:
            hm = heatmap_loss(out[:, :cfg.num_joints], heatmaps[i], masks[i])
            hm = hm.mean() * cfg.heatmaps_factor[i]
            total = total + hm
            metrics[f"stage{i}_heatmap"] = hm
            offset = cfg.num_joints
        if cfg.with_ae[i]:
            push, pull = ae_loss(out[:, offset:], joints[i], cfg.ae_type)
            push = push * cfg.push_factor[i]
            pull = pull * cfg.pull_factor[i]
            total = total + push + pull
            metrics[f"stage{i}_push"] = push
            metrics[f"stage{i}_pull"] = pull
    metrics["total"] = total
    return total, metrics


def distill_loss(outputs: Sequence[torch.Tensor],
                 teacher_heatmaps: Sequence[torch.Tensor],  # per stage (B, K, R, R)
                 masks: Sequence[torch.Tensor], cfg: LossConfig):
    """Teacher-heatmap MSE added during distillation; the teacher's maps
    are detached."""
    total = 0.0
    for i, out in enumerate(outputs):
        if cfg.with_heatmaps[i]:
            hm = heatmap_loss(out[:, :cfg.num_joints], teacher_heatmaps[i].detach(), masks[i])
            total = total + hm.mean() * cfg.heatmaps_factor[i]
    return total
