"""Stage aggregation and flip test, NCHW (counterpart of
``litepose_tpu/core/inference.py``).

``make_infer_fn`` builds ``infer(images_u8) -> (det, tag)``: ImageNet
normalization, the forward pass (plus the mirrored forward under flip
test), bilinear upsampling of the non-final stages, heatmap averaging, tag
collection and the optional projection.  It returns the decode layout of
the JAX ``make_infer_fn(decode_layout=True)``: det (B, J, H, W) and tag
(B, J, T, H, W).  ``to_decode_layout`` turns the JAX NHWC aggregation
layout into the "hwt" one, det (B, J, H, W) and tag (B, J, H, W, T), which
``ops.group.parse_batch(..., tag_layout="hwt")`` and, image by image,
``ops.group.parse_single`` take.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class InferenceFlags(NamedTuple):
    """Decode-time configuration (mirror of the JAX ``InferenceFlags``;
    projection is the engine's ``EngineConfig.project2image``).

    decode_bf16: aggregate, upsample and decode in bf16 (serving).
    flip_mode: "concat" runs one forward over the 2B batch [x; flip(x)];
    "twopass" runs the plain and the mirrored forward one after the other.
    Both give the same maps."""

    num_joints: int
    with_heatmaps_loss: Tuple[bool, ...]
    with_ae_loss: Tuple[bool, ...]
    test_with_heatmaps: Tuple[bool, ...]
    test_with_ae: Tuple[bool, ...]
    tag_per_joint: bool = True
    flip_test: bool = False
    flip_index: Tuple[int, ...] = ()
    ignore_center: bool = False
    decode_bf16: bool = False
    flip_mode: str = "concat"

    @staticmethod
    def from_config(cfg, flip_index: Sequence[int]) -> "InferenceFlags":
        """The experiment config's decode flags (the JAX ``from_config``;
        ``TEST.PROJECT2IMAGE`` goes to ``EngineConfig`` here)."""
        return InferenceFlags(
            num_joints=cfg.DATASET.NUM_JOINTS,
            with_heatmaps_loss=tuple(cfg.LOSS.WITH_HEATMAPS_LOSS),
            with_ae_loss=tuple(cfg.LOSS.WITH_AE_LOSS),
            test_with_heatmaps=tuple(cfg.TEST.WITH_HEATMAPS),
            test_with_ae=tuple(cfg.TEST.WITH_AE),
            tag_per_joint=cfg.MODEL.TAG_PER_JOINT,
            flip_test=cfg.TEST.FLIP_TEST,
            flip_index=tuple(flip_index),
            ignore_center=bool(cfg.DATASET.WITH_CENTER and cfg.TEST.IGNORE_CENTER),
        )


def device_constant(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, copied to ``device`` once: a fresh host copy
    per call would make the host wait for the card's queue.  Under tracing
    (``torch.export``) it is made anew, so the cache never holds a fake
    tensor and the program gets the constant as its own."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=dtype).to(device)
    return _cached_constant(values, dtype, device)


@functools.lru_cache(maxsize=None)
def _cached_constant(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype).to(device)


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> ImageNet-normalized (B, 3, H, W) in
    ``dtype``: ``x * (1 / (255 std)) + (-mean / std)``, the constants
    computed in float64 and rounded to fp32 as the JAX package does."""
    std = np.asarray(IMAGENET_STD, np.float64)
    scale = tuple((1.0 / (255.0 * std)).astype(np.float32).tolist())
    bias = tuple((-np.asarray(IMAGENET_MEAN, np.float64) / std).astype(np.float32).tolist())
    scale = device_constant(scale, dtype, images.device)
    bias = device_constant(bias, dtype, images.device)
    x = images.permute(0, 3, 1, 2).to(dtype)
    return (x * scale[:, None, None] + bias[:, None, None]).contiguous()


def _antialias_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``jax._src.image.scale.compute_weight_mat``): the
    triangle kernel widened by in/out when downsampling, each column
    normalized to sum 1, columns sampled outside the input zeroed."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale
              - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) bilinear resize with half-pixel centres, as the JAX
    package's ``jax.image.resize(..., "bilinear")``.  Upsampling is
    ``F.interpolate``; a downsampled axis takes JAX's antialiasing (a
    triangle kernel widened by the ratio, which ``F.interpolate`` does not
    apply), as two weight-matrix products."""
    h, w = x.shape[-2:]
    if hw[0] >= h and hw[1] >= w:
        return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)
    wh = _antialias_weights(h, hw[0], x.device).to(x.dtype)
    ww = _antialias_weights(w, hw[1], x.device).to(x.dtype)
    return torch.matmul(wh.t(), torch.matmul(x, ww))


def _collect(outputs: Sequence[torch.Tensor], flags: InferenceFlags):
    """Upsample non-final stages, average heatmaps, gather tag maps (NCHW)."""
    final_hw = outputs[-1].shape[2:4]
    heat_sum = None
    n_heat = 0
    tags: List[torch.Tensor] = []
    for i, out in enumerate(outputs):
        if flags.decode_bf16:
            out = out.to(torch.bfloat16)
        if len(outputs) > 1 and i != len(outputs) - 1:
            out = resize_bilinear(out, final_hw)
        offset = flags.num_joints if flags.with_heatmaps_loss[i] else 0
        if flags.with_heatmaps_loss[i] and flags.test_with_heatmaps[i]:
            hm = out[:, :flags.num_joints]
            heat_sum = hm if heat_sum is None else heat_sum + hm
            n_heat += 1
        if flags.with_ae_loss[i] and flags.test_with_ae[i]:
            tags.append(out[:, offset:])
    heat = heat_sum / n_heat if n_heat else None
    return heat, tags


def make_infer_fn(apply_fn: Callable[[torch.Tensor], List[torch.Tensor]],
                  flags: InferenceFlags,
                  project_hw: Optional[Tuple[int, int]] = None) -> Callable:
    """``apply_fn(x)`` maps normalized (B, 3, H, W) images to the model's
    list of NCHW stage outputs.  Returns ``infer(images_u8)``: uint8
    (B, H, W, 3) -> (det (B, J, H', W'), tag (B, J, T, H', W')), with flip
    test and projection folded in."""

    def infer(images_u8: torch.Tensor):
        x = normalize_images(
            images_u8, torch.bfloat16 if flags.decode_bf16 else torch.float32)
        if flags.flip_test and flags.flip_mode == "concat":
            b = x.shape[0]
            out2 = apply_fn(torch.cat([x, x.flip(3)], 0))
            outputs = [o[:b] for o in out2]
            outputs_f = [o[b:] for o in out2]
        else:
            outputs = apply_fn(x)
            outputs_f = apply_fn(x.flip(3)) if flags.flip_test else None
        heat, tags = _collect(outputs, flags)

        if flags.flip_test:
            fidx = device_constant(tuple(flags.flip_index), torch.long, heat.device)
            heat_f, tags_f = _collect([o.flip(3) for o in outputs_f], flags)
            heat_f = heat_f.index_select(1, fidx)
            if flags.tag_per_joint:
                tags_f = [t.index_select(1, fidx) for t in tags_f]
            heat = (heat + heat_f) / 2.0
            tags = tags + tags_f

        if flags.ignore_center:
            heat = heat[:, :-1]
            tags = [t[:, :-1] for t in tags]

        # stack the T tag sets at the low resolution, then resize once
        tag = torch.stack(tags, dim=2)  # (B, J, T, h, w)
        if project_hw is not None:
            heat = resize_bilinear(heat, project_hw)
            n, j, t = tag.shape[:3]
            tag = resize_bilinear(tag.reshape(n, j * t, *tag.shape[3:]),
                                  project_hw).reshape(n, j, t, *project_hw)
        return heat.contiguous(), tag.contiguous()

    return infer


def to_decode_layout(heat: torch.Tensor, tag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NHWC aggregation layout, heat (B, H, W, J) and tag (B, H, W, J,
    T), as the "hwt" decode layout: det (B, J, H, W) and tag (B, J, H, W,
    T), contiguous (counterpart of the JAX ``to_decode_layout``)."""
    return (heat.permute(0, 3, 1, 2).contiguous(), tag.permute(0, 3, 1, 2, 4).contiguous())
