"""PoseEngine: uint8 images -> people (counterpart of
``litepose_tpu/core/engine.py``, one device).

A batch runs normalization, the forward pass (with flip test), stage
aggregation, the projection to the input size and the decode on the
engine's device: NMS + top-M peaks (kernel K1), greedy (K2) or exact
Hungarian (K3) grouping, adjust, the person scores and refine (K4).  Only
the fixed-size people arrays come back to the host.

- ``process_batch_square``: serving, images already resized to a square.
- ``process``: the eval protocol for one image of any size: warp onto the
  64-px resize ladder, single- or multi-scale, people in source-image
  coordinates.
- ``process_indexed`` / ``process_many``: the same for many images,
  bucketed by warped shape and run in batches, the host's warps of the
  next batch overlapping the card's work on the current one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.affine import (get_affine_transform, get_final_preds,
                           get_multi_scale_size, warp_image)
from ..ops.group import GroupParams, StaticGroupCfg, parse_batch
from .inference import InferenceFlags, make_infer_fn, resize_bilinear


@dataclasses.dataclass
class EngineConfig:
    """Mirror of the JAX ``EngineConfig``, with its eval defaults: exact
    Hungarian grouping, adjust, refine and projection.  Serving sets
    assignment="greedy", topk_method="approx", no adjust, refine or
    projection, and decode_bf16."""

    input_size: int = 448
    scale_factors: Tuple[float, ...] = (1.0,)
    with_adjust: bool = True
    with_refine: bool = True
    project2image: bool = True
    assignment: str = "hungarian"  # or "greedy"
    topk_method: str = "exact"  # or "approx"; both run exact top-M here
    decode_bf16: bool = False


Result = Tuple[List[np.ndarray], List[float]]


class PoseEngine:
    """Batched pose estimation on one device.

    Args:
      apply_fn: ``(B, 3, H, W) normalized images -> [NCHW stage outputs]``,
        for example a ``LitePose`` in eval mode, already on ``device``.
      flags: stage aggregation and flip-test configuration.
      group: decode thresholds and joint order.
      config: EngineConfig.
      device: where the batch runs, the card unless the caller names
        another: CUDA launches the kernels, ``device="cpu"`` runs their
        plain twins.  A CUDA device without a card raises here.
    """

    def __init__(self, apply_fn: Callable[[torch.Tensor], List[torch.Tensor]],
                 flags: InferenceFlags, group: GroupParams,
                 config: EngineConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoseEngine: no CUDA device; pass device=\"cpu\" to run "
                               "the plain twins on the host")
        self.apply_fn = apply_fn
        if config.decode_bf16:
            flags = flags._replace(decode_bf16=True)
        self.flags = flags
        self.group_cfg = StaticGroupCfg.from_params(
            group, assignment=config.assignment, topk_method=config.topk_method)
        self.config = config
        self._infer: Dict[Tuple[Tuple[int, int], Optional[Tuple[int, int]]], Callable] = {}

    def infer_fn(self, in_hw: Tuple[int, int],
                 out_hw: Optional[Tuple[int, int]]) -> Callable:
        key = (in_hw, out_hw)
        if key not in self._infer:
            self._infer[key] = make_infer_fn(self.apply_fn, self.flags, project_hw=out_hw)
        return self._infer[key]

    def _upload(self, images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[3] != 3:
            raise ValueError(f"expected uint8 images (B, H, W, 3), got {x.dtype} "
                             f"{tuple(x.shape)}")
        return x.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _maps(self, images_u8, project: bool):
        """uint8 (B, H, W, 3) -> det (B, J, h, w), tag (B, J, T, h, w) on the
        device; projected to (H, W) when ``project``."""
        x = self._upload(images_u8)
        hw = (int(x.shape[1]), int(x.shape[2]))
        return self.infer_fn(hw, hw if project else None)(x)

    @torch.inference_mode()
    def _decode(self, det: torch.Tensor, tag: torch.Tensor):
        return parse_batch(det, tag, self.group_cfg, self.config.with_adjust,
                           self.config.with_refine)

    def run_batch(self, images_u8):
        """uint8 (B, H, W, 3) images -> (det, tag, people, scores, counts),
        all on the engine's device: det (B, J, h, w), tag (B, J, T, h, w),
        people (B, P, K, 3+T) in heatmap coordinates (the maps are projected
        to (H, W) when ``project2image``)."""
        det, tag = self._maps(images_u8, self.config.project2image)
        return (det, tag) + tuple(self._decode(det, tag))

    def process_batch_square(self, images_u8):
        """Serving path: a batch of images pre-resized to the square
        ``input_size``.  Returns numpy (people (B, P, K, 3+T) in heatmap
        coordinates, scores (B, P), counts (B,)); callers map coordinates
        with their own inverse affines."""
        size = self.config.input_size
        shape = tuple(np.shape(images_u8))
        if len(shape) != 4 or shape[1:] != (size, size, 3):
            raise ValueError(f"expected images (B, {size}, {size}, 3), got {shape}")
        _, _, people, scores, n = self.run_batch(images_u8)
        return people.cpu().numpy(), scores.cpu().numpy(), n.cpu().numpy()

    # -- the eval protocol ----------------------------------------------------

    def _ladder(self, image_hw: Tuple[int, int], scale_factor: float):
        """((w, h) on the 64-px resize ladder, center, scale) of an image of
        ``image_hw`` at ``scale_factor``."""
        return get_multi_scale_size(image_hw, self.config.input_size, scale_factor,
                                    min(self.config.scale_factors))

    def _warp(self, image: np.ndarray, scale_factor: float):
        """Warp onto the resize ladder: (warped image, center, scale)."""
        size, center, scale = self._ladder(image.shape[:2], scale_factor)
        mat = get_affine_transform(center, scale, 0, size)
        return warp_image(image, mat, size), center, scale

    @staticmethod
    def _finalize_one(people: np.ndarray, scores: np.ndarray, n: int, center,
                      scale, hm_hw: Tuple[int, int]) -> Result:
        """The first n people, mapped from the (h, w) heatmap grid back to
        source-image coordinates."""
        people, scores = people[:n], scores[:n].tolist()
        return get_final_preds(people, center, scale, (hm_hw[1], hm_hw[0])), scores

    def process(self, image_rgb_u8: np.ndarray) -> Result:
        """Multi-scale + flip eval of one image (reference ``valid.py``
        semantics).  Returns (people: list of (K, 3+T) arrays in source
        coordinates, scores)."""
        scales = sorted(self.config.scale_factors, reverse=True)
        if scales == [1.0]:
            img, center, scale = self._warp(image_rgb_u8, 1.0)
            det, _, people, scores, n = self.run_batch(img[None])
            return self._finalize_one(people[0].cpu().numpy(), scores[0].cpu().numpy(),
                                      int(n[0]), center, scale, tuple(det.shape[-2:]))
        if 1.0 not in scales:
            raise ValueError(f"multi-scale eval takes its tags at scale 1.0, "
                             f"got scales {scales}")

        # heatmaps accumulate over the scales, tags come from scale 1.  With
        # projection every scale is already at the base size; without it the
        # first (largest) scale's grid is the accumulation grid (reference
        # aggregate_results)
        base, _, _ = self._ladder(image_rgb_u8.shape[:2], 1.0)
        project_hw = (int(base[1]), int(base[0])) if self.config.project2image else None
        accum_hw = project_hw
        heat_sum = tag_keep = None
        with torch.inference_mode():
            for s in scales:
                img, center, scale = self._warp(image_rgb_u8, s)
                heat, tag = self.infer_fn(img.shape[:2], project_hw)(self._upload(img[None]))
                if accum_hw is None:
                    accum_hw = tuple(heat.shape[-2:])
                if tuple(heat.shape[-2:]) != accum_hw:
                    heat = resize_bilinear(heat, accum_hw)
                heat_sum = heat if heat_sum is None else heat_sum + heat
                if s == 1.0:
                    if tuple(tag.shape[-2:]) != accum_hw:
                        n, j, t = tag.shape[:3]
                        tag = resize_bilinear(tag.reshape(n, j * t, *tag.shape[3:]),
                                              accum_hw).reshape(n, j, t, *accum_hw)
                    tag_keep = tag
            heat = heat_sum / torch.full((), float(len(scales)), device=heat_sum.device)
        people, scores, n = self._decode(heat, tag_keep)
        return self._finalize_one(people[0].cpu().numpy(), scores[0].cpu().numpy(),
                                  int(n[0]), center, scale, accum_hw)

    def process_indexed(self, shapes: Sequence[Tuple[int, int]],
                        load_fn: Callable[[int], np.ndarray],
                        batch_size: int = 16,
                        progress_cb: Optional[Callable[[int], None]] = None) -> List[Result]:
        """The eval protocol over many images of any size, loaded lazily.

        The whole index set is bucketed by warped shape up front, from
        ``shapes`` alone ((height, width) per image); each bucket runs in
        ``batch_size`` chunks, only its last chunk zero-padded, so a bucket
        keeps one batch shape.  ``load_fn(i)`` is called once per image when
        its batch is assembled.  The drive is double-buffered: batch k is
        launched, batch k+1 is warped on the host while the card works, and
        only then are batch k's people copied back.  Per-image results equal
        :meth:`process`.  Multi-scale configurations run image by image.

        Returns ``(people, scores)`` per image, in input order."""
        if tuple(self.config.scale_factors) != (1.0,):
            out = []
            for i in range(len(shapes)):
                out.append(self.process(load_fn(i)))
                if progress_cb is not None:
                    progress_cb(i + 1)
            return out

        metas = []
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, src_hw in enumerate(shapes):
            size, center, scale = self._ladder(tuple(src_hw), 1.0)
            metas.append((size, center, scale))
            buckets.setdefault((int(size[1]), int(size[0])), []).append(i)

        results: List[Optional[Result]] = [None] * len(shapes)
        done = 0
        pin = self.device.type == "cuda"

        def drain(pending) -> int:
            chunk, people, scores, n, hm_hw = pending
            people, scores, n = people.cpu().numpy(), scores.cpu().numpy(), n.cpu().numpy()
            for j, i in enumerate(chunk):
                _, center, scale = metas[i]
                results[i] = self._finalize_one(people[j], scores[j], int(n[j]),
                                                center, scale, hm_hw)
            return len(chunk)

        pending = None
        for hw, idxs in buckets.items():
            for lo in range(0, len(idxs), batch_size):
                chunk = idxs[lo:lo + batch_size]
                # pinned host memory: the upload does not wait for the card
                batch = torch.zeros((batch_size, hw[0], hw[1], 3), dtype=torch.uint8,
                                    pin_memory=pin)
                view = batch.numpy()
                for j, i in enumerate(chunk):
                    size, center, scale = metas[i]
                    mat = get_affine_transform(center, scale, 0, size)
                    view[j] = warp_image(load_fn(i), mat, size)
                det, _, people, scores, n = self.run_batch(batch)
                if pending is not None:
                    done += drain(pending)
                    if progress_cb is not None:
                        progress_cb(done)
                pending = (chunk, people, scores, n, tuple(det.shape[-2:]))
        if pending is not None:
            done += drain(pending)
            if progress_cb is not None:
                progress_cb(done)
        return results

    def process_many(self, images: Sequence[np.ndarray], batch_size: int = 16,
                     progress_cb: Optional[Callable[[int], None]] = None) -> List[Result]:
        """:meth:`process_indexed` over an in-memory list of images."""
        return self.process_indexed([img.shape[:2] for img in images],
                                    lambda i: images[i], batch_size=batch_size,
                                    progress_cb=progress_cb)
