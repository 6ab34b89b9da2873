"""PoseEngine: uint8 images -> people, the serving path (counterpart of
``litepose_tpu/core/engine.py``, ``process_batch_square`` only).

One batch runs normalization, the forward pass, stage aggregation, NMS +
top-M peaks (kernel K1) and greedy associative-embedding grouping (kernel
K2) on the engine's device; only the fixed-size people arrays come back to
the host.  The eval entry points (``process``, ``process_indexed``,
``process_many``) and multi-device serving come with the eval slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.group import GroupParams, StaticGroupCfg, parse_batch
from .inference import InferenceFlags, make_infer_fn


@dataclasses.dataclass
class EngineConfig:
    """Mirror of the JAX ``EngineConfig`` without multi-scale.  Serving
    sets topk_method="approx", no adjust, refine or projection, and
    decode_bf16.  The eval defaults of the JAX package (exact Hungarian
    assignment, refine) need kernels K3 and K4, which are not ported yet."""

    input_size: int = 448
    with_adjust: bool = True
    with_refine: bool = False
    project2image: bool = True
    assignment: str = "greedy"
    topk_method: str = "exact"  # or "approx"; both run exact top-M here
    decode_bf16: bool = False


class PoseEngine:
    """Batched pose estimation on one device.

    Args:
      apply_fn: ``(B, 3, H, W) normalized images -> [NCHW stage outputs]``,
        for example a ``LitePose`` in eval mode, already on ``device``.
      flags: stage aggregation and flip-test configuration.
      group: decode thresholds and joint order.
      config: EngineConfig.
      device: where the batch runs; CUDA launches the kernels, CPU runs
        their plain twins.
    """

    def __init__(self, apply_fn: Callable[[torch.Tensor], List[torch.Tensor]],
                 flags: InferenceFlags, group: GroupParams,
                 config: EngineConfig, device="cpu"):
        self.apply_fn = apply_fn
        if config.decode_bf16:
            flags = flags._replace(decode_bf16=True)
        self.flags = flags
        self.group_cfg = StaticGroupCfg.from_params(
            group, assignment=config.assignment, topk_method=config.topk_method)
        self.config = config
        self.device = torch.device(device)
        self._infer: Dict[Tuple[Tuple[int, int], Optional[Tuple[int, int]]], Callable] = {}

    def infer_fn(self, in_hw: Tuple[int, int],
                 out_hw: Optional[Tuple[int, int]]) -> Callable:
        key = (in_hw, out_hw)
        if key not in self._infer:
            self._infer[key] = make_infer_fn(self.apply_fn, self.flags, project_hw=out_hw)
        return self._infer[key]

    @torch.inference_mode()
    def run_batch(self, images_u8):
        """(B, S, S, 3) uint8 images, S = ``input_size`` -> (det, tag,
        people, scores, counts), all on the engine's device: det
        (B, J, h, w), tag (B, J, T, h, w), people (B, P, K, 3+T) in heatmap
        coordinates."""
        x = torch.as_tensor(images_u8)
        size = self.config.input_size
        if x.dtype != torch.uint8 or x.dim() != 4 or tuple(x.shape[1:]) != (size, size, 3):
            raise ValueError(f"expected uint8 images (B, {size}, {size}, 3), got "
                             f"{x.dtype} {tuple(x.shape)}")
        x = x.to(self.device, non_blocking=True)
        hw = (size, size)
        project_hw = hw if self.config.project2image else None
        det, tag = self.infer_fn(hw, project_hw)(x)
        people, scores, n = parse_batch(det, tag, self.group_cfg,
                                        self.config.with_adjust,
                                        self.config.with_refine)
        return det, tag, people, scores, n

    def process_batch_square(self, images_u8):
        """Serving path: a batch of images pre-resized to the square
        ``input_size``.  Returns numpy (people (B, P, K, 3+T) in heatmap
        coordinates, scores (B, P), counts (B,)); callers map coordinates
        with their own inverse affines."""
        _, _, people, scores, n = self.run_batch(images_u8)
        return people.cpu().numpy(), scores.cpu().numpy(), n.cpu().numpy()
