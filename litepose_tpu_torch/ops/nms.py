"""Heatmap NMS and exact top-M, plain PyTorch (counterpart of ``ops/nms.py``).

Together these are the twin of the fused NMS + top-M kernel (K1,
``ops/topk.py``): the CPU path runs them, and the kernel is held against
them bit for bit on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def heatmap_nms(det: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Suppress non-local-maxima of ``det`` (..., H, W), in fp32.

    torch ``MaxPool2d(kernel, 1, kernel // 2)`` equality: out-of-plane cells
    count as -inf; a pixel keeps its value when it equals its window max,
    otherwise it becomes +0.  bf16 input is upcast first, as the TPU kernel
    does (``litepose_tpu/ops/pallas_topk.py:56``)."""
    x = det.float()
    h, w = x.shape[-2:]
    flat = x.reshape(-1, 1, h, w)
    mx = F.max_pool2d(flat, kernel, stride=1, padding=kernel // 2)
    return torch.where(mx == flat, flat, torch.zeros_like(flat)).reshape(x.shape)


def top_m(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``m`` over the last axis: values descending, ties to the
    lowest index (``lax.top_k`` order).  A stable descending sort, never
    ``torch.topk``, whose tie order on CUDA is unspecified."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :m].contiguous(), idx[..., :m].to(torch.int32).contiguous()
