"""Heatmap NMS, exact top-M and the per-image peaks (counterpart of
``litepose_tpu/ops/nms.py`` and ``litepose_tpu/ops/pallas_nms.py``).

``heatmap_nms`` and ``top_m`` together are the twin of the fused NMS + top-M
kernel (K1, ``ops/topk.py``): the CPU path runs them, and the kernel is held
against them bit for bit on the card.  ``nms_suppress`` launches K5
(``csrc/heatmap_nms.cu``, the suppressed map in the input's dtype) for a
CUDA tensor and runs its twin ``nms_suppress_ref`` for a CPU tensor, both
through the registered op ``torch.ops.litepose.heatmap_nms``
(``ops/library.py``); ``top_k_peaks`` is the per-image decode around K5
that the JAX package runs on its ``top_k_peaks`` path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import library  # also registers torch.ops.litepose.*


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


def nms_suppress_ref(det: torch.Tensor, nms_kernel: int = 5) -> torch.Tensor:
    """Plain twin of K5: ``heatmap_nms`` in fp32, returned in ``det``'s
    dtype (exact: a kept value is an element of ``det``, the rest +0)."""
    return heatmap_nms(det, nms_kernel).to(det.dtype)


def nms_suppress(det: torch.Tensor, nms_kernel: int = 5) -> torch.Tensor:
    """Suppress the non-local-maxima of ``det`` (..., H, W), fp32 or bf16,
    in its own dtype: the function of the TPU kernel ``heatmap_nms_pallas``
    (``litepose_tpu/ops/pallas_nms.py``), with -inf outside the plane where
    that kernel pads with -3e38.

    A CPU tensor takes the plain twin; a CUDA tensor launches K5, counted
    by ``nms_suppress.launches`` (windows up to 15)."""
    if det.dim() < 2:
        raise ValueError(f"det must be (..., H, W), got {tuple(det.shape)}")
    if det.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"det must be float32 or bfloat16, got {det.dtype}")
    if nms_kernel < 1 or nms_kernel % 2 == 0:
        raise ValueError(f"nms_kernel must be odd, got {nms_kernel}")
    if det.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_suppress runs on cpu or cuda, not {det.device}")
    H, W = det.shape[-2:]
    out = library.call("heatmap_nms", det.reshape(-1, H, W).contiguous(), nms_kernel)
    return out.reshape(det.shape)


nms_suppress.launches = 0


def top_k_peaks(det: torch.Tensor, tag: torch.Tensor, max_people: int, nms_kernel: int = 5,
                nms_padding: int = 2, method: str = "exact"):
    """Per-joint top-M peaks with their tags, one image (the JAX
    ``top_k_peaks`` on its TPU path: K5, then the top-M).

    det (K, H, W) fp32 or bf16, tag (K, H, W, T) -> (tag_k (K, M, T) in
    ``tag``'s dtype, loc_k (K, M, 2) f32 x/y, val_k (K, M) in ``det``'s
    dtype).  The top-M is ``top_m``: values descending, ties to the lowest
    flat index, -0.0 equal to +0.0, as K1 orders them (``lax.top_k`` puts
    +0.0 first).  ``method="approx"`` runs the same exact top-M
    (``ops.group.StaticGroupCfg``).  ``nms_padding`` must be
    ``nms_kernel // 2``: the JAX path fails on shapes with any other."""
    if method not in ("exact", "approx"):
        raise ValueError(f"method must be 'exact' or 'approx', got {method!r}")
    if nms_padding != nms_kernel // 2:
        raise ValueError(f"nms_padding {nms_padding} must be nms_kernel // 2 = "
                         f"{nms_kernel // 2}")
    if det.dim() != 3 or tag.dim() != 4 or tag.shape[:3] != det.shape:
        raise ValueError(f"expected det (K, H, W) and tag (K, H, W, T), got "
                         f"{tuple(det.shape)} and {tuple(tag.shape)}")
    K, H, W = det.shape
    T = tag.shape[3]
    if not 0 < max_people <= H * W:
        raise ValueError(f"max_people {max_people} not in [1, {H * W}]")
    val_k, pos = top_m(nms_suppress(det, nms_kernel).reshape(K, H * W), max_people)
    ind = pos.long()
    tag_k = torch.gather(tag.reshape(K, H * W, T), 1, ind[..., None].expand(K, max_people, T))
    loc_k = torch.stack([(ind % W).float(), (ind // W).float()], dim=2)
    return tag_k, loc_k, val_k
