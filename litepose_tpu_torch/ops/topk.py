"""Fused NMS + exact top-M peak extraction (K1 and K1'; counterpart of
``litepose_tpu/ops/pallas_topk.py``).

``nms_topk`` launches ``csrc/nms_topk.cu`` (K1, row bands and a merge) for a
CUDA tensor, or with ``_gather="sum"`` / ``"dot"`` ``csrc/nms_topk_loop.cu``
(K1', the per-plane serial extraction over the plane's row keys that the JAX
package keeps as K1's baseline, each plane's rounds in one warp over the
rows' cached candidates; no config selects it), and runs the plain twin
``nms_topk_ref`` for a CPU tensor, both through the registered ops
``torch.ops.litepose.nms_topk`` / ``nms_topk_loop`` (``ops/library.py``);
``top_k_peaks_batch`` adds the tag gather and the x/y decode around K1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import library  # also registers torch.ops.litepose.*
from .nms import heatmap_nms, top_m


def nms_topk_ref(det: torch.Tensor, max_people: int,
                 nms_kernel: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the K1 kernel: det (B, K, H, W) fp32/bf16 ->
    (val (B, K, M) fp32, pos (B, K, M) int32 flat row-major indices)."""
    B, K, H, W = det.shape
    sup = heatmap_nms(det, nms_kernel).reshape(B, K, H * W)
    return top_m(sup, max_people)


def nms_topk(det: torch.Tensor, max_people: int, nms_kernel: int = 5,
             _gather: str = "vec") -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS + exact top-M of every (image, joint) plane.

    det (B, K, H, W) fp32 or bf16 -> (val (B, K, M) fp32, pos (B, K, M)
    int32).  Equal to ``heatmap_nms`` + ``lax.top_k`` in the JAX package,
    tie order included.  A CPU tensor takes the plain twin whatever
    ``_gather``; a CUDA tensor launches a kernel: ``"vec"`` (the default,
    JAX's private argument of ``nms_topk_pallas``) K1, counted by
    ``nms_topk.launches``; ``"sum"`` and ``"dot"`` K1' (its staged instance,
    or its lean one for planes too wide or too tall for that; a ValueError
    beyond both), counted by ``nms_topk.loop_launches``.  On the TPU "dot"
    picked a row by an MXU product that is not exact; the card has no such
    pass, so both run the same exact kernel."""
    if _gather not in ("vec", "sum", "dot"):
        raise ValueError(f"_gather must be 'vec', 'sum' or 'dot', got {_gather!r}")
    if det.dim() != 4:
        raise ValueError(f"det must be (B, K, H, W), got {tuple(det.shape)}")
    if det.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"det must be float32 or bfloat16, got {det.dtype}")
    if nms_kernel < 1 or nms_kernel % 2 == 0:
        raise ValueError(f"nms_kernel must be odd, got {nms_kernel}")
    B, K, H, W = det.shape
    if not 0 < max_people <= H * W:
        raise ValueError(f"max_people {max_people} not in [1, {H * W}]")
    if det.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_topk runs on cpu or cuda, not {det.device}")
    return library.call("nms_topk" if _gather == "vec" else "nms_topk_loop", det, max_people,
                        nms_kernel)


nms_topk.launches = 0
nms_topk.loop_launches = 0


def check_tag_layout(det: torch.Tensor, tag: torch.Tensor, tag_layout: str) -> int:
    """The tag dimension T of ``tag`` for maps ``det`` (B, K, H, W): a
    ValueError unless ``tag`` is (B, K, H, W, T) (``tag_layout="hwt"``,
    the ``core.inference.to_decode_layout`` form and JAX's default) or
    (B, K, T, H, W) (``"thw"``, the layout of ``make_infer_fn``, which the
    engine passes) with ``det``'s B, K, H and W."""
    if tag_layout not in ("hwt", "thw"):
        raise ValueError(f"tag_layout must be 'hwt' or 'thw', got {tag_layout!r}")
    if det.dim() != 4:
        raise ValueError(f"det must be (B, K, H, W), got {tuple(det.shape)}")
    B, K, H, W = det.shape
    hwt = tag_layout == "hwt"
    if tag.dim() != 5 or tuple(tag.shape[:2]) != (B, K) \
            or tuple(tag.shape[2:4] if hwt else tag.shape[3:]) != (H, W):
        raise ValueError(f"tag_layout={tag_layout!r} needs tag "
                         f"{'(B, K, H, W, T)' if hwt else '(B, K, T, H, W)'}, got "
                         f"{tuple(tag.shape)} for det {tuple(det.shape)}")
    return int(tag.shape[4] if hwt else tag.shape[2])


def top_k_peaks_batch(det: torch.Tensor, tag: torch.Tensor, max_people: int,
                      nms_kernel: int = 5, tag_layout: str = "hwt"):
    """Batched peaks: det (B, K, H, W), tag (B, K, H, W, T) (``"hwt"``,
    JAX's default) or (B, K, T, H, W) (``"thw"``, the decode layout of the
    engine) -> (tag_k (B, K, M, T) f32, loc_k (B, K, M, 2) f32 x/y, val_k
    (B, K, M) f32).  Counterpart of ``pallas_topk.top_k_peaks_batch``; the
    tags are gathered in their own layout, never copied whole."""
    T = check_tag_layout(det, tag, tag_layout)
    B, K, H, W = det.shape
    val_k, pos = nms_topk(det, max_people, nms_kernel)
    ind = pos.long()
    if tag_layout == "thw":
        tag_k = torch.gather(
            tag.reshape(B, K, T, H * W), 3,
            ind[:, :, None, :].expand(B, K, T, max_people),
        ).permute(0, 1, 3, 2)
    else:
        tag_k = torch.gather(tag.reshape(B, K, H * W, T), 2,
                             ind[..., None].expand(B, K, max_people, T))
    tag_k = tag_k.float().contiguous()
    loc_k = torch.stack([(ind % W).float(), (ind // W).float()], dim=3)
    return tag_k, loc_k, val_k
