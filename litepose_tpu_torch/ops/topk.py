"""Fused NMS + exact top-M peak extraction (K1 and K1'; counterpart of
``litepose_tpu/ops/pallas_topk.py``).

``nms_topk`` launches ``csrc/nms_topk.cu`` (K1, row bands and a merge) for a
CUDA tensor, or with ``_gather="sum"`` / ``"dot"`` ``csrc/nms_topk_loop.cu``
(K1', the per-plane loop over a row-max vector that the JAX package keeps as
K1's baseline; no config selects it), and runs the plain twin
``nms_topk_ref`` for a CPU tensor; ``top_k_peaks_batch`` adds the tag
gather and the x/y decode around K1.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

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
    ``nms_topk.launches``; ``"sum"`` and ``"dot"`` K1', counted by
    ``nms_topk.loop_launches``.  On the TPU "dot" picked a row by an MXU
    product that is not exact; the card has no such pass, so both run the
    same exact kernel."""
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
    if det.device.type == "cpu":
        return nms_topk_ref(det, max_people, nms_kernel)
    if det.device.type != "cuda":
        raise ValueError(f"nms_topk runs on cpu or cuda, not {det.device}")
    if not det.is_contiguous():
        raise ValueError("det must be contiguous")
    if _gather != "vec":
        return _nms_topk_loop(det, max_people, nms_kernel // 2)
    if B * K > 65535:
        raise ValueError(f"the K1 kernel takes at most 65535 planes, got {B * K}")

    from ..kernels import build

    lib = build.load()
    r = nms_kernel // 2
    n_bands = lib.lp_nms_topk_bands(H, W, max_people, r)
    if n_bands < 0:
        widest, keys, max_m = (ctypes.c_int() for _ in range(3))
        lib.lp_nms_topk_limits(r, ctypes.byref(widest), ctypes.byref(keys), ctypes.byref(max_m))
        if n_bands == -1:
            raise ValueError(f"plane width {W} exceeds the widest the K1 kernel takes for "
                             f"nms_kernel={nms_kernel}: {widest.value} (a band of one row "
                             f"and its halo in shared memory)")
        raise ValueError(f"{H}x{W} planes with max_people={max_people} exceed the K1 "
                         f"kernel's merge of {keys.value} band keys a plane "
                         f"(max_people <= {max_m.value})")
    val = torch.empty((B, K, max_people), dtype=torch.float32, device=det.device)
    pos = torch.empty((B, K, max_people), dtype=torch.int32, device=det.device)
    if B * K:
        band_keys = torch.empty((B * K, n_bands, max_people), dtype=torch.int64,
                                device=det.device)
        stream = torch.cuda.current_stream(det.device).cuda_stream
        err = lib.lp_nms_topk(
            det.data_ptr(), int(det.dtype == torch.bfloat16), band_keys.data_ptr(),
            val.data_ptr(), pos.data_ptr(), B * K, H, W, max_people, r, stream)
        build.check(err, "nms_topk")
        nms_topk.launches += 1
    return val, pos


def _nms_topk_loop(det: torch.Tensor, max_people: int, r: int):
    """K1' on a contiguous CUDA ``det`` (checked by ``nms_topk``)."""
    from ..kernels import build

    lib = build.load()
    B, K, H, W = det.shape
    if lib.lp_nms_topk_loop_smem(H, W, max_people, r) < 0:
        raise ValueError(f"{H}x{W} planes exceed the shared memory of the K1' kernel's "
                         f"CTA (H row keys and 8 rows of W + {2 * r} floats)")
    val = torch.empty((B, K, max_people), dtype=torch.float32, device=det.device)
    pos = torch.empty((B, K, max_people), dtype=torch.int32, device=det.device)
    if B * K:
        stream = torch.cuda.current_stream(det.device).cuda_stream
        err = lib.lp_nms_topk_loop(det.data_ptr(), int(det.dtype == torch.bfloat16),
                                   val.data_ptr(), pos.data_ptr(), B * K, H, W, max_people, r,
                                   stream)
        build.check(err, "nms_topk (K1')")
        nms_topk.loop_launches += 1
    return val, pos


nms_topk.launches = 0
nms_topk.loop_launches = 0


def top_k_peaks_batch(det: torch.Tensor, tag: torch.Tensor, max_people: int,
                      nms_kernel: int = 5):
    """Batched peaks: det (B, K, H, W), tag (B, K, T, H, W) (the "thw"
    decode layout) -> (tag_k (B, K, M, T) f32, loc_k (B, K, M, 2) f32 x/y,
    val_k (B, K, M) f32).  Counterpart of ``pallas_topk.top_k_peaks_batch``
    with ``tag_layout="thw"``."""
    B, K, H, W = det.shape
    T = tag.shape[2]
    val_k, pos = nms_topk(det, max_people, nms_kernel)
    ind = pos.long()
    tag_k = torch.gather(
        tag.reshape(B, K, T, H * W), 3,
        ind[:, :, None, :].expand(B, K, T, max_people),
    ).permute(0, 1, 3, 2).float().contiguous()
    loc_k = torch.stack([(ind % W).float(), (ind // W).float()], dim=3)
    return tag_k, loc_k, val_k
