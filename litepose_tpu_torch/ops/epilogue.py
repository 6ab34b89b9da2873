"""The epilogue of a folded dense conv + eval BN: the bias, an optional
residual (of the output's shape, or a finer sum the output is
nearest-upsampled into) and the activation (none, ReLU6, ReLU or Swish), as
one kernel (``csrc/conv_epilogue.cu``, K7).

No TPU kernel stands behind it: the JAX package leaves the conv to
``lax.conv_general_dilated`` and the bias, the residual and the activation
to XLA's fusion.  ``conv_epilogue`` launches the kernel for a CUDA tensor,
counted by ``conv_epilogue.launches``, and runs the plain twin
``conv_epilogue_ref`` for a CPU tensor, through the registered op
``torch.ops.litepose.conv_epilogue`` as ``library.call`` calls it.  The
twin is ``unfused``, the sequence the layers run where the kernel does not
(``+ bias.to(dtype)``, then the nearest upsample and ``+ residual``, then
``torch.clamp``, ``torch.relu`` or ``x * torch.sigmoid(x)``), so a CPU
forward keeps its bits; the kernel equals it on the card bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import library  # also registers torch.ops.litepose.*
from .depthwise import ACTS, activation

MAX_SHIFT = 3  # an upsampled residual is 2, 4 or 8 times y's plane


def layout(y: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.memory_format:
    """The memory format the kernel reads ``y`` and ``residual`` in and
    writes its output in: NCHW where both are contiguous (also where a
    size-1 dim makes the two layouts one), else channels-last."""
    if y.is_contiguous() and (residual is None or residual.is_contiguous()):
        return torch.contiguous_format
    return torch.channels_last


def upsample_shift(y: torch.Tensor, residual: torch.Tensor) -> int:
    """k where ``residual`` is (B, C, H << k, W << k) for ``y`` (B, C, H, W)
    and k in 0..3; raises otherwise."""
    if residual.shape == y.shape:
        return 0
    B, C, H, W = y.shape
    if residual.dim() == 4 and tuple(residual.shape[:2]) == (B, C) and H and W:
        for k in range(1, MAX_SHIFT + 1):
            if tuple(residual.shape[2:]) == (H << k, W << k):
                return k
    raise ValueError(f"residual must be y's shape {tuple(y.shape)} or (B, C, H, W) times 2, "
                     f"4 or 8 along H and W, got {tuple(residual.shape)}")


def unfused(y: torch.Tensor, bias: Optional[torch.Tensor], residual: Optional[torch.Tensor],
            act: str) -> torch.Tensor:
    """The epilogue as ATen ops, one pass each: ``bias`` (C), where given,
    cast to ``y``'s dtype and added to ``y`` (B, C, H, W); ``residual``,
    where given, added (``y``'s shape, or 2, 4 or 8 times its plane with
    ``y`` nearest-upsampled to it first, in its memory layout); then
    ``act``."""
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    if residual is not None:
        k = upsample_shift(y, residual)
        y = (F.interpolate(y, scale_factor=1 << k, mode="nearest") if k else y) + residual
    return activation(y, act)


def conv_epilogue_ref(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                      act: str) -> torch.Tensor:
    """Plain twin: ``unfused`` in ``layout(y, residual)``."""
    return unfused(y, bias, residual, act).contiguous(memory_format=layout(y, residual))


def contract(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
             act: str) -> Tuple[torch.memory_format, int]:
    """(layout, k) of arguments in the op's contract (``conv_epilogue``'s);
    raises on anything else."""
    if bias.device != y.device or residual is not None and residual.device != y.device:
        raise ValueError(f"y, bias and residual must lie on one device, got {y.device}, "
                         f"{bias.device} and {None if residual is None else residual.device}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if y.dim() != 4 or bias.dim() != 1 or bias.shape[0] != y.shape[1]:
        raise ValueError(f"expected y (B, C, H, W) and bias (C,), got {tuple(y.shape)} and "
                         f"{tuple(bias.shape)}")
    if y.dtype is not torch.bfloat16 or bias.dtype not in (torch.float32, torch.bfloat16) or (
            residual is not None and residual.dtype is not torch.bfloat16):
        raise TypeError(f"expected bf16 y and residual and an fp32 or bf16 bias, got "
                        f"{y.dtype}, {None if residual is None else residual.dtype} and "
                        f"{bias.dtype}")
    fmt = layout(y, residual)
    if not (fmt is torch.contiguous_format or y.is_contiguous(memory_format=fmt)) or (
            not bias.is_contiguous()) or (
            residual is not None and not residual.is_contiguous(memory_format=fmt)):
        raise ValueError("y and residual must share one layout, NCHW-contiguous or "
                         "channels-last, and bias be contiguous")
    return fmt, 0 if residual is None else upsample_shift(y, residual)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  act: str = "none") -> torch.Tensor:
    """``act(upsample(y + bias) + residual)`` of a conv's output ``y`` (B,
    C, H, W), NCHW or channels-last, with ``bias`` (C); ``residual`` of
    ``y``'s shape or 2, 4 or 8 times its plane, in ``y``'s layout; the
    output has the residual's shape, else ``y``'s.  ``y`` and ``residual``
    bf16, ``bias`` fp32 or bf16, all on one device (``contract``); raises
    on anything else.

    The caller gives ``y`` up: on an eager card tensor (``library.eager``)
    an output of its shape is written into it, so a caller that still needs
    ``y`` passes a clone.  A CPU tensor takes the twin ``conv_epilogue_ref``;
    a CUDA tensor launches the kernel, counted by
    ``conv_epilogue.launches``."""
    return library.call("conv_epilogue", y, bias, residual, act)


conv_epilogue.launches = 0
