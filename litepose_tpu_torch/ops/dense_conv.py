"""A dense 3x3 stride-1 conv of a folded conv + eval BN, with its epilogue
(the bias, an optional residual of the output's shape, the activation), as
one kernel (``csrc/dense_conv3x3.cu``, K8), channels-last.

No TPU kernel stands behind it: the JAX package leaves the conv to
``lax.conv_general_dilated`` and the epilogue to XLA's fusion.
``conv3x3_bn_act`` launches the kernel for a CUDA tensor, counted by
``conv3x3_bn_act.launches``, and runs the plain twin
``conv3x3_bn_act_ref`` for a CPU tensor, through the registered op
``torch.ops.litepose.conv3x3_bn_act`` as ``library.call`` calls it.  The
twin is the sequence the layers run where the kernel does not:
``F.conv2d`` in the inputs' dtype, then ``ops.epilogue.unfused``, so a CPU
forward keeps its bits.  On the card the kernel's conv sums in another
order than cuDNN's; given its own conv output, its epilogue equals
``unfused`` bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import library  # also registers torch.ops.litepose.*
from .epilogue import unfused

ACTS = ("none", "relu6", "relu")  # the first three of ops.depthwise.ACTS: no Swish
CHANNEL_STEP = 16  # Cin and Cout are multiples of it
MAX_COUT = 512  # kMaxCout in the kernel: the bias in shared memory
MAX_WIDTH = 1024  # kMaxWidth: two stages of a 16-channel slice still fit
MAX_ELEMENTS = 2 ** 31  # B H W max(Cin, Cout) below it: the kernel's tile counts are ints


def within_limits(B: int, cin: int, cout: int, H: int, W: int) -> bool:
    """Whether the kernel's geometry takes these sizes: Cin and Cout
    multiples of 16, Cout at most 512, W at most 1024 and B H W max(Cin,
    Cout) below 2^31."""
    return (cin % CHANNEL_STEP == 0 and cout % CHANNEL_STEP == 0 and cout <= MAX_COUT
            and W <= MAX_WIDTH and B * H * W * max(cin, cout) < MAX_ELEMENTS)


def conv3x3_bn_act_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """Plain twin: ``F.conv2d(x, w)`` at stride 1 and padding 1 in the
    inputs' dtype, as ``layers.conv_bn`` calls it, then ``unfused`` (the
    bias, the residual, ``act``), channels-last."""
    y = F.conv2d(x, w, None, 1, 1, 1, 1)
    return unfused(y, bias, residual, act).contiguous(memory_format=torch.channels_last)


def contract(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             residual: Optional[torch.Tensor], act: str) -> tuple:
    """The output's shape for arguments in the op's contract
    (``conv3x3_bn_act``'s); raises on anything else."""
    devices = {t.device for t in (x, w, bias) + ((residual,) if residual is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"x, w, bias and residual must lie on one device, got "
                         f"{sorted(map(str, devices))}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3) or bias.dim() != 1 \
            or bias.shape[0] != w.shape[0]:
        raise ValueError(f"expected x (B, Cin, H, W), w (Cout, Cin, 3, 3) and bias (Cout,), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)} and {tuple(bias.shape)}")
    B, cin, H, W = x.shape
    cout = w.shape[0]
    if not within_limits(B, cin, cout, H, W):
        raise ValueError(f"Cin and Cout must be multiples of {CHANNEL_STEP}, Cout at most "
                         f"{MAX_COUT}, W at most {MAX_WIDTH} and B H W max(Cin, Cout) below "
                         f"2^31, got B {B}, Cin {cin}, Cout {cout}, H {H}, W {W}")
    if x.dtype is not torch.bfloat16 or w.dtype is not torch.bfloat16 or bias.dtype is not \
            torch.float32 or (residual is not None and residual.dtype is not torch.bfloat16):
        raise TypeError(f"expected bf16 x, w and residual and an fp32 bias, got "
                        f"{x.dtype}, {w.dtype}, "
                        f"{None if residual is None else residual.dtype} and {bias.dtype}")
    out = (B, cout, H, W)
    if residual is not None and tuple(residual.shape) != out:
        raise ValueError(f"residual must be the output's shape {out}, got "
                         f"{tuple(residual.shape)}")
    cl = torch.channels_last
    if not (x.is_contiguous(memory_format=cl) and bias.is_contiguous()
            and (residual is None or residual.is_contiguous(memory_format=cl))
            and (w.is_contiguous(memory_format=cl) or not x.is_cuda and w.is_contiguous())):
        raise ValueError("x and residual must be channels-last, w channels-last (on the CPU "
                         "also contiguous) and bias contiguous")
    return out


def conv3x3_bn_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, act: str = "none") -> torch.Tensor:
    """``act(conv(x, w) + bias + residual)`` of a 3x3 conv at stride 1 and
    padding 1, groups 1: ``x`` (B, Cin, H, W) and ``w`` (Cout, Cin, 3, 3)
    bf16 and channels-last (``w`` on the CPU also contiguous, as the stored
    weights lie there), ``bias`` (Cout) fp32, ``residual`` (B, Cout, H, W)
    bf16 channels-last; sizes ``within_limits``, all on one device
    (``contract``); raises on anything else.  The output is channels-last.

    A CPU tensor takes the twin ``conv3x3_bn_act_ref``; a CUDA tensor
    launches the kernel, counted by ``conv3x3_bn_act.launches``."""
    return library.call("conv3x3_bn_act", x, w, bias, residual, act)


conv3x3_bn_act.launches = 0
