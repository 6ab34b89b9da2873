"""The squeeze-excitation of an MBConv block (EfficientHRNet's EfficientNet
backbone) at bf16 eval: the mean of each (image, channel) plane, two small
linears with Swish and a sigmoid, and the planes scaled by their gate, in
two launches (``csrc/squeeze_excite.cu``).

No TPU kernel stands behind it: the JAX package leaves the block to XLA.
``squeeze_excite`` launches the kernels for a CUDA tensor, counted by
``squeeze_excite.launches`` (two a call), and runs the plain twin
``squeeze_excite_ref`` for a CPU tensor, through the registered op
``torch.ops.litepose.squeeze_excite`` as ``library.call`` calls it.  The
twin is the sequence the module ran before the kernels (the mean in fp32
rounded to the activation dtype, each linear's product and bias add in it,
Swish as ``x * torch.sigmoid(x)``, the sigmoid, the product), so a CPU
forward keeps its bits; on the card the kernels round where it rounds and
differ from it only where its fp32 sums, taken in another order, meet a
rounding boundary of the bf16 result.
"""

from __future__ import annotations

import torch

from . import library  # also registers torch.ops.litepose.*
from .depthwise import activation


def squeeze_excite_ref(y: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``y`` (B, C, H, W) times ``sigmoid(swish(m @ w1.T + b1)
    @ w2.T + b2)`` a channel, ``m`` the planes' means taken in fp32 (float64
    for a float64 ``y``) and cast to ``y``'s dtype; ``w1`` (R, C), ``b1``
    (R), ``w2`` (C, R), ``b2`` (C) in ``y``'s dtype."""
    m = y.to(torch.promote_types(y.dtype, torch.float32)).mean(dim=(2, 3)).to(y.dtype)
    h = activation(m @ w1.t() + b1, "silu")
    gate = torch.sigmoid(h @ w2.t() + b2)
    return y * gate[:, :, None, None]


def contract(y: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> None:
    """Raise on arguments outside the op's contract (``squeeze_excite``'s)."""
    if y.dim() != 4:
        raise ValueError(f"y must be (B, C, H, W), got {tuple(y.shape)}")
    C = y.shape[1]
    R = w1.shape[0] if w1.dim() == 2 else -1
    if (w1.dim() != 2 or w1.shape[1] != C or tuple(b1.shape) != (R,)
            or tuple(w2.shape) != (C, R) or tuple(b2.shape) != (C,)):
        raise ValueError(f"expected w1 (R, C), b1 (R,), w2 (C, R) and b2 (C,) for C = {C}, got "
                         f"{tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)} and "
                         f"{tuple(b2.shape)}")
    if any(t.dtype != y.dtype for t in (w1, b1, w2, b2)):
        raise TypeError(f"the weights must be in y's dtype {y.dtype}, got "
                        f"{[t.dtype for t in (w1, b1, w2, b2)]}")
    if any(t.device != y.device for t in (w1, b1, w2, b2)):
        raise ValueError("y and the weights must lie on one device")


def squeeze_excite(y: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """``squeeze_excite_ref``'s function of ``y`` (B, C, H, W) and the two
    linears ``w1`` (R, C), ``b1`` (R), ``w2`` (C, R), ``b2`` (C), all in
    ``y``'s dtype (bf16 on a card) on one device (``contract``).

    The caller gives ``y`` up: on an eager card tensor (``library.eager``)
    the output is written into it.  A CPU tensor takes the twin; a CUDA
    tensor launches the two kernels, counted by
    ``squeeze_excite.launches``."""
    contract(y, w1, b1, w2, b2)
    return library.call("squeeze_excite", y.contiguous(), w1.contiguous(), b1.contiguous(),
                        w2.contiguous(), b2.contiguous())


squeeze_excite.launches = 0
