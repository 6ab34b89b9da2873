"""The depthwise conv of a folded conv + eval BN, with its bias and
activation, as one kernel (``csrc/depthwise_conv.cu``, K6).

No TPU kernel stands behind it: the JAX package leaves the conv to
``lax.conv_general_dilated`` and adds the bias and the activation as XLA
ops.  ``depthwise_conv`` launches the kernel for a CUDA tensor, counted by
``depthwise_conv.launches``, and runs the plain twin
``depthwise_conv_ref`` for a CPU tensor, both through the registered op
``torch.ops.litepose.depthwise_conv`` as ``library.call`` calls it.  The twin is the
unfused sequence the layers ran before the kernel (``F.conv2d``, then
``+ bias.to(dtype)``, then ``torch.clamp``, ``torch.relu`` or Swish as
``x * torch.sigmoid(x)``), so a CPU forward keeps its bits; the kernel
equals it on the card up to the order of the fp32 sum of a window's
products.  Beside the padding k // 2 it takes TensorFlow's SAME at stride 2
(EfficientNet's): k // 2 - 1 rows and columns of zeros before the plane.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import library  # also registers torch.ops.litepose.*

KERNELS = (3, 5, 7)
STRIDES = (1, 2)
ACTS = ("none", "relu6", "relu", "silu")


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """``act`` of ``y`` as the layers apply it: ReLU6 as ``torch.clamp(y,
    0, 6)``, ReLU as ``torch.relu``, Swish as ``y * torch.sigmoid(y)`` (the
    sigmoid rounded to ``y``'s dtype before the product)."""
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if act == "relu":
        return torch.relu(y)
    if act == "silu":
        return y * torch.sigmoid(y)
    return y


def pads(k: int, stride: int) -> tuple:
    """The pads ``depthwise_conv`` takes for a k x k kernel at ``stride``:
    k // 2, and at stride 2 also k // 2 - 1 (SAME)."""
    return (k // 2, k // 2 - 1) if stride == 2 else (k // 2,)


def depthwise_conv_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int,
                       act: str, pad: int = -1) -> torch.Tensor:
    """Plain twin: the depthwise conv of ``x`` (B, C, H, W) by ``w`` (C, 1,
    k, k) at ``stride`` in ``x``'s dtype, padding k // 2 (``pad`` -1 or k //
    2), else ``pad`` zeros before the plane and k - 1 - ``pad`` after it;
    then ``bias`` (C) cast to that dtype is added; then ``act``."""
    k = w.shape[-1]
    if pad in (-1, k // 2):
        y = F.conv2d(x, w, None, stride, k // 2, 1, x.shape[1])
    else:
        y = F.conv2d(F.pad(x, (pad, k - 1 - pad) * 2), w, None, stride, 0, 1, x.shape[1])
    y = y + bias.to(y.dtype)[:, None, None]  # rebound: the conv's output goes before act
    return activation(y, act)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int = 1,
                   act: str = "none", pad: int = -1) -> torch.Tensor:
    """``act(conv(x, w) + bias)`` of a depthwise conv with k in 3, 5, 7,
    stride 1 or 2 and padding k // 2 (``pad`` -1), or at stride 2 ``pad``
    k // 2 - 1 (SAME: that many zeros before the plane); the output is (B,
    C, (H - 1) // stride + 1, (W - 1) // stride + 1) either way: x (B, C,
    H, W), w (C, 1, k, k) in x's dtype, bias (C); on a card x and w bf16 and
    bias fp32.

    A CPU tensor takes the twin ``depthwise_conv_ref``; a CUDA tensor
    launches the kernel, counted by ``depthwise_conv.launches``."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if stride not in STRIDES:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    k = w.shape[-1]
    if k not in KERNELS or tuple(w.shape) != (C, 1, k, k) or tuple(bias.shape) != (C,):
        raise ValueError(f"expected w (C, 1, k, k) with k in {KERNELS} and bias (C,) for C = "
                         f"{C}, got {tuple(w.shape)} and {tuple(bias.shape)}")
    if pad != -1 and pad not in pads(k, stride):
        raise ValueError(f"pad must be -1 or one of {pads(k, stride)} for k {k} at stride "
                         f"{stride}, got {pad}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must be in x's dtype {x.dtype}, got {w.dtype}")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device or bias.device != x.device:
        raise ValueError(f"depthwise_conv runs on cpu or cuda, all its inputs on one device, "
                         f"got {x.device}, {w.device} and {bias.device}")
    return library.call("depthwise_conv", x.contiguous(), w.contiguous(), bias.contiguous(),
                        stride, act, pad)


depthwise_conv.launches = 0
