"""LitePose building blocks as ``nn.Module``s, NCHW (counterpart of
``litepose_tpu/models/layers.py``).

Parameter names follow the reference PyTorch layout
(``Sequential(conv, bn[, act])`` children ``0``, ``1``, ``2``), so a state
dict from ``models.convert.state_dict_from_jax`` loads with ``strict=True``.

Numerics follow the JAX layer library rather than plain ``nn.Sequential``:

* ``compute_dtype`` replaces the JAX ``Policy``: conv inputs and weights are
  cast to it (bf16 serving, fp32 for parity); convolutions stay
  ``F.conv2d`` / ``F.conv_transpose2d``, as the JAX package leaves them to
  ``lax.conv_general_dilated``.
* At eval a BN after a conv folds into the conv as ``conv_bn`` does
  (``litepose_tpu/models/layers.py:191-204``): ``w' = w * rsqrt(var + eps)
  * scale`` in fp32, only then cast to the compute dtype; the bias
  ``beta - mean * inv`` is added in the activation dtype.  Folding in
  another order gives other bf16 weights than the JAX model.
* In training mode every BN is a plain ``nn.BatchNorm2d`` (batch
  statistics, momentum 0.1, eps 1e-5), as ``layers.batch_norm`` is.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..arch import make_divisible

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def bn2d(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as a per-channel (inv, bias) pair, in fp32."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    return inv, bn.bias.float() - bn.running_mean.float() * inv


def fold_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype):
    """(w', bias) of conv + eval BN, in the JAX fold order."""
    with torch.no_grad():
        inv, bias = bn_affine(bn)
        return (conv.weight.float() * inv[:, None, None, None]).to(dtype), bias


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
            dtype: torch.dtype) -> torch.Tensor:
    """conv followed by BN: batch statistics in training; at eval the
    weights ``LitePose.fold_bn_`` folded once, else folded here."""
    if bn.training:
        y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                     conv.padding, conv.dilation, conv.groups)
        return bn(y)
    if hasattr(conv, "folded_w"):
        w, bias = conv.folded_w, conv.folded_b
    else:
        w, bias = fold_bn(conv, bn, dtype)
    y = F.conv2d(x.to(dtype), w, None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y + bias.to(y.dtype)[:, None, None]


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """A BN with no conv to fold into: at eval ``x * inv + bias`` in the
    activation dtype (``layers.batch_norm``, eval branch)."""
    if bn.training:
        return bn(x)
    inv, bias = bn_affine(bn)
    return x * inv.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A conv with no BN after it (the pointwise conv of ``SepConv2d``)."""
    return F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride,
                    m.padding, m.dilation, m.groups)


def conv_bias(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A conv, then its bias added in the output dtype (the JAX
    ``conv(...) + b.astype(out.dtype)`` of the families' final layers)."""
    y = conv(x, m, dtype)
    return y + m.bias.to(y.dtype)[:, None, None]


class FoldsBN:
    """``fold_bn_`` and ``train`` for an ``nn.Module`` whose ``conv_bn``
    pairs ``_conv_bn_pairs()`` lists and whose convs run in
    ``compute_dtype`` (LitePose, LitePose-ResNet)."""

    def fold_bn_(self):
        """Fold every conv's eval BN into it once, in ``compute_dtype``
        (non-persistent buffers, so they move with ``.to`` and stay out of
        the state dict).  Folding at every call instead adds 1.5-3% to the
        b64 forward and doubles the b1 latency on an H100 (PERF.md).  Call
        it again after writing weights in eval mode; ``train`` handles the
        switches between the modes."""
        for conv, bn in self._conv_bn_pairs():
            w, bias = fold_bn(conv, bn, self.compute_dtype)
            conv.register_buffer("folded_w", w, persistent=False)
            conv.register_buffer("folded_b", bias, persistent=False)
        return self

    def train(self, mode: bool = True):
        """Switching to training drops the folded weights, which every
        optimizer step would leave stale; switching back to eval folds the
        trained weights again, so eval never serves the old ones."""
        was_training = self.training
        super().train(mode)
        if mode:
            for conv, _ in self._conv_bn_pairs():
                for name in ("folded_w", "folded_b"):
                    conv._buffers.pop(name, None)
        elif was_training:
            self.fold_bn_()
        return self


class ConvBNReLU6(nn.Sequential):
    """conv + BN (+ ReLU6); children ``0`` conv, ``1`` BN, ``2`` ReLU6
    (reference ``convbnrelu``)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        layers = [nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                            bias=False), bn2d(cout)]
        if act:
            layers.append(nn.ReLU6())
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv_bn(x, self[0], self[1], dtype)
        return torch.clamp(y, 0.0, 6.0) if len(self) > 2 else y


class InvBottleneck(nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand, kxk depthwise, 1x1
    project, residual when shape-preserving (``inv_bottleneck_apply``)."""

    def __init__(self, cin: int, cout: int, ker: int = 3, exp: int = 6,
                 stride: int = 1):
        super().__init__()
        feat = make_divisible(round(cin * exp), 8)
        self.inv = ConvBNReLU6(cin, feat, 1)
        self.depth_conv = ConvBNReLU6(feat, feat, ker, stride, groups=feat)
        self.point_conv = ConvBNReLU6(feat, cout, 1, act=False)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.point_conv(self.depth_conv(self.inv(x, dtype), dtype), dtype)
        return y + x if self.residual else y


class SepConv2d(nn.Module):
    """Depthwise kxk + BN + ReLU, then 1x1 with no BN (reference
    ``SepConv2d``; children ``conv.{0,1,2,3}``)."""

    def __init__(self, cin: int, cout: int, ker: int = 5):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cin, ker, 1, ker // 2, groups=cin, bias=False),
            bn2d(cin), nn.ReLU(),
            nn.Conv2d(cin, cout, 1, bias=False),
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.relu(conv_bn(x, self.conv[0], self.conv[1], dtype))
        return conv(y, self.conv[3], dtype)


def deconv_cfg(k: int) -> Tuple[int, int]:
    """(padding, output_padding) per deconv kernel size (``_deconv_cfg``,
    ``litepose_tpu/models/litepose.py:72-75``)."""
    return {4: (1, 0), 3: (1, 1), 2: (0, 0)}[k]


def make_deconv(cin: int, cout: int, k: int) -> nn.ConvTranspose2d:
    """Exact 2x transposed conv of the fusion-deconv head."""
    pad, opad = deconv_cfg(k)
    return nn.ConvTranspose2d(cin, cout, k, stride=2, padding=pad,
                              output_padding=opad, bias=False)


def deconv(x: torch.Tensor, m: nn.ConvTranspose2d,
           dtype: torch.dtype) -> torch.Tensor:
    return F.conv_transpose2d(x.to(dtype), m.weight.to(dtype), None,
                              m.stride, m.padding, m.output_padding)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Each pixel of (B, C, H, W) repeated ``factor`` times along H and W
    (``jnp.repeat`` on both axes)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor).reshape(
        b, c, h * factor, w * factor)


def fan_in_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX init in place: every conv kernel drawn from ``generator``
    uniformly in +-sqrt(3 / fan_in) (``layers._fan_in_uniform``, sqrt(3)
    times PyTorch's default), fan_in ``k*k*cin/groups`` for a conv and
    ``k*k*cout`` for a transposed conv; conv biases 0.  BNs keep scale 1,
    bias 0, mean 0, var 1.  Draws are made where the model is (the CPU), so
    a seed gives the same weights whatever device the model goes to."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
            elif isinstance(m, nn.Conv2d):
                fan_in = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
            else:
                continue
            bound = math.sqrt(3.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return model
