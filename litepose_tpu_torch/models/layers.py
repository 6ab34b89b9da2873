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
* At bf16 eval the depthwise conv of a folded pair (k 3, 5 or 7, stride 1
  or 2, padding k // 2) goes to the port's own kernel
  (``ops.depthwise.depthwise_conv``, ``csrc/depthwise_conv.cu``), which
  adds the bias and applies the ReLU6 / ReLU after it in its epilogue: one
  launch where ``F.conv2d``, the bias add and the clamp were three.  It
  rounds as that sequence does; only the order of the fp32 sum of a
  window's products differs.  On the CPU the op runs that sequence itself,
  so a CPU forward keeps its bits; fp32, training and dense convs keep
  ``F.conv2d``.
* At bf16 eval the epilogue of every other conv of a folded pair (the
  bias, the residual ``conv_bn`` is given, the activation) goes to the
  port's own kernel (``ops.epilogue.conv_epilogue``,
  ``csrc/conv_epilogue.cu``): one launch after cuDNN's conv where the bias
  cast, the bias add, the residual add (with the nearest upsample of a
  HigherHRNet fuse) and the clamp were up to five.  It rounds as that
  sequence does, bit for bit; on the CPU the op runs that sequence itself.
  fp32, training and unfolded pairs keep the ATen ops.
* In training mode every BN is a plain ``nn.BatchNorm2d`` (batch
  statistics, momentum 0.1, eps 1e-5), as ``layers.batch_norm`` is; under
  a process group of more than one rank it takes the global statistics of
  every rank's batch (``bn_train``), as ``jnp.mean`` over a batch sharded
  on JAX's mesh does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..arch import make_divisible
from ..ops.depthwise import KERNELS, STRIDES, depthwise_conv
from ..ops.epilogue import conv_epilogue, unfused
from ..parallel.mesh import sync_batch_stats, world

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


def bn_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """A BN in training mode.  In one process ``bn(x)``.  Under a process
    group of more than one rank, JAX's ``batch_norm`` (train branch) over
    the global batch: fp32 statistics from ``sync_batch_stats``, running
    statistics moved by momentum 0.1 with the unbiased variance of the
    global count, ``(x - mean) * rsqrt(var + eps) * scale + bias`` in fp32
    (float64 for a float64 input), ``x.dtype`` out."""
    if world().size == 1:
        return bn(x)
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, var, n = sync_batch_stats(x32, (0, 2, 3))
    with torch.no_grad():
        m = BN_MOMENTUM
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean.detach())
        bn.running_var.copy_((1 - m) * bn.running_var + m * var.detach() * (n / max(n - 1, 1)))
        bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x32 - mean[:, None, None]) * inv[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def fused_depthwise(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether an eval ``conv_bn`` of ``conv`` on ``x`` (already in the
    compute dtype) takes the depthwise kernel: a bf16 depthwise conv with a
    square kernel of 3, 5 or 7, stride 1 or 2 both ways, padding k // 2,
    no dilation, and no gradient to carry to ``x`` (the op has none)."""
    k = conv.kernel_size[0]
    return (x.dtype == torch.bfloat16
            and conv.groups == conv.in_channels == conv.out_channels
            and conv.kernel_size == (k, k) and k in KERNELS
            and conv.stride[0] == conv.stride[1] and conv.stride[0] in STRIDES
            and conv.padding == (k // 2, k // 2) and conv.dilation == (1, 1)
            and not (x.requires_grad and torch.is_grad_enabled()))


def fused_epilogue(y: torch.Tensor, residual: Optional[torch.Tensor]) -> bool:
    """Whether the epilogue of an eval ``conv_bn`` whose conv gave ``y``
    takes the epilogue kernel: ``y`` bf16, a residual (if any) in its dtype,
    and no gradient to carry (the op has none)."""
    return (y.dtype == torch.bfloat16
            and (residual is None or residual.dtype == y.dtype)
            and not (torch.is_grad_enabled()
                     and (y.requires_grad or residual is not None and residual.requires_grad)))


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
            act: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv followed by BN, then ``residual`` added where given (of the
    output's shape, or a sum at 2, 4 or 8 times its plane that the output is
    nearest-upsampled into: a HigherHRNet fuse), then ``act`` ("none",
    "relu6" as ``torch.clamp``, "relu"): batch statistics in training; at
    eval the weights ``LitePose.fold_bn_`` folded once, else folded here; a
    depthwise conv in bf16 as one kernel with its bias and activation
    (``fused_depthwise``), any other conv's epilogue in bf16 as one kernel
    after the conv (``fused_epilogue``); elsewhere the epilogue is
    ``ops.epilogue.unfused``, the ATen sequence the kernel equals."""
    # each step rebinds y, so no step holds the tensor before it
    if bn.training:
        y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                     conv.padding, conv.dilation, conv.groups)
        return unfused(bn_train(y, bn), None, residual, act)
    if hasattr(conv, "folded_w"):
        w, bias = conv.folded_w, conv.folded_b
    else:
        w, bias = fold_bn(conv, bn, dtype)
    x = x.to(dtype)
    if residual is None and fused_depthwise(conv, x):
        return depthwise_conv(x, w, bias, conv.stride[0], act)
    y = F.conv2d(x, w, None, conv.stride, conv.padding, conv.dilation, conv.groups)
    if fused_epilogue(y, residual):
        return conv_epilogue(y, bias, residual, act)  # y is conv_bn's own: written in place
    return unfused(y, bias, residual, act)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """A BN with no conv to fold into: at eval ``x * inv + bias`` in the
    activation dtype (``layers.batch_norm``, eval branch)."""
    if bn.training:
        return bn_train(x, bn)
    inv, bias = bn_affine(bn)
    return x * inv.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def weight(m: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """``m``'s weight in ``dtype``: at eval the copy a model's ``fold_bn_``
    stored (``cast_w``, HigherHRNet's head) where it is in ``dtype``, else
    cast now."""
    w = None if m.training else m._buffers.get("cast_w")
    return w if w is not None and w.dtype == dtype else m.weight.to(dtype)


def conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A conv with no BN after it (the pointwise conv of ``SepConv2d``)."""
    return F.conv2d(x.to(dtype), weight(m, dtype), None, m.stride,
                    m.padding, m.dilation, m.groups)


def conv_bias(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A conv, then its bias added in the output dtype (the JAX
    ``conv(...) + b.astype(out.dtype)`` of the families' final layers)."""
    y = conv(x, m, dtype)
    return y + m.bias.to(y.dtype)[:, None, None]


class FoldsBN:
    """``fold_bn_`` and ``train`` for an ``nn.Module`` whose ``conv_bn``
    pairs ``_conv_bn_pairs()`` lists and whose convs run in
    ``compute_dtype`` (LitePose, LitePose-ResNet, HigherHRNet)."""

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

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return conv_bn(x, self[0], self[1], dtype, "relu6" if len(self) > 2 else "none",
                       residual)


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
        y = self.depth_conv(self.inv(x, dtype), dtype)
        return self.point_conv(y, dtype, x if self.residual else None)


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
        y = conv_bn(x, self.conv[0], self.conv[1], dtype, "relu")
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
    return F.conv_transpose2d(x.to(dtype), weight(m, dtype), None,
                              m.stride, m.padding, m.output_padding)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Each pixel of (B, C, H, W) repeated ``factor`` (a power of two)
    times along H and W (``jnp.repeat`` on both axes), in ``x``'s memory
    layout."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


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
