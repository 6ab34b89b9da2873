"""LitePose-ResNet as an ``nn.Module``, NCHW (counterpart of
``init_litepose_resnet`` / ``apply_litepose_resnet`` in
``litepose_tpu/models/litepose_resnet.py``).

  ``first``: 7x7 s2 conv-BN-ReLU6 (3 -> 32), 7x7 conv-BN-ReLU6 (32 -> 16);
  ``stage``: four stages of FusedMBConv (a kxk conv-BN-ReLU6 expanding by r,
             then a 1x1 conv-BN, residual when shape-preserving) from
             ``RESNET_SETTING``;
  head:      three UpConv fusion levels: a 2x nearest upsample + conv of
             the running feature (``deconv_refined``) plus one of the
             matching backbone skip (``deconv_raw``), then BN + ReLU
             (``deconv_bnrelu``); levels 1 and 2 emit a stage output as
             ``final_refined`` + ``final_raw`` (plain 3x3 convs with bias).

Kept as the JAX module has it: the expansion ratio of every FusedMBConv is
the allocated r (4); the reference's forward passes its table's 6 into
blocks built with r = 4 (the documented divergence,
``litepose_tpu/models/litepose_resnet.py:12-16``).  JAX's ``width_mult``
(1.0 wherever it is called) is left out.  The channel-search
super variant (``pose_superresnet``) is not ported (ROADMAP M9/M10).

The conv-BN pairs fold at eval as LitePose's do (``layers.FoldsBN``; the
JAX blocks call ``conv_bn``); the head's BN stays unfolded.  The names of
``first`` / ``stage`` / ``deconv_*`` / ``final_*`` follow LitePose's
reference layout; the JAX package has no reference loader for this family
(ROADMAP Queue 3), so no reference checkpoint is read.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from ..arch import make_divisible
from . import layers as L
from .litepose import ModelSpec

# (expand_ratio, kernel, channel, num_blocks, stride) of the fixed net
# (copy of litepose_tpu/models/litepose_resnet.py:RESNET_SETTING)
RESNET_SETTING = ((4, 7, 16, 4, 2), (4, 7, 32, 6, 2), (4, 5, 48, 8, 2), (4, 3, 80, 8, 1))
RESNET_INPUT_CHANNEL = 16


class FusedMBConv(nn.Module):
    """kxk conv-BN-ReLU6 to ``make_divisible(cin * r)``, 1x1 conv-BN,
    residual when stride 1 and cin == cout (``fused_mbconv_apply``)."""

    def __init__(self, cin: int, cout: int, k: int, r: int, stride: int):
        super().__init__()
        feat = make_divisible(round(cin * r), 8)
        self.inv = L.ConvBNReLU6(cin, feat, k, stride)
        self.point_conv = L.ConvBNReLU6(feat, cout, 1, act=False)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.point_conv(self.inv(x, dtype), dtype)
        return y + x if self.residual else y


class UpConv(nn.Module):
    """2x nearest upsample, then a kxk conv with no BN (``upconv_apply``)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, k // 2, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return L.conv(L.upsample_nearest(x, 2), self.conv, dtype)


class LitePoseResNet(L.FoldsBN, nn.Module):
    """Forward: ``x`` (B, 3, H, W) normalized images -> [(B, J+T, H/4, W/4),
    (B, J, H/2, W/2)] in ``out_dtype``; ``compute_dtype`` as LitePose's.
    ``deconv_filters``: the head's widths (``MODEL.EXTRA.NUM_DECONV_FILTERS``);
    its kernels are ``spec.deconv_kernels``."""

    def __init__(self, spec: ModelSpec, deconv_filters: Sequence[int] = (64, 48, 32),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.deconv_filters = tuple(deconv_filters)
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        ic = RESNET_INPUT_CHANNEL
        self.first = nn.ModuleList([L.ConvBNReLU6(3, 32, 7, stride=2),
                                    L.ConvBNReLU6(32, ic, 7)])
        channels, cin, stages = [ic], ic, []
        for r, k, c, n, s in RESNET_SETTING:
            blocks = []
            for bi in range(n):
                blocks.append(FusedMBConv(cin, c, k, r, s if bi == 0 else 1))
                cin = c
            stages.append(nn.ModuleList(blocks))
            channels.append(c)
        self.stage = nn.ModuleList(stages)

        inplanes, refined, raw, bnrelu = channels[-1], [], [], []
        for i in range(spec.num_deconv_layers):
            k = spec.deconv_kernels[i]
            refined.append(UpConv(inplanes, deconv_filters[i], k))
            raw.append(UpConv(channels[-i - 2], deconv_filters[i], k))
            bnrelu.append(nn.Sequential(L.bn2d(deconv_filters[i]), nn.ReLU()))
            inplanes = deconv_filters[i]
        self.deconv_refined = nn.ModuleList(refined)
        self.deconv_raw = nn.ModuleList(raw)
        self.deconv_bnrelu = nn.ModuleList(bnrelu)
        final_refined, final_raw = [], []
        for i, cout in enumerate(spec.final_channels(), start=1):
            final_refined.append(nn.Conv2d(deconv_filters[i], cout, 3, 1, 1))
            final_raw.append(nn.Conv2d(channels[-i - 3], cout, 3, 1, 1))
        self.final_refined = nn.ModuleList(final_refined)
        self.final_raw = nn.ModuleList(final_raw)

    def _conv_bn_pairs(self):
        return [(m[0], m[1]) for m in self.modules() if isinstance(m, L.ConvBNReLU6)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.compute_dtype
        y = self.first[1](self.first[0](x, dt), dt)
        x_list = [y]
        for blocks in self.stage:
            for block in blocks:
                y = block(y, dt)
            x_list.append(y)

        outputs = []
        input_refined, input_raw = x_list[-1], x_list[-2]
        for i in range(self.spec.num_deconv_layers):
            nxt = self.deconv_refined[i](input_refined, dt) + self.deconv_raw[i](input_raw, dt)
            input_refined = torch.relu(L.batch_norm(nxt, self.deconv_bnrelu[i][0]))
            input_raw = x_list[-i - 3]
            if i > 0:
                out = (L.conv_bias(input_refined, self.final_refined[i - 1], dt)
                       + L.conv_bias(input_raw, self.final_raw[i - 1], dt))
                outputs.append(out.to(self.out_dtype))
        return outputs


def init_litepose_resnet(spec: ModelSpec, generator: torch.Generator,
                         deconv_filters: Sequence[int] = (64, 48, 32),
                         **model_kw) -> LitePoseResNet:
    """A freshly initialized ``LitePoseResNet`` in training mode, on the CPU
    (counterpart of ``init_litepose_resnet``): ``layers.fan_in_init_``."""
    model = LitePoseResNet(spec, deconv_filters, **model_kw)
    return L.fan_in_init_(model, generator).train()
