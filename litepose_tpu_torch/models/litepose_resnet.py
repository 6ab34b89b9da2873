"""LitePose-ResNet and its channel-search supernet as ``nn.Module``s, NCHW
(counterparts of ``init_litepose_resnet`` / ``apply_litepose_resnet`` and
``init_super_litepose_resnet`` / ``apply_super_litepose_resnet`` in
``litepose_tpu/models/litepose_resnet.py``).

``LitePoseResNet`` (``pose_resnet``):

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
(1.0 wherever it is called) is left out.  Its conv-BN pairs fold at eval
as LitePose's do (``layers.FoldsBN``; the JAX blocks call ``conv_bn``);
the head's BN stays unfolded.  The names of ``first`` / ``stage`` /
``deconv_*`` / ``final_*`` follow LitePose's reference layout; the JAX
package has no reference loader for this family (ROADMAP Queue 3), so no
reference checkpoint is read.

``SuperLitePoseResNet`` (``pose_superresnet``) holds every tensor at the
widths of ``SUPER_RESNET_SETTING`` and runs a sub-width by masking, as
``SuperLitePose`` does, with the same int64 descriptor ``[input_channel,
c0..c3, d0..d2]`` (``super_litepose.arch_to_mask_desc``) and the same
``masked_bn``; its rules are the JAX supernet's, not ``SuperLitePose``'s:

* the stem is an unmasked 7x7 s2 conv-BN-ReLU6 (``first.0``), then a 7x7
  conv (``first.1``) whose output is masked to the input width, a masked
  BN (``first.2``) and ReLU6;
* a block's expanded width is ``active input * r`` (no rounding to 8; its
  maximum is ``make_divisible(round(cin * r), 8)``), each conv's output is
  masked before its masked BN, and the residual is taken when the block
  keeps the stage's stride-1 maximal width and is not the first of its
  stage (so stage 4's first block, 96 -> 160 at stride 1, has none);
* the head's fusion sum is masked before its masked BN, then ReLU.

Its masked BNs never fold (the stem's first conv-BN folds at each eval
call, as ``SuperLitePose``'s stem does).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..arch import ArchManager, make_divisible
from . import layers as L
from .litepose import ModelSpec
from .super_litepose import _chan, _mask, arch_to_mask_desc, masked_bn

# (expand_ratio, kernel, channel, num_blocks, stride) of the fixed net
# (copy of litepose_tpu/models/litepose_resnet.py:RESNET_SETTING)
RESNET_SETTING = ((4, 7, 16, 4, 2), (4, 7, 32, 6, 2), (4, 5, 48, 8, 2), (4, 3, 80, 8, 1))
RESNET_INPUT_CHANNEL = 16
# the supernet's maximal table and stem width (copies of SUPER_RESNET_SETTING,
# SUPER_RESNET_INPUT_CHANNEL there)
SUPER_RESNET_SETTING = ((4, 7, 32, 4, 2), (4, 7, 64, 6, 2), (4, 5, 96, 8, 2), (4, 3, 160, 8, 1))
SUPER_RESNET_INPUT_CHANNEL = 24


def resnet_arch_manager(deconv_setting=(64, 48, 32), seed=None) -> ArchManager:
    """The ``ArchManager`` of the ResNet search space (channels only; copy
    of ``resnet_arch_manager``)."""
    return ArchManager(
        deconv_setting=deconv_setting,
        input_channel=SUPER_RESNET_INPUT_CHANNEL,
        stage_setting=tuple((c, n, s) for _, _, c, n, s in SUPER_RESNET_SETTING),
        seed=seed,
    )


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


def _add_head(model: nn.Module, spec: ModelSpec, channels: Sequence[int],
              deconv_filters: Sequence[int]) -> None:
    """The UpConv fusion head of either model: ``deconv_refined`` /
    ``deconv_raw`` / ``deconv_bnrelu`` a level, then the ``final_refined`` /
    ``final_raw`` 3x3 convs with bias (``channels``: the stem's and each
    stage's output widths)."""
    inplanes, refined, raw, bnrelu = channels[-1], [], [], []
    for i in range(spec.num_deconv_layers):
        k = spec.deconv_kernels[i]
        refined.append(UpConv(inplanes, deconv_filters[i], k))
        raw.append(UpConv(channels[-i - 2], deconv_filters[i], k))
        bnrelu.append(nn.Sequential(L.bn2d(deconv_filters[i]), nn.ReLU()))
        inplanes = deconv_filters[i]
    model.deconv_refined = nn.ModuleList(refined)
    model.deconv_raw = nn.ModuleList(raw)
    model.deconv_bnrelu = nn.ModuleList(bnrelu)
    model.final_refined = nn.ModuleList([nn.Conv2d(deconv_filters[i], cout, 3, 1, 1)
                                         for i, cout in enumerate(spec.final_channels(), 1)])
    model.final_raw = nn.ModuleList([nn.Conv2d(channels[-i - 3], cout, 3, 1, 1)
                                     for i, cout in enumerate(spec.final_channels(), 1)])


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
        _add_head(self, spec, channels, deconv_filters)

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


# -- the channel-search supernet ------------------------------------------------


class SuperFusedMBConv(nn.Module):
    """A FusedMBConv at its maximal widths, run masked: ``inv`` a kxk
    conv + BN to ``make_divisible(round(cin * r), 8)``, ``point_conv`` a 1x1
    conv + BN (the fixed block's names; the BNs run as ``masked_bn``)."""

    def __init__(self, cin: int, cout: int, k: int, r: int, stride: int, residual: bool):
        super().__init__()
        feat = make_divisible(round(cin * r), 8)
        self.inv = L.ConvBNReLU6(cin, feat, k, stride)
        self.point_conv = L.ConvBNReLU6(feat, cout, 1, act=False)
        self.r = r
        self.residual = residual

    def forward(self, x: torch.Tensor, in_n: torch.Tensor, out_n: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        train = self.training
        feat_mask = _mask(in_n * self.r, self.inv[0].out_channels)
        out_mask = _mask(out_n, self.point_conv[0].out_channels)
        y = L.conv(x, self.inv[0], dtype) * _chan(feat_mask, dtype)
        y = torch.clamp(masked_bn(self.inv[1], y, feat_mask, train), 0.0, 6.0)
        y = L.conv(y, self.point_conv[0], dtype) * _chan(out_mask, dtype)
        y = masked_bn(self.point_conv[1], y, out_mask, train)
        return y + x if self.residual else y


class SuperLitePoseResNet(nn.Module):
    """The ResNet-space supernet at maximal widths.  ``forward(x, desc)``:
    ``x`` (B, 3, H, W) normalized images, ``desc`` the int64 mask
    descriptor (default: the max desc) -> [(B, J+T, H/4, W/4),
    (B, J, H/2, W/2)] in ``out_dtype`` at max width.  ``compute_dtype`` as
    ``SuperLitePose``'s; no BN is folded, so new weights, statistics or a
    new desc take effect at the next call."""

    def __init__(self, spec: ModelSpec, deconv_filters: Sequence[int] = (64, 48, 32),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.deconv_filters = tuple(deconv_filters)
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        ic = SUPER_RESNET_INPUT_CHANNEL
        self.first = nn.ModuleList([L.ConvBNReLU6(3, 32, 7, stride=2),
                                    nn.Conv2d(32, ic, 7, 1, 3, bias=False), L.bn2d(ic)])
        channels, cin, stages = [ic], ic, []
        for r, k, c, n, s in SUPER_RESNET_SETTING:
            blocks = []
            for bi in range(n):
                stride = s if bi == 0 else 1
                # JAX's rule: stride 1, the stage's maximal width in, not the first block
                blocks.append(SuperFusedMBConv(cin, c, k, r, stride,
                                               stride == 1 and cin == c and bi > 0))
                cin = c
            stages.append(nn.ModuleList(blocks))
            channels.append(c)
        self.stage = nn.ModuleList(stages)
        self.channels = tuple(channels)
        _add_head(self, spec, channels, deconv_filters)
        self.register_buffer("max_desc", arch_to_mask_desc(
            resnet_arch_manager(self.deconv_filters).max_arch()), persistent=False)

    def forward(self, x: torch.Tensor, desc: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        dt, train = self.compute_dtype, self.training
        desc = self.max_desc if desc is None else torch.as_tensor(desc).to(x.device)
        n_st = len(self.stage)
        in_n, stage_n, deconv_n = desc[0], desc[1:1 + n_st], desc[1 + n_st:]

        y = self.first[0](x, dt)
        stem_mask = _mask(in_n, self.channels[0])
        y = L.conv(y, self.first[1], dt) * _chan(stem_mask, dt)
        y = torch.clamp(masked_bn(self.first[2], y, stem_mask, train), 0.0, 6.0)

        x_list = [y]
        cur_n = in_n
        for si, blocks in enumerate(self.stage):
            for block in blocks:
                y = block(y, cur_n, stage_n[si], dt)
                cur_n = stage_n[si]
            x_list.append(y)

        outputs = []
        input_refined, input_raw = x_list[-1], x_list[-2]
        for i in range(self.spec.num_deconv_layers):
            d_mask = _mask(deconv_n[i], self.deconv_filters[i])
            nxt = self.deconv_refined[i](input_refined, dt) + self.deconv_raw[i](input_raw, dt)
            nxt = nxt * _chan(d_mask, nxt.dtype)
            input_refined = torch.relu(masked_bn(self.deconv_bnrelu[i][0], nxt, d_mask, train))
            input_raw = x_list[-i - 3]
            if i > 0:
                out = (L.conv_bias(input_refined, self.final_refined[i - 1], dt)
                       + L.conv_bias(input_raw, self.final_raw[i - 1], dt))
                outputs.append(out.to(self.out_dtype))
        return outputs


def init_super_litepose_resnet(spec: ModelSpec, generator: torch.Generator,
                               deconv_filters: Sequence[int] = (64, 48, 32),
                               **model_kw) -> SuperLitePoseResNet:
    """A freshly initialized ``SuperLitePoseResNet`` in training mode, on the
    CPU (counterpart of ``init_super_litepose_resnet``):
    ``layers.fan_in_init_``, the final convs' biases zero, BNs at their
    identities."""
    model = SuperLitePoseResNet(spec, deconv_filters, **model_kw)
    return L.fan_in_init_(model, generator).train()
