"""LitePose as an ``nn.Module``, NCHW (counterpart of
``litepose_tpu/models/litepose.py``).

  stem ``first``: 3x3 s2 conv-BN-ReLU6 (3 -> 32), 3x3 depthwise conv-BN-ReLU6,
                  1x1 conv, BN
  ``stage``:      four stages of ``InvBottleneck`` from the arch descriptor
  head:           three fusion-deconv levels: a transposed conv of the running
                  feature (``deconv_refined``) plus one of the matching
                  backbone skip (``deconv_raw``), then BN + ReLU
                  (``deconv_bnrelu``); levels 1 and 2 emit a stage output as
                  ``final_refined`` + ``final_raw`` (``SepConv2d``, k=5).

Parameter names are the reference layout that
``litepose_tpu.models.torch_convert.litepose_to_torch`` emits.  Archs come
from the port's own ``litepose_tpu_torch.arch`` (``get_arch`` is re-exported
here).
``with_skips=False`` drops every raw branch (the "w/o fusion" ablation).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn as nn

from ..arch import ArchConfig
from ..arch import get_arch  # noqa: F401  (the zoo lookup, re-exported)
from . import layers as L

STEM_CHANNELS = 32


class ModelSpec(NamedTuple):
    """The part of the experiment config a model needs (mirror of the JAX
    ``ModelSpec``, whose module imports jax)."""

    num_joints: int = 14
    tag_per_joint: bool = True
    with_heatmaps_loss: Tuple[bool, ...] = (True, True)
    with_ae_loss: Tuple[bool, ...] = (True, False)
    num_deconv_layers: int = 3
    deconv_kernels: Tuple[int, ...] = (4, 4, 4)

    def final_channels(self) -> List[int]:
        """Output channels of each emitted stage: joints, then tags."""
        dim_tag = self.num_joints if self.tag_per_joint else 1
        out = []
        for i in range(1, self.num_deconv_layers):
            oup_joint = self.num_joints if self.with_heatmaps_loss[i - 1] else 0
            oup_tag = dim_tag if self.with_ae_loss[i - 1] else 0
            out.append(oup_joint + oup_tag)
        return out


class LitePose(nn.Module):
    """Forward: ``x`` (B, 3, H, W) normalized images -> list of NCHW stage
    outputs at (H/4, W/4) and (H/2, W/2), in ``out_dtype``.

    compute_dtype: conv compute type (bf16 serving, fp32 for parity), the
    JAX ``Policy``.  out_dtype: type of the emitted stage outputs, as in
    ``apply_litepose`` (the serving path keeps them bf16)."""

    def __init__(self, spec: ModelSpec, arch: ArchConfig,
                 with_skips: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.arch = arch
        self.with_skips = with_skips
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype

        c = arch.input_channel
        self.first = nn.ModuleList([
            L.ConvBNReLU6(3, STEM_CHANNELS, 3, stride=2),
            L.ConvBNReLU6(STEM_CHANNELS, STEM_CHANNELS, 3, groups=STEM_CHANNELS),
            nn.Conv2d(STEM_CHANNELS, c, 1, bias=False),
            L.bn2d(c),
        ])

        channels = [c]
        cin = c
        stages = []
        for st in arch.backbone_setting:
            blocks = []
            for bi in range(st.num_blocks):
                t, k = st.block_setting[bi]
                blocks.append(L.InvBottleneck(
                    cin, st.channel, ker=k, exp=t,
                    stride=st.stride if bi == 0 else 1))
                cin = st.channel
            stages.append(nn.ModuleList(blocks))
            channels.append(st.channel)
        self.stage = nn.ModuleList(stages)

        filters = arch.deconv_setting
        inplanes = channels[-1]
        refined, raw, bnrelu = [], [], []
        for i in range(spec.num_deconv_layers):
            kd = spec.deconv_kernels[i]
            refined.append(L.make_deconv(inplanes, filters[i], kd))
            if with_skips:
                raw.append(L.make_deconv(channels[-i - 2], filters[i], kd))
            bnrelu.append(nn.Sequential(L.bn2d(filters[i]), nn.ReLU()))
            inplanes = filters[i]
        self.deconv_refined = nn.ModuleList(refined)
        if with_skips:
            self.deconv_raw = nn.ModuleList(raw)
        self.deconv_bnrelu = nn.ModuleList(bnrelu)

        final_refined, final_raw = [], []
        for i, cout in enumerate(spec.final_channels(), start=1):
            final_refined.append(L.SepConv2d(filters[i], cout, 5))
            if with_skips:
                final_raw.append(L.SepConv2d(channels[-i - 3], cout, 5))
        self.final_refined = nn.ModuleList(final_refined)
        if with_skips:
            self.final_raw = nn.ModuleList(final_raw)

    def _conv_bn_pairs(self):
        pairs = [(self.first[2], self.first[3])]
        for m in self.modules():
            if isinstance(m, L.ConvBNReLU6):
                pairs.append((m[0], m[1]))
            elif isinstance(m, L.SepConv2d):
                pairs.append((m.conv[0], m.conv[1]))
        return pairs

    def fold_bn_(self) -> "LitePose":
        """Fold every conv's eval BN into it once, in ``compute_dtype``
        (non-persistent buffers, so they move with ``.to`` and stay out of
        the state dict).  Folding at every call instead adds 1.5-3% to the
        b64 forward and doubles the b1 latency on an H100 (PERF.md).  Call
        it again after writing weights in eval mode; ``train`` handles the
        switches between the modes."""
        for conv, bn in self._conv_bn_pairs():
            w, bias = L.fold_bn(conv, bn, self.compute_dtype)
            conv.register_buffer("folded_w", w, persistent=False)
            conv.register_buffer("folded_b", bias, persistent=False)
        return self

    def train(self, mode: bool = True) -> "LitePose":
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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.compute_dtype
        y = self.first[0](x, dt)
        y = self.first[1](y, dt)
        y = L.conv_bn(y, self.first[2], self.first[3], dt)

        x_list = [y]
        for blocks in self.stage:
            for block in blocks:
                y = block(y, dt)
            x_list.append(y)

        outputs = []
        input_refined = x_list[-1]
        input_raw = x_list[-2]
        for i in range(self.spec.num_deconv_layers):
            nxt = L.deconv(input_refined, self.deconv_refined[i], dt)
            if self.with_skips:
                nxt = nxt + L.deconv(input_raw, self.deconv_raw[i], dt)
            input_refined = torch.relu(
                L.batch_norm(nxt, self.deconv_bnrelu[i][0]))
            input_raw = x_list[-i - 3]
            if i > 0:
                out = self.final_refined[i - 1](input_refined, dt)
                if self.with_skips:
                    out = out + self.final_raw[i - 1](input_raw, dt)
                outputs.append(out.to(self.out_dtype))
        return outputs


def init_litepose(spec: ModelSpec, arch: ArchConfig, generator: torch.Generator,
                  with_skips: bool = True, **model_kw) -> LitePose:
    """A freshly initialized ``LitePose`` in training mode, on the CPU
    (counterpart of ``init_litepose``, ``litepose_tpu/models/litepose.py``).

    Every kernel is drawn from ``generator`` uniformly in +-sqrt(3 / fan_in),
    the JAX bound (``litepose_tpu/models/layers.py:_fan_in_uniform``), which
    is sqrt(3) times PyTorch's default conv init; fan_in is
    ``k*k*cin/groups`` for a conv and ``k*k*cout`` for a transposed conv.
    BNs start at scale 1, bias 0, mean 0, var 1.  Draws are made on the CPU,
    so one seed gives the same weights whatever device the model goes to."""
    model = LitePose(spec, arch, with_skips=with_skips, **model_kw)
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
    return model.train()
