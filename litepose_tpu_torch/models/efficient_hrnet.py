"""EfficientHRNet as ``nn.Module``s, NCHW (counterpart of
``litepose_tpu/models/efficient_hrnet.py``).

  backbone ``features``: an EfficientNet-B0 (a conv-BN-Swish stem, MBConv
           blocks with squeeze-excitation and Swish), widths and depths
           scaled by WIDTH_MULT / DEPTH_MULT, TF-style asymmetric SAME
           padding; four feature taps whose block indices are fixed per
           DEPTH_MULT (``DEPTH_TAPS``);
  ``trans1..3_branch{m}``: per-branch 3x3 conv (with bias) + BN + ReLU
           feeding each HRNet stage;
  ``stage2..4``: HigherHRNet's ``HighResolutionModule``s of BASIC blocks at
           widths scaled by ``1.2455 ** SCALE_FACTOR``;
  head:    HigherHRNet's ``final_layers`` and ``deconv_layers``.

Parameter names are the reference ``pose_efficient_hrnet``'s, the keys
``efficient_hrnet_from_torch`` (``litepose_tpu/models/torch_convert.py``)
reads: a stem or MBConv conv-BN-Swish is ``Sequential(ZeroPad2d, conv, BN,
Swish)`` (children ``1`` and ``2``), an MBConv ``conv.{expand, dw, se,
project conv, project BN}``, its squeeze-excitation ``se.{1, 3}``.

SAME padding: the ``ZeroPad2d`` child holds a conv's pad, and the conv has
``padding=0``.  In training each conv runs after an explicit ``F.pad`` and
every BN takes batch statistics, as in the JAX module.

At eval the model folds its BNs (``layers.FoldsBN``), as HigherHRNet does:
every conv-BN pair (``_conv_bn_pairs``: the stem, each MBConv's expand,
depthwise and project convs, each transition's conv with its own bias, and
the HRNet stages' and head's pairs) runs as ``layers.conv_bn`` given its
pad: a stride-1 conv pads as its own padding, a stride-2 depthwise conv
takes the depthwise kernel's SAME pad, the stem's stride-2 dense conv an
explicit pad.  At bf16 each depthwise conv is one launch with its bias and
Swish (K6), the epilogue of every dense conv is one launch after cuDNN's
conv (K7: Swish in the backbone, the project's residual, ReLU in the
transitions and stages), and each squeeze-excitation is
``ops.squeeze_excite``'s two launches.  The SE's linears, the final
layers' and the transposed conv's weights and the head BN's affine are
stored once in the compute dtype (``layers.prepare_eval_``).  The whole
forward runs NCHW, the depthwise kernel's layout.  Channels-last stages,
as HigherHRNet runs them, are slower here (PERF.md): at these widths, no
multiple of 8, cuDNN copies each channels-last conv's operands through
channel-padded buffers.

The forward opens ``litepose.effhrnet.backbone`` (the stem and the MBConv
stack) with ``litepose.effhrnet.se`` inside it for each squeeze-excitation,
``litepose.hrnet.transition`` for each transition, the stages'
``litepose.hrnet.branches`` and ``.fuse`` (``run_stage``) and
``litepose.hrnet.head`` (``utils/spans.py``).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn as nn

from ..ops.squeeze_excite import squeeze_excite, squeeze_excite_ref
from ..utils.spans import span
from . import layers as L
from .higher_hrnet import (StageSpec, apply_higher_head, hrnet_pairs, make_higher_head,
                           make_stage, run_stage, stage_from_config)

# EfficientNet-B0 block settings: (expand, channels, repeats, stride, kernel)
# (copy of litepose_tpu/models/efficient_hrnet.py:EFFNET_SETTINGS)
EFFNET_SETTINGS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# exclusive end index (into the features list, the stem at 0) of the four
# feature taps per DEPTH_MULT (copy of DEPTH_TAPS)
DEPTH_TAPS = {
    0.483: (3, 4, 8, 11),
    0.578: (4, 6, 10, 14),
    0.694: (4, 6, 12, 16),
    0.833: (4, 6, 12, 17),
    1.0: (4, 6, 12, 17),
    1.1: (6, 9, 17, 24),
    1.2: (6, 9, 17, 24),
    1.4: (6, 9, 19, 27),
    1.8: (7, 11, 23, 33),
}


def _make_divisible(value, divisor=8):
    new_value = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if new_value < 0.9 * value:
        new_value += divisor
    return new_value


def _round_filters(filters, width_mult):
    if width_mult == 1.0:
        return filters
    return int(_make_divisible(filters * width_mult))


def _round_repeats(repeats, depth_mult):
    if depth_mult == 1.0:
        return repeats
    return int(math.ceil(depth_mult * repeats))


def _scale(c, scale_factor):
    return int(math.ceil(c * (1.2455 ** scale_factor)))


class EffHRNetSpec(NamedTuple):
    """Mirror of the JAX ``EffHRNetSpec``."""

    num_joints: int = 14
    tag_per_joint: bool = True
    with_ae_loss: Tuple[bool, ...] = (True, False)
    width_mult: float = 0.909
    depth_mult: float = 0.833
    scale_factor: int = -1
    final_conv_kernel: int = 1
    stage2: StageSpec = StageSpec(1, 2, "BASIC", (2, 2), (32, 64))
    stage3: StageSpec = StageSpec(3, 3, "BASIC", (2, 2, 2), (32, 64, 128))
    stage4: StageSpec = StageSpec(3, 4, "BASIC", (2, 2, 2, 2), (32, 64, 128, 256))
    num_deconvs: int = 1
    deconv_channels: Tuple[int, ...] = (32,)
    deconv_kernels: Tuple[int, ...] = (4,)
    deconv_num_basic_blocks: int = 2
    cat_output: Tuple[bool, ...] = (True,)

    @staticmethod
    def from_config(cfg) -> "EffHRNetSpec":
        e = cfg.MODEL.EXTRA
        return EffHRNetSpec(
            num_joints=cfg.MODEL.NUM_JOINTS,
            tag_per_joint=cfg.MODEL.TAG_PER_JOINT,
            with_ae_loss=tuple(cfg.LOSS.WITH_AE_LOSS),
            width_mult=cfg.MODEL.WIDTH_MULT,
            depth_mult=cfg.MODEL.DEPTH_MULT,
            scale_factor=cfg.MODEL.SCALE_FACTOR,
            final_conv_kernel=e.FINAL_CONV_KERNEL,
            stage2=stage_from_config(e.STAGE2),
            stage3=stage_from_config(e.STAGE3),
            stage4=stage_from_config(e.STAGE4),
            num_deconvs=e.DECONV.NUM_DECONVS,
            deconv_channels=tuple(e.DECONV.NUM_CHANNELS),
            deconv_kernels=tuple(e.DECONV.KERNEL_SIZE),
            deconv_num_basic_blocks=e.DECONV.NUM_BASIC_BLOCKS,
            cat_output=tuple(e.DECONV.CAT_OUTPUT),
        )

    def scaled_stage(self, st: StageSpec) -> StageSpec:
        return st._replace(num_channels=tuple(_scale(c, self.scale_factor)
                                              for c in st.num_channels))

    def final_out_channels(self, idx: int) -> int:
        dim_tag = self.num_joints if self.tag_per_joint else 1
        return self.num_joints + (dim_tag if self.with_ae_loss[idx] else 0)

    def backbone_plan(self) -> List[Tuple[int, int, int, int, int]]:
        """Per block (cin, cout, expand, kernel, stride); index 0 is the stem
        (expand 0)."""
        plan = [(3, _round_filters(32, self.width_mult), 0, 3, 2)]
        cin = plan[0][1]
        for t, c, n, s, k in EFFNET_SETTINGS:
            cout = _round_filters(c, self.width_mult)
            for i in range(_round_repeats(n, self.depth_mult)):
                plan.append((cin, cout, t, k, s if i == 0 else 1))
                cin = cout
        return plan

    def taps(self) -> Tuple[int, int, int, int]:
        return DEPTH_TAPS[self.depth_mult]


def _same_pad(kernel: int, stride: int):
    """TF-style SAME padding ((top, bottom), (left, right)): the odd pixel
    of an uneven overhang goes after (``_same_pad``)."""
    p = max(kernel - stride, 0)
    return ((p // 2, p - p // 2), (p // 2, p - p // 2))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(x)


class ConvBNSwish(nn.Sequential):
    """``Sequential(ZeroPad2d, conv, BN, Swish)`` with SAME padding: the pair
    as ``layers.conv_bn`` given the ``ZeroPad2d``'s pad."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        (pt, pb), (pl, pr) = _same_pad(k, stride)
        super().__init__(nn.ZeroPad2d((pl, pr, pt, pb)),
                         nn.Conv2d(cin, cout, k, stride, 0, groups=groups, bias=False),
                         L.bn2d(cout), Swish())

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return L.conv_bn(x, self[1], self[2], dtype, "silu", pad=self[0].padding)


class SqueezeExcitation(nn.Module):
    """``se``: ``Sequential(AdaptiveAvgPool2d, conv 1x1 (bias), Swish, conv
    1x1 (bias), Sigmoid)``; the mean in fp32 (float64 for a float64
    activation, which the JAX block, whose parity runs are fp32, never
    sees), the rest in the activation dtype, as the JAX block
    (``ops.squeeze_excite.squeeze_excite_ref``).  At bf16 eval with no
    gradient to carry, the op ``squeeze_excite`` (two kernels on a card),
    which may write its output into ``y``."""

    def __init__(self, hidden: int, reduced: int):
        super().__init__()
        self.se = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(hidden, reduced, 1),
                                Swish(), nn.Conv2d(reduced, hidden, 1), nn.Sigmoid())

    @staticmethod
    def _linear(conv: nn.Conv2d, dtype: torch.dtype):
        """(weight (out, in), bias) in ``dtype``: the stored copies at eval."""
        w = L.weight(conv, dtype)
        b = L.stored(conv, "cast_b")
        return w.view(w.shape[0], -1), conv.bias.to(dtype) if b is None else b

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        with span("litepose.effhrnet.se"):
            args = (*self._linear(self.se[1], y.dtype), *self._linear(self.se[3], y.dtype))
            if (not self.training and y.dtype == torch.bfloat16
                    and not (torch.is_grad_enabled() and y.requires_grad)):
                return squeeze_excite(y, *args)
            return squeeze_excite_ref(y, *args)


class MBConv(nn.Module):
    """MBConv: 1x1 expand (when expand > 1), kxk depthwise, SE, 1x1
    project + BN, residual when shape-preserving (``_mbconv``;
    drop-connect is inert at inference)."""

    def __init__(self, cin: int, cout: int, expand: int, kernel: int, stride: int):
        super().__init__()
        hidden = cin * expand
        layers = [ConvBNSwish(cin, hidden, 1)] if hidden != cin else []
        layers += [ConvBNSwish(hidden, hidden, kernel, stride, groups=hidden),
                   SqueezeExcitation(hidden, max(1, cin // 4)),
                   nn.Conv2d(hidden, cout, 1, bias=False), L.bn2d(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = cin == cout and stride == 1

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        *convs, se, project, bn = self.conv
        y = x
        for c in convs:
            y = c(y, dtype)
        return L.conv_bn(se(y), project, bn, dtype, residual=x if self.residual else None)

    def pairs(self):
        *convs, _, project, bn = self.conv
        return [(c[1], c[2]) for c in convs] + [(project, bn)]


class EfficientHRNet(L.FoldsBN, nn.Module):
    """Forward: ``x`` (B, 3, H, W) normalized images -> [(B, J+T, H/4, W/4),
    (B, J, H/2, W/2)] in ``out_dtype``; ``compute_dtype`` as HigherHRNet's.
    ``eval()`` folds the BNs (``fold_bn_``); after writing weights into a
    model in eval mode, call ``fold_bn_()`` again."""

    def __init__(self, spec: EffHRNetSpec, compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        plan = spec.backbone_plan()
        self.features = nn.ModuleList([
            ConvBNSwish(cin, cout, kernel, stride) if expand == 0
            else MBConv(cin, cout, expand, kernel, stride)
            for cin, cout, expand, kernel, stride in plan])
        tap_c = [plan[t - 1][1] for t in spec.taps()]

        sf = spec.scale_factor
        s32, s64, s128, s256 = (_scale(c, sf) for c in (32, 64, 128, 256))
        trans = {1: [(tap_c[0], s32), (tap_c[1], s64)],
                 2: [(s32, s32), (s64, s64), (tap_c[2], s128)],
                 3: [(s32, s32), (s64, s64), (s128, s128), (tap_c[3], s256)]}
        for t, branches in trans.items():
            for m, (cin, cout) in enumerate(branches, start=1):
                setattr(self, f"trans{t}_branch{m}",
                        nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1), L.bn2d(cout), nn.ReLU()))
        for n, st in ((2, spec.stage2), (3, spec.stage3), (4, spec.stage4)):
            scaled = spec.scaled_stage(st)
            modules, _ = make_stage(scaled, scaled.num_channels, 1, last_stage=n == 4)
            setattr(self, f"stage{n}", modules)
        self.final_layers, self.deconv_layers = make_higher_head(
            spec.scaled_stage(spec.stage4).num_channels[0], spec.final_out_channels,
            spec.final_conv_kernel,
            [_scale(c, sf) for c in spec.deconv_channels[:spec.num_deconvs]],
            spec.deconv_kernels, spec.deconv_num_basic_blocks, spec.cat_output)

    def _transitions(self) -> List[nn.Sequential]:
        return [m for name, m in self.named_children() if name.startswith("trans")]

    def _conv_bn_pairs(self):
        pairs = []
        for block in self.features:
            pairs += [(block[1], block[2])] if isinstance(block, ConvBNSwish) else block.pairs()
        return pairs + [(t[0], t[1]) for t in self._transitions()] + hrnet_pairs(self)

    def _trans(self, t: int, xs: List[torch.Tensor], dtype) -> List[torch.Tensor]:
        """Each branch's 3x3 conv (with its bias), BN and ReLU."""
        with span("litepose.hrnet.transition"):
            return [L.conv_bn(x, *getattr(self, f"trans{t}_branch{m}")[:2], dtype, "relu")
                    for m, x in enumerate(xs, start=1)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.compute_dtype
        ends = self.spec.taps()
        taps = []
        with span("litepose.effhrnet.backbone"):
            y = x
            for i, block in enumerate(self.features):
                y = block(y, dt)
                if i + 1 in ends:
                    taps.append(y)
        ys = run_stage(self.stage2, self._trans(1, taps[:2], dt), dt)
        ys = run_stage(self.stage3, self._trans(2, [ys[-2], ys[-1], taps[2]], dt), dt)
        ys = run_stage(self.stage4, self._trans(3, [ys[-3], ys[-2], ys[-1], taps[3]], dt), dt)
        with span("litepose.hrnet.head"):
            return apply_higher_head(self.final_layers, self.deconv_layers,
                                     self.spec.cat_output, ys[0], dt, self.out_dtype)


def init_efficient_hrnet(spec: EffHRNetSpec, generator: torch.Generator,
                         **model_kw) -> EfficientHRNet:
    """A freshly initialized ``EfficientHRNet`` in training mode, on the CPU
    (counterpart of ``init_efficient_hrnet``): ``layers.fan_in_init_``."""
    return L.fan_in_init_(EfficientHRNet(spec, **model_kw), generator).train()
