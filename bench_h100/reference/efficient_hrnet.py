"""The plain reference of an EfficientHRNet forward with the serving stage
aggregation, in fp32 PyTorch, read straight from a reference
``pose_efficient_hrnet`` state dict.

It follows the published model (Neff, Sheth, Furgurson, Tabkhi,
"EfficientHRNet: Efficient Scaling for Lightweight High-Resolution
Multi-Person Pose Estimation", 2020) as mit-han-lab/litepose builds and runs
it (``lib/models/pose_efficient_hrnet.py``,
``experiments/crowd_pose/efficient_hrnet/H-1.yaml``), and imports neither
JAX nor either package of this repo:

- the backbone is EfficientNet-B0 (Tan and Le, 2019): a 3x3 stride-2
  conv-BN-Swish stem of 32 channels, then the MBConv blocks of ``blocks``
  ((expand, channels, repeats, stride, kernel) a row), their widths scaled
  by ``width_mult`` (rounded to multiples of 8, never below 90% of the
  scaled width) and their repeats by ``depth_mult`` (rounded up).  A block:
  a 1x1 expand conv-BN-Swish (where expand > 1), a kxk depthwise
  conv-BN-Swish, squeeze-excitation (the plane means, a 1x1 conv with bias
  to a quarter of the block's input width, Swish, a 1x1 conv with bias back,
  a sigmoid, the product), a 1x1 project conv-BN, and the block's input
  added where the shape is kept; drop-connect is inert at inference;
- every backbone conv pads as TensorFlow's SAME: ``max((ceil(n / s) - 1) s
  + k - n, 0)`` zeros along a side of n, the odd one after.  (The port pads
  ``max(k - s, 0)`` whatever n is, as the reference repo does; the two
  agree at even sizes, which every stride-2 conv of a 480 input sees);
- the feature taps are the outputs of the blocks before the exclusive ends
  ``taps`` (the stem is block 0);
- each transition branch is a 3x3 conv with its own bias, BN and ReLU, from
  the tap or the stage output the reference repo's forward gives it;
- the stages and the head are HigherHRNet's, at widths scaled by
  ``ceil(c * 1.2455 ** scale_factor)``, and run here as
  ``reference/higher_hrnet.py``'s ``Net`` runs them (its ``module``, the
  head composed of its ``conv``, ``deconv``, ``bn`` and ``block`` as its
  forward composes them);
- every BN is applied as ``(y - mean) * rsqrt(var + eps) * scale + bias``
  after its conv (and the conv's bias), never folded.

``spec`` is the model's layout as a configuration file holds it:
``{"width_mult", "depth_mult", "scale_factor", "stem_channels", "blocks",
"taps", "stages": [{"num_modules", "num_branches", "block", "num_blocks",
"num_channels"}] * 3, "final_conv_kernel", "deconv": {...}}``, the stages'
and deconv's widths unscaled, as the yaml gives them.

``precision="fp8"`` is the control: every conv's input, weights and output
rounded to float8 e4m3 with a per-tensor scale (amax / 448), products summed
in fp32.  ``Reference.maps`` switches TF32 off for its forward and runs the
serving aggregation of ``reference/higher_hrnet.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from .higher_hrnet import Net
from .higher_hrnet import Reference as HRNetReference
from .higher_hrnet import peak_shift, to_fp8  # noqa: F401  (the cell's shift and control)


def make_divisible(value: float, divisor: int = 8) -> int:
    new = max(divisor, int(value + divisor / 2) // divisor * divisor)
    return new + divisor if new < 0.9 * value else new


def scaled_width(c: int, width_mult: float) -> int:
    return c if width_mult == 1.0 else int(make_divisible(c * width_mult))


def scaled_repeats(n: int, depth_mult: float) -> int:
    return n if depth_mult == 1.0 else int(math.ceil(depth_mult * n))


def stage_width(c: int, scale_factor: int) -> int:
    return int(math.ceil(c * (1.2455 ** scale_factor)))


def backbone_plan(spec: Dict) -> List[Tuple[int, int, int, int, int]]:
    """Per block (cin, cout, expand, kernel, stride); block 0 is the stem
    (expand 0)."""
    wm, dm = spec["width_mult"], spec["depth_mult"]
    stem = scaled_width(spec["stem_channels"], wm)
    plan = [(3, stem, 0, 3, 2)]
    cin = stem
    for expand, channels, repeats, stride, kernel in spec["blocks"]:
        cout = scaled_width(channels, wm)
        for i in range(scaled_repeats(repeats, dm)):
            plan.append((cin, cout, expand, kernel, stride if i == 0 else 1))
            cin = cout
    return plan


def scaled_stages(spec: Dict) -> List[Dict]:
    return [dict(st, num_channels=[stage_width(c, spec["scale_factor"])
                                   for c in st["num_channels"]]) for st in spec["stages"]]


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """TensorFlow's SAME along a side of n: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class EffNet(Net):
    """The forward of one state dict: ``Net``'s conv, BN, blocks, modules
    and deconv, and the backbone and transitions above."""

    def same_conv(self, x: torch.Tensor, name: str, k: int, stride: int = 1,
                  groups: int = 1) -> torch.Tensor:
        """A backbone conv with SAME padding and no bias; a weight of another
        shape is refused."""
        w = self.sd[name + ".weight"]
        if tuple(w.shape) != (w.shape[0], x.shape[1] // groups, k, k):
            raise ValueError(f"{name}: a {k}x{k} kernel over {x.shape[1] // groups} channels, "
                             f"got weights of {tuple(w.shape)}")
        (pt, pb), (pl, pr) = (same_pad(n, k, stride) for n in x.shape[-2:])
        x = F.pad(x, (pl, pr, pt, pb))
        return self.q(F.conv2d(self.q(x), self.q(w), None, stride, 0, 1, groups))

    def conv_bn_swish(self, x: torch.Tensor, name: str, k: int, stride: int = 1,
                      groups: int = 1) -> torch.Tensor:
        return swish(self.bn(self.same_conv(x, name + ".1", k, stride, groups), name + ".2"))

    def squeeze_excite(self, y: torch.Tensor, name: str) -> torch.Tensor:
        s = y.mean(dim=(2, 3), keepdim=True)
        s = swish(self.conv(s, name + ".se.1", 1, bias=True))
        return y * torch.sigmoid(self.conv(s, name + ".se.3", 1, bias=True))

    def mbconv(self, x: torch.Tensor, name: str, cin: int, cout: int, expand: int, k: int,
               stride: int) -> torch.Tensor:
        i, y = 0, x
        if expand != 1:
            y = self.conv_bn_swish(y, f"{name}.conv.0", 1)
            i = 1
        y = self.conv_bn_swish(y, f"{name}.conv.{i}", k, stride, groups=y.shape[1])
        y = self.squeeze_excite(y, f"{name}.conv.{i + 1}")
        y = self.bn(self.same_conv(y, f"{name}.conv.{i + 2}", 1), f"{name}.conv.{i + 3}")
        return y + x if cin == cout and stride == 1 else y

    def transition(self, xs: List[torch.Tensor], t: int) -> List[torch.Tensor]:
        return [self.conv_bn_bias(x, f"trans{t}_branch{m}") for m, x in enumerate(xs, start=1)]

    def conv_bn_bias(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.bn(self.conv(x, name + ".0", 3, bias=True), name + ".1").clamp(min=0.0)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Normalized (B, 3, H, W) fp32 images -> the outputs at 1/4 and at
        each deconv stage's size."""
        spec = self.spec
        taps, ends = [], set(spec["taps"])
        for i, (cin, cout, expand, k, stride) in enumerate(backbone_plan(spec)):
            x = (self.conv_bn_swish(x, f"features.{i}", k, stride) if expand == 0
                 else self.mbconv(x, f"features.{i}", cin, cout, expand, k, stride))
            if i + 1 in ends:
                taps.append(x)
        stages = scaled_stages(spec)
        ys = taps[:2]
        for n, st in enumerate(stages, start=2):
            ys = self.transition(ys if n == 2 else ys + [taps[n - 1]], n - 1)
            for m in range(st["num_modules"]):
                last = n == 4 and m == st["num_modules"] - 1
                ys = self.module(ys, f"stage{n}.{m}", st, 1 if last else st["num_branches"])
        return self.head(ys[0])

    def head(self, x: torch.Tensor) -> List[torch.Tensor]:
        """HigherHRNet's head, as ``Net.forward`` composes it."""
        dc, fk = self.spec["deconv"], self.spec["final_conv_kernel"]
        y = self.conv(x, "final_layers.0", fk, bias=True)
        outputs = [y]
        for i in range(dc["num_deconvs"]):
            if dc["cat_output"][i]:
                x = torch.cat([x, y], dim=1)
            x = self.deconv(x, f"deconv_layers.{i}.0.0", dc["kernel_size"][i])
            x = self.bn(x, f"deconv_layers.{i}.0.1").clamp(min=0.0)
            width = stage_width(dc["num_channels"][i], self.spec["scale_factor"])
            for k in range(dc["num_basic_blocks"]):
                x = self.block(x, f"deconv_layers.{i}.{k + 1}.0", "BASIC", width)
            y = self.conv(x, f"final_layers.{i + 1}", fk, bias=True)
            outputs.append(y)
        return outputs


class Reference(HRNetReference):
    """The serving maps of one state dict on ``device``: ``state_dict`` with
    the reference's parameter names (a ``module.`` prefix is dropped),
    ``spec`` as above, ``num_joints`` joints and one tag map a joint from
    the 1/4 output; ``maps`` and ``normalize`` are HigherHRNet's."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], spec: Dict, num_joints: int,
                 device, precision: str = "fp32"):
        super().__init__(state_dict, spec, num_joints, device, precision)
        self.net = EffNet(self.net.sd, spec, self.net.q)
