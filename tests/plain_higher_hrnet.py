"""The plain reference of a HigherHRNet forward with the serving stage
aggregation, in fp32 PyTorch, read straight from a reference
``PoseHigherResolutionNet`` state dict.

It follows the published model (Cheng et al., "HigherHRNet", CVPR 2020,
arXiv:1908.10357) as the reference repo builds and runs it
(HRNet/HigherHRNet-Human-Pose-Estimation ``lib/models/pose_higher_hrnet.py``),
imports neither JAX nor either package of this repo, and shares no code
with them:

- every BN is applied as ``(y - mean) * rsqrt(var + eps) * scale + bias``
  after its conv, never folded; each conv's kernel size is the reference
  repo's (3x3 padded 1, 1x1 padded 0; the final layers' and the transposed
  convs' from ``spec``), not read from the weights;
- a transition that makes a branch reads the LAST branch of the stage
  before it, as the reference repo's forward does (the paper draws it from
  the branch above); a branch whose width does not change passes as it is;
- the fuse sums the branches in branch order, a lower resolution through a
  1x1 conv-BN and a nearest upsample, a higher one through stride-2 3x3
  conv-BNs (ReLU between them), then ReLU;
- the head: the 1/4 prediction (a conv with bias), then per deconv stage the
  features concatenated with that prediction where ``cat_output``, a 2x
  transposed conv, BN, ReLU, the basic blocks and the stage's prediction;
- the serving aggregation: the 1/4 output resized (bilinear, half-pixel
  centres) to the last output's size, the heatmaps of both averaged, the
  tags taken from the resized 1/4 output.

``spec`` is the model's layout as a configuration file holds it:
``{"stem_inplanes", "stages": [{"num_modules", "num_branches", "block",
"num_blocks", "num_channels"}] * 3, "final_conv_kernel", "deconv":
{"num_deconvs", "num_channels", "kernel_size", "num_basic_blocks",
"cat_output"}}``.

``precision="fp8"`` is the control: every conv's input, weights and output
rounded to float8 e4m3 with a per-tensor scale (amax / 448), products summed
in fp32.  ``Reference.maps`` switches TF32 off for its forward.

The benchmark holds a copy of this file (``bench_h100/reference/
higher_hrnet.py``); the two give the same outputs bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
DECONV_PADDING = {4: (1, 0), 3: (1, 1), 2: (0, 0)}  # kernel -> (padding, output padding)
FP8_MAX = 448.0
EXPANSION = {"BASIC": 1, "BOTTLENECK": 4}  # a block's output width over its planes


@contextlib.contextmanager
def fp32_exact():
    """fp32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Net:
    """The forward of one state dict: ``sd`` name -> tensor (prefixes
    stripped), on one device, in fp32; ``q`` rounds each conv's operands
    (the identity, or ``to_fp8``).  Kernel sizes, strides, block kinds and
    where a downsample or a transition conv runs come from this code and
    ``spec``, as the reference repo builds the model; a weight of another
    kernel size is refused."""

    def __init__(self, sd: Mapping[str, torch.Tensor], spec: Dict,
                 q: Callable[[torch.Tensor], torch.Tensor]):
        self.sd = sd
        self.spec = spec
        self.q = q

    def weight(self, name: str, k: int) -> torch.Tensor:
        w = self.sd[name + ".weight"]
        if tuple(w.shape[-2:]) != (k, k):
            raise ValueError(f"{name}: a {k}x{k} kernel, got weights of {tuple(w.shape)}")
        return w

    def conv(self, x: torch.Tensor, name: str, k: int, stride: int = 1,
             bias: bool = False) -> torch.Tensor:
        y = self.q(F.conv2d(self.q(x), self.q(self.weight(name, k)), None, stride, k // 2))
        return y + self.sd[name + ".bias"][:, None, None] if bias else y

    def bn(self, y: torch.Tensor, name: str) -> torch.Tensor:
        sd = self.sd
        inv = torch.rsqrt(sd[name + ".running_var"] + BN_EPS) * sd[name + ".weight"]
        return ((y - sd[name + ".running_mean"][:, None, None]) * inv[:, None, None]
                + sd[name + ".bias"][:, None, None])

    def conv_bn(self, x: torch.Tensor, conv: str, bn: str, k: int, stride: int = 1,
                relu: bool = False) -> torch.Tensor:
        y = self.bn(self.conv(x, conv, k, stride), bn)
        return y.clamp(min=0.0) if relu else y

    def block(self, x: torch.Tensor, name: str, kind: str, planes: int) -> torch.Tensor:
        """A BasicBlock or a Bottleneck (``kind``) of ``planes``, with a 1x1
        conv-BN downsample where the width changes."""
        if kind == "BOTTLENECK":
            cout = planes * 4
            y = self.conv_bn(x, name + ".conv1", name + ".bn1", 1, relu=True)
            y = self.conv_bn(y, name + ".conv2", name + ".bn2", 3, relu=True)
            y = self.conv_bn(y, name + ".conv3", name + ".bn3", 1)
        else:
            cout = planes
            y = self.conv_bn(x, name + ".conv1", name + ".bn1", 3, relu=True)
            y = self.conv_bn(y, name + ".conv2", name + ".bn2", 3)
        if x.shape[1] != cout:
            x = self.conv_bn(x, name + ".downsample.0", name + ".downsample.1", 1)
        return (y + x).clamp(min=0.0)

    def transition(self, xs: List[torch.Tensor], name: str,
                   widths: List[int]) -> List[torch.Tensor]:
        """To a stage of branch ``widths``: a branch of the same width passes,
        one of another width is a 3x3 conv-BN-ReLU, a new one a chain of
        stride-2 3x3 conv-BN-ReLUs, each from the last branch."""
        out = []
        for i, c in enumerate(widths):
            if i < len(xs):
                out.append(xs[i] if xs[i].shape[1] == c else
                           self.conv_bn(xs[-1], f"{name}.{i}.0", f"{name}.{i}.1", 3, relu=True))
                continue
            y = xs[-1]
            for k in range(i + 1 - len(xs)):
                y = self.conv_bn(y, f"{name}.{i}.{k}.0", f"{name}.{i}.{k}.1", 3, stride=2,
                                 relu=True)
            out.append(y)
        return out

    def module(self, xs: List[torch.Tensor], name: str, st: Dict,
               rows: int) -> List[torch.Tensor]:
        """One module: its branches, then ``rows`` fused outputs (1 for the
        last module of the last stage, else one a branch)."""
        n = st["num_branches"]
        ys = []
        for b in range(n):
            y = xs[b]
            for k in range(st["num_blocks"][b]):
                y = self.block(y, f"{name}.branches.{b}.{k}", st["block"], st["num_channels"][b])
            ys.append(y)
        if n == 1:
            return ys
        fused = []
        for i in range(rows):
            acc = None
            for j in range(n):
                f = f"{name}.fuse_layers.{i}.{j}"
                if j == i:
                    z = ys[j]
                elif j > i:
                    z = self.conv_bn(ys[j], f + ".0", f + ".1", 1)
                    z = z.repeat_interleave(2 ** (j - i), dim=2).repeat_interleave(2 ** (j - i),
                                                                                   dim=3)
                else:
                    z = ys[j]
                    for k in range(i - j):
                        z = self.conv_bn(z, f"{f}.{k}.0", f"{f}.{k}.1", 3, stride=2,
                                         relu=k < i - j - 1)
                acc = z if acc is None else acc + z
            fused.append(acc.clamp(min=0.0))
        return fused

    def deconv(self, x: torch.Tensor, name: str, k: int) -> torch.Tensor:
        pad, out_pad = DECONV_PADDING[k]
        w = self.weight(name, k)
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), None, 2, pad, out_pad))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Normalized (B, 3, H, W) fp32 images -> the outputs at 1/4 and at
        each deconv stage's size."""
        spec = self.spec
        y = self.conv_bn(x, "conv1", "bn1", 3, stride=2, relu=True)
        y = self.conv_bn(y, "conv2", "bn2", 3, stride=2, relu=True)
        for k in range(4):
            y = self.block(y, f"layer1.{k}", "BOTTLENECK", spec["stem_inplanes"])
        ys = [y]
        stages = spec["stages"]
        for n, st in enumerate(stages, start=2):
            widths = [c * EXPANSION[st["block"]] for c in st["num_channels"]]
            ys = self.transition(ys, f"transition{n - 1}", widths)
            for m in range(st["num_modules"]):
                last = n == len(stages) + 1 and m == st["num_modules"] - 1
                ys = self.module(ys, f"stage{n}.{m}", st, 1 if last else st["num_branches"])
        dc, fk = spec["deconv"], spec["final_conv_kernel"]
        x = ys[0]
        y = self.conv(x, "final_layers.0", fk, bias=True)
        outputs = [y]
        for i in range(dc["num_deconvs"]):
            if dc["cat_output"][i]:
                x = torch.cat([x, y], dim=1)
            x = self.deconv(x, f"deconv_layers.{i}.0.0", dc["kernel_size"][i])
            x = self.bn(x, f"deconv_layers.{i}.0.1").clamp(min=0.0)
            for k in range(dc["num_basic_blocks"]):
                x = self.block(x, f"deconv_layers.{i}.{k + 1}.0", "BASIC",
                               dc["num_channels"][i])
            y = self.conv(x, f"final_layers.{i + 1}", fk, bias=True)
            outputs.append(y)
        return outputs


class Reference:
    """The serving maps of one state dict on ``device``: ``state_dict`` with
    the reference's parameter names (a ``module.`` prefix is dropped),
    ``spec`` as above, ``num_joints`` joints and one tag map a joint from
    the 1/4 output."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], spec: Dict, num_joints: int,
                 device, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, got {precision!r}")
        self.device = torch.device(device)
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in state_dict.items()}
        sd = {k: v.detach().to(self.device, torch.float32) for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
        self.net = Net(sd, spec, to_fp8 if precision == "fp8" else (lambda t: t))
        self.num_joints = num_joints

    def normalize(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> ImageNet-normalized fp32 (B, 3, H, W)."""
        mean = torch.tensor(MEAN, device=self.device)[:, None, None]
        std = torch.tensor(STD, device=self.device)[:, None, None]
        x = images_u8.to(self.device).permute(0, 3, 1, 2).float()
        return (x / 255.0 - mean) / std

    def outputs(self, images_u8: torch.Tensor) -> List[torch.Tensor]:
        with fp32_exact(), torch.no_grad():
            return self.net.forward(self.normalize(images_u8))

    def maps(self, images_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 (B, H, W, 3) -> det (B, J, h, w) and tag (B, J, 1, h, w),
        fp32, at the last output's size."""
        outs = self.outputs(images_u8)
        first, last = outs[0], outs[-1]
        with torch.no_grad():
            first = F.interpolate(first, size=last.shape[-2:], mode="bilinear",
                                  align_corners=False)
        j = self.num_joints
        return (first[:, :j] + last[:, :j]) / 2.0, first[:, j:2 * j, None]


def peak_shift(det: torch.Tensor, share: float = 1e-3, threshold: float = 0.1) -> torch.Tensor:
    """Per joint, the shift that leaves ``share`` of the pixels of the
    aggregated maps ``det`` (B, J, H, W) above ``threshold``: added to each
    output's heatmap bias, it shifts ``det`` by as much, as a trained
    model's few peaks stand above the threshold."""
    planes = det.float().transpose(0, 1).flatten(1).cpu()
    k = max(1, round((1.0 - share) * planes.shape[1]))
    return threshold - torch.kthvalue(planes, k, dim=1).values
