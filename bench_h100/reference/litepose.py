"""The plain reference of a LitePose forward with stage aggregation, in
fp32 PyTorch, read straight from the checkpoint's JAX pytree.

It follows the architecture as published (LitePose, arXiv:2205.01271;
mit-han-lab/litepose ``lib/models/pose_mobilenet.py``) and the JAX tree's
own layout, and shares no code with the program:

- conv kernels are HWIO, turned to OIHW here; every BN is applied as
  ``(y - mean) * rsqrt(var + eps) * scale + bias`` after its conv, never
  folded;
- a transposed conv is the JAX form, an lhs-dilated conv with the stored
  (spatially flipped) HWIO kernel: zeros between the input's pixels, the
  border padded by ``k - 1 - padding``, then a plain conv;
- the serving aggregation: the first stage's output upsampled (bilinear,
  half-pixel centres) to the second's size, the heatmaps of both averaged,
  the tags from the first.

``training = True`` takes each BN's statistics from the batch (biased
variance) and moves its running statistics by momentum 0.1 with the
unbiased variance, as a train-mode BN does.

``precision="fp8"`` is the control: every conv's input, weights and output
rounded to float8 e4m3 with a per-tensor scale (amax / 448), products
summed in fp32; in training the gradients that flow back through those
tensors are rounded so too.
Callers switch TF32 off (``fp32_exact``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
DECONV_PADDING = {4: (1, 0), 3: (1, 1), 2: (0, 0)}  # kernel -> (padding, output padding)
FP8_MAX = 448.0


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


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _FP8(torch.autograd.Function):
    """Rounds a tensor to float8 e4m3 under a per-tensor scale on the way
    forward, and its gradient the same way on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad)


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in fp32;
    in training its gradient is rounded so too."""
    return _FP8.apply(t)


def _tree_to(tree, device, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return torch.as_tensor(np.array(tree), device=device, dtype=dtype)


class Reference:
    """The forward of one configuration on ``device``.

    params, state: the checkpoint's JAX pytrees (numpy leaves); arch: the
    configuration's arch descriptor; ``num_joints`` joints and one tag map
    a joint from the first stage.  ``dtype`` float64 serves the CPU tests
    that hold the reference to the port's float64 path."""

    def __init__(self, params, state, arch: Dict[str, Any], num_joints: int,
                 device, precision: str = "fp32", dtype: torch.dtype = torch.float32):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, got {precision!r}")
        self.dtype = dtype
        self.p = _tree_to(params, device, dtype)
        self.s = _tree_to(state, device, dtype)
        self.arch = arch
        self.num_joints = num_joints
        self.device = torch.device(device)
        self.q = to_fp8 if precision == "fp8" else (lambda t: t)
        self.training = False

    # -- layers ---------------------------------------------------------------

    def conv(self, x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1,
             groups: int = 1) -> torch.Tensor:
        k = w_hwio.shape[0]
        w = w_hwio.permute(3, 2, 0, 1)
        return self.q(F.conv2d(self.q(x), self.q(w), None, stride, k // 2, 1, groups))

    def bn(self, y: torch.Tensor, p: Dict, s: Dict) -> torch.Tensor:
        if self.training:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            n = y.numel() // y.shape[1]
            with torch.no_grad():
                s["mean"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                s["var"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / (n - 1)))
        else:
            mean, var = s["mean"], s["var"]
        inv = torch.rsqrt(var + BN_EPS) * p["scale"]
        return (y - mean[:, None, None]) * inv[:, None, None] + p["bias"][:, None, None]

    def conv_bn(self, x, p, s, stride=1, groups=1, act=None) -> torch.Tensor:
        y = self.bn(self.conv(x, p["conv"]["w"], stride, groups), p["bn"], s["bn"])
        if act == "relu6":
            return y.clamp(0.0, 6.0)
        if act == "relu":
            return y.clamp(min=0.0)
        return y

    def deconv(self, x: torch.Tensor, w_hwio_flipped: torch.Tensor) -> torch.Tensor:
        k = w_hwio_flipped.shape[0]
        pad, out_pad = DECONV_PADDING[k]
        b, c, h, w = x.shape
        dilated = x.new_zeros((b, c, 2 * h - 1, 2 * w - 1))
        dilated[:, :, ::2, ::2] = self.q(x)
        lo, hi = k - 1 - pad, k - 1 - pad + out_pad
        dilated = F.pad(dilated, (lo, hi, lo, hi))
        return self.q(F.conv2d(dilated, self.q(w_hwio_flipped.permute(3, 2, 0, 1))))

    def sep(self, x: torch.Tensor, p: Dict, s: Dict) -> torch.Tensor:
        c = x.shape[1]
        y = self.conv_bn(x, p["dw"], s["dw"], groups=c, act="relu")
        return self.conv(y, p["pw"]["conv"]["w"])

    # -- the model --------------------------------------------------------------

    def stages(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Normalized (B, 3, H, W) fp32 images -> the two stage outputs."""
        p, s = self.p, self.s
        y = self.conv_bn(x, p["first"]["cbr0"], s["first"]["cbr0"], stride=2, act="relu6")
        y = self.conv_bn(y, p["first"]["cbr1"], s["first"]["cbr1"], groups=y.shape[1],
                         act="relu6")
        y = self.bn(self.conv(y, p["first"]["conv2"]["w"]), p["first"]["bn2"],
                    s["first"]["bn2"])
        feats = [y]
        for si, st in enumerate(self.arch["backbone_setting"]):
            for bi in range(st["num_blocks"]):
                bp, bs = p["stage"][si][bi], s["stage"][si][bi]
                stride = st["stride"] if bi == 0 else 1
                z = self.conv_bn(y, bp["inv"], bs["inv"], act="relu6")
                z = self.conv_bn(z, bp["depth"], bs["depth"], stride=stride,
                                 groups=z.shape[1], act="relu6")
                z = self.conv_bn(z, bp["point"], bs["point"])
                y = z + y if stride == 1 and z.shape[1] == y.shape[1] else z
            feats.append(y)

        outputs = []
        refined, raw = feats[-1], feats[-2]
        for i in range(len(self.arch["deconv_setting"])):
            nxt = self.deconv(refined, p["deconv_refined"][i]["w"]) \
                + self.deconv(raw, p["deconv_raw"][i]["w"])
            refined = self.bn(nxt, p["deconv_bn"][i], s["deconv_bn"][i]).clamp(min=0.0)
            raw = feats[-i - 3]
            if i > 0:
                outputs.append(self.sep(refined, p["final_refined"][i - 1],
                                        s["final_refined"][i - 1])
                               + self.sep(raw, p["final_raw"][i - 1], s["final_raw"][i - 1]))
        return outputs

    def normalize(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> ImageNet-normalized (B, 3, H, W)."""
        mean = torch.tensor(MEAN, device=self.device, dtype=self.dtype)[:, None, None]
        std = torch.tensor(STD, device=self.device, dtype=self.dtype)[:, None, None]
        x = images_u8.to(self.device).permute(0, 3, 1, 2).to(self.dtype)
        return (x / 255.0 - mean) / std

    def maps(self, images_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 (B, H, W, 3) -> det (B, J, h, w) and tag (B, J, 1, h, w),
        fp32, at the last stage's size."""
        first, last = self.stages(self.normalize(images_u8))
        first = F.interpolate(first, size=last.shape[-2:], mode="bilinear",
                              align_corners=False)
        j = self.num_joints
        det = (first[:, :j] + last[:, :j]) / 2.0
        return det, first[:, j:2 * j, None]

