"""SuperLitePose, the one-shot NAS supernet, as an ``nn.Module`` (counterpart
of ``litepose_tpu/models/super_litepose.py``).

The supernet holds every tensor at the search space's maximal widths and
runs a sampled sub-architecture by *masking* channels, not by slicing them:
the arch is an int64 descriptor ``[input_channel, c0..c3, d0..d2]`` of
active-channel counts (``arch_to_mask_desc``), passed to ``forward`` as a
tensor on the model's device, so one module serves every width of the space
and nothing waits on the host.

* A conv of a zero-masked input equals the conv of the sliced input, and
  masking a conv's output equals slicing its out-channels.
* ``masked_bn`` is not ``nn.BatchNorm2d``: it normalizes with the biased
  batch variance, moves the running statistics (unbiased variance,
  momentum 0.1) only where the mask is set, re-masks after the affine so
  the bias cannot leak into inactive channels, and computes in fp32.  Its
  statistics live in ``nn.BatchNorm2d`` modules whose forward it never
  calls, so the reference state-dict names stay.
* The supernet does not fold BN into the conv: after the conv it computes
  ``(x - mean) * rsqrt(var + eps) * scale + bias`` even at eval, the JAX
  ``masked_bn`` order.  The stem's two conv-BN-ReLU6 are not masked and
  take the fixed net's layers.
* The final ``SepConv2d`` heads read masked inputs, and their depthwise BN
  is masked by the width of that input, as the reference's sliced super
  layers are: otherwise an inactive channel's ``relu(bias - mean * inv)``
  would reach the pointwise conv, and the supernet at an arch would not be
  its extracted subnet once training has moved those BNs.  The JAX
  supernet leaves them unmasked (ROADMAP Queue 3); where their inactive
  channels are at the BN identity the two agree.
* Kernel elasticity: a block at kernel 5 or 3 center-crops its 7x7
  depthwise weight and applies the block's learned ``lin5`` / ``lin3`` as
  ``W @ flat + b`` over the (k*k, C) kernel, k*k in row-major (kh, kw).
* Every block of ``dims.stage_blocks`` runs whatever the arch says, as in
  JAX; the expanded width is ``active input * expansion``.

``extract_subnet`` slices the leading channels into the port's fixed
``LitePose``; ``inject_subnet`` writes a ``LitePose`` back into them;
``reorganize_weights`` sorts channels by the L1 importance of their
consumers, permuting the head's raw-branch consumers too.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..arch import ArchConfig, ArchManager, StageConfig
from . import layers as L
from .litepose import STEM_CHANNELS, LitePose, ModelSpec


class SuperDims(NamedTuple):
    """Static maximal dimensions of the supernet (from the search space)."""

    input_channel: int
    stage_channels: Tuple[int, ...]
    stage_blocks: Tuple[int, ...]
    stage_strides: Tuple[int, ...]
    deconv: Tuple[int, ...]
    kernel: int = 7
    expansion: int = 6

    @staticmethod
    def from_manager(m: ArchManager) -> "SuperDims":
        return SuperDims(
            input_channel=m.input_channel,
            stage_channels=tuple(c for c, _, _ in m.stage_setting),
            stage_blocks=tuple(n for _, n, _ in m.stage_setting),
            stage_strides=tuple(s for _, _, s in m.stage_setting),
            deconv=tuple(m.deconv_setting),
        )

    def block_in_max(self, si: int, bi: int) -> int:
        if bi == 0:
            return self.input_channel if si == 0 else self.stage_channels[si - 1]
        return self.stage_channels[si]

    def feat_max(self, si: int, bi: int) -> int:
        # the reference supernet's round(inplanes * expansion), no rounding to 8
        return round(self.block_in_max(si, bi) * self.expansion)

    def max_arch(self, img_size: int = 512) -> ArchConfig:
        """The arch of every maximal width (the layout of the state dict)."""
        return ArchConfig(
            img_size=img_size, input_channel=self.input_channel,
            deconv_setting=tuple(self.deconv),
            backbone_setting=tuple(
                StageConfig(num_blocks=n, stride=s, channel=c,
                            block_setting=tuple((self.expansion, self.kernel) for _ in range(n)))
                for c, n, s in zip(self.stage_channels, self.stage_blocks, self.stage_strides)))


def arch_to_mask_desc(arch: ArchConfig) -> torch.Tensor:
    """Active-channel counts as an int64 vector
    ``[input_channel, c0..c3, d0..d2]``."""
    vals = [arch.input_channel] + [st.channel for st in arch.backbone_setting]
    return torch.tensor(vals + list(arch.deconv_setting), dtype=torch.int64)


def _mask(n_active: torch.Tensor, width: int) -> torch.Tensor:
    """fp32 (width,) ones on the first ``n_active`` channels."""
    return (torch.arange(width, device=n_active.device) < n_active).float()


def _chan(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return m.to(dtype)[:, None, None]


def masked_bn(bn: nn.BatchNorm2d, x: torch.Tensor, mask: torch.Tensor,
              train: bool) -> torch.Tensor:
    """BN whose running statistics move, and whose output exists, only on
    active channels (JAX ``masked_bn``); fp32 inside (float64 for a float64
    input), ``x.dtype`` out.  In training the statistics are updated in
    place."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if train:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        with torch.no_grad():
            live = mask > 0
            m = L.BN_MOMENTUM
            unbiased = var.detach() * (n / max(n - 1, 1))
            bn.running_mean.copy_(torch.where(
                live, (1 - m) * bn.running_mean + m * mean.detach(), bn.running_mean))
            bn.running_var.copy_(torch.where(
                live, (1 - m) * bn.running_var + m * unbiased, bn.running_var))
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = torch.rsqrt(var + L.BN_EPS) * bn.weight
    y = ((x32 - mean[:, None, None]) * inv[:, None, None] + bn.bias[:, None, None]) \
        * mask[:, None, None]
    return y.to(x.dtype)


def crop_kernel(w: torch.Tensor, lin: nn.Linear, kernel: int) -> torch.Tensor:
    """The (C, 1, 7, 7) depthwise weight center-cropped to ``kernel`` and
    transformed by ``lin`` (``W @ flat + b`` over the row-major (k*k, C)
    flattening), as (C, 1, k, k)."""
    kmax = w.shape[-1]
    lo = kmax // 2 - kernel // 2
    hi = kmax // 2 + kernel // 2 + 1
    c = w.shape[0]
    flat = w[:, 0, lo:hi, lo:hi].reshape(c, kernel * kernel).t()
    flat = lin.weight @ flat + lin.bias[:, None]
    return flat.t().reshape(c, 1, kernel, kernel)


class SuperBlock(nn.Module):
    """A masked inverted residual at max width (reference ``InvBottleneck``
    names, plus the learned 7->5 / 7->3 kernel transforms)."""

    def __init__(self, cin: int, feat: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.inv = L.ConvBNReLU6(cin, feat, 1)
        self.depth_conv = L.ConvBNReLU6(feat, feat, kernel, stride, groups=feat)
        self.point_conv = L.ConvBNReLU6(feat, cout, 1, act=False)
        self.lin5 = nn.Linear(25, 25)
        self.lin3 = nn.Linear(9, 9)
        self.stride = stride

    def forward(self, x: torch.Tensor, in_n: torch.Tensor, out_n: torch.Tensor,
                expansion: int, residual: bool, kernel: int, dtype: torch.dtype) -> torch.Tensor:
        train = self.training
        feat_mask = _mask(in_n * expansion, self.inv[0].out_channels)
        out_mask = _mask(out_n, self.point_conv[0].out_channels)

        y = L.conv(x, self.inv[0], dtype) * _chan(feat_mask, dtype)
        y = torch.clamp(masked_bn(self.inv[1], y, feat_mask, train), 0.0, 6.0)

        w = self.depth_conv[0].weight
        if kernel < w.shape[-1]:
            w = crop_kernel(w, self.lin5 if kernel == 5 else self.lin3, kernel)
        y = F.conv2d(y.to(dtype), w.to(dtype), None, self.stride, w.shape[-1] // 2,
                     1, w.shape[0])
        y = y * _chan(feat_mask, y.dtype)
        y = torch.clamp(masked_bn(self.depth_conv[1], y, feat_mask, train), 0.0, 6.0)

        y = L.conv(y, self.point_conv[0], dtype) * _chan(out_mask, dtype)
        y = masked_bn(self.point_conv[1], y, out_mask, train)
        return y + x if residual else y


class SuperLitePose(nn.Module):
    """The supernet at maximal widths.  ``forward(x, desc, kernels=None)``:
    ``x`` (B, 3, H, W) normalized images, ``desc`` the int64 mask
    descriptor (default: the max arch), ``kernels`` optional per-stage
    per-block kernel sizes (default 7) -> the list of fp32 NCHW stage
    outputs at max width (inactive channels are zero).

    compute_dtype: conv compute type (bf16, or fp32 for parity), the JAX
    ``Policy``.  Nothing is folded or cached from the weights, so a new
    desc or new BN statistics take effect at the next call."""

    def __init__(self, spec: ModelSpec, dims: SuperDims,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.spec = spec
        self.dims = dims
        self.compute_dtype = compute_dtype
        self.with_skips = True

        ic = dims.input_channel
        self.first = nn.ModuleList([
            L.ConvBNReLU6(3, STEM_CHANNELS, 3, stride=2),
            L.ConvBNReLU6(STEM_CHANNELS, STEM_CHANNELS, 3, groups=STEM_CHANNELS),
            nn.Conv2d(STEM_CHANNELS, ic, 1, bias=False),
            L.bn2d(ic),
        ])
        stages = []
        for si, (c, n, s) in enumerate(zip(dims.stage_channels, dims.stage_blocks,
                                           dims.stage_strides)):
            stages.append(nn.ModuleList([
                SuperBlock(dims.block_in_max(si, bi), dims.feat_max(si, bi), c, dims.kernel,
                           s if bi == 0 else 1) for bi in range(n)]))
        self.stage = nn.ModuleList(stages)

        channels = [ic] + list(dims.stage_channels)
        inplanes = channels[-1]
        refined, raw, bnrelu = [], [], []
        for i in range(spec.num_deconv_layers):
            kd = spec.deconv_kernels[i]
            refined.append(L.make_deconv(inplanes, dims.deconv[i], kd))
            raw.append(L.make_deconv(channels[-i - 2], dims.deconv[i], kd))
            bnrelu.append(nn.Sequential(L.bn2d(dims.deconv[i]), nn.ReLU()))
            inplanes = dims.deconv[i]
        self.deconv_refined = nn.ModuleList(refined)
        self.deconv_raw = nn.ModuleList(raw)
        self.deconv_bnrelu = nn.ModuleList(bnrelu)
        self.final_refined = nn.ModuleList([
            L.SepConv2d(dims.deconv[i], cout, 5)
            for i, cout in enumerate(spec.final_channels(), start=1)])
        self.final_raw = nn.ModuleList([
            L.SepConv2d(channels[-i - 3], cout, 5)
            for i, cout in enumerate(spec.final_channels(), start=1)])
        self.register_buffer("max_desc", arch_to_mask_desc(dims.max_arch()), persistent=False)

    def forward(self, x: torch.Tensor, desc: Optional[torch.Tensor] = None,
                kernels: Optional[Sequence[Sequence[int]]] = None) -> List[torch.Tensor]:
        dt, dims, train = self.compute_dtype, self.dims, self.training
        desc = self.max_desc if desc is None else torch.as_tensor(desc).to(x.device)
        n_st = len(dims.stage_channels)
        in_n, stage_n, deconv_n = desc[0], desc[1:1 + n_st], desc[1 + n_st:]

        y = self.first[1](self.first[0](x, dt), dt)
        stem_mask = _mask(in_n, dims.input_channel)
        y = L.conv(y, self.first[2], dt) * _chan(stem_mask, dt)
        y = masked_bn(self.first[3], y, stem_mask, train)

        x_list = [y]
        cur_n = in_n
        for si, blocks in enumerate(self.stage):
            for bi, block in enumerate(blocks):
                k = dims.kernel if kernels is None else kernels[si][bi]
                y = block(y, cur_n, stage_n[si], dims.expansion, bi > 0, k, dt)
                cur_n = stage_n[si]
            x_list.append(y)

        masks = [stem_mask] + [_mask(n, c) for n, c in zip(stage_n, dims.stage_channels)]
        outputs = []
        input_refined, input_raw = x_list[-1], x_list[-2]
        for i in range(self.spec.num_deconv_layers):
            d_mask = _mask(deconv_n[i], dims.deconv[i])
            nxt = L.deconv(input_refined, self.deconv_refined[i], dt)
            nxt = nxt + L.deconv(input_raw, self.deconv_raw[i], dt)
            nxt = nxt * _chan(d_mask, nxt.dtype)
            input_refined = torch.relu(masked_bn(self.deconv_bnrelu[i][0], nxt, d_mask, train))
            input_raw = x_list[-i - 3]
            if i > 0:
                out = self._head(self.final_refined[i - 1], input_refined, d_mask) \
                    + self._head(self.final_raw[i - 1], input_raw, masks[-i - 3])
                outputs.append(out.float())
        return outputs

    def _head(self, sep: L.SepConv2d, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """A final ``SepConv2d`` whose depthwise BN is masked by its input's
        active width; at eval the fixed net's folded conv-BN, then the mask."""
        conv, bn, dt = sep.conv[0], sep.conv[1], self.compute_dtype
        if self.training:
            y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding,
                         conv.dilation, conv.groups)
            y = masked_bn(bn, y, mask, True)
        else:
            y = L.conv_bn(x, conv, bn, dt) * _chan(mask, dt)
        return L.conv(torch.relu(y), sep.conv[3], dt)


def init_super_litepose(spec: ModelSpec, dims: SuperDims, generator: torch.Generator,
                        **model_kw) -> SuperLitePose:
    """A freshly initialized supernet in training mode, on the CPU (the
    counterpart of ``init_super_litepose``): conv kernels uniform in
    +-sqrt(3 / fan_in) as ``init_litepose`` draws them, each ``lin5`` /
    ``lin3`` weight the identity plus N(0, 0.01^2) with a zero bias, BNs at
    their identities."""
    model = SuperLitePose(spec, dims, **model_kw)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                n = m.in_features
                m.weight.copy_(torch.randn((n, n), generator=generator) * 0.01 + torch.eye(n))
                m.bias.zero_()
                continue
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
            elif isinstance(m, nn.Conv2d):
                fan_in = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
            else:
                continue
            bound = math.sqrt(3.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
    return model.train()


# -- sub-network extraction, injection and channel re-organization ------------


def _block_kernels(arch: ArchConfig) -> dict:
    """{depthwise weight name: kernel} of an arch's blocks."""
    return {f"stage.{si}.{bi}.depth_conv.0.weight": st.block_setting[bi][1]
            for si, st in enumerate(arch.backbone_setting) for bi in range(st.num_blocks)}


def extract_subnet(supernet: SuperLitePose, arch: ArchConfig) -> LitePose:
    """The fixed ``LitePose`` of ``arch`` holding the supernet's leading
    channel slices (the JAX ``extract_subnet``; kernel-cropped depthwise
    weights go through the block's ``lin5`` / ``lin3``), with the
    supernet's compute dtype, on its device, in eval mode (BNs folded)."""
    sub = LitePose(supernet.spec, arch, compute_dtype=supernet.compute_dtype)
    src = supernet.state_dict()
    kernels = _block_kernels(arch)
    kmax = supernet.dims.kernel
    sd = {}
    with torch.no_grad():
        for name, t in sub.state_dict().items():
            w = src[name]
            k = kernels.get(name, kmax)
            if k < kmax:
                block = supernet.get_submodule(name.rsplit(".", 3)[0])
                w = crop_kernel(w, block.lin5 if k == 5 else block.lin3, k)
            sd[name] = w[tuple(slice(0, n) for n in t.shape)].clone()
    sub.load_state_dict(sd, strict=True)
    return sub.to(src["first.3.weight"].device).eval()


def inject_subnet(supernet: SuperLitePose, subnet: LitePose) -> SuperLitePose:
    """Write a fixed ``LitePose`` into the supernet's leading channel slices,
    in place (the JAX ``inject_subnet``): the exact inverse of
    ``extract_subnet`` for archs at the full kernel.  A kernel-cropped block
    is not invertible through ``lin5`` / ``lin3`` and raises."""
    kmax = supernet.dims.kernel
    for name, k in _block_kernels(subnet.arch).items():
        if k != kmax:
            si, bi = name.split(".")[1:3]
            raise ValueError(f"inject_subnet: stage {si} block {bi} kernel {k} != max {kmax} "
                             f"-- kernel-cropped blocks are not invertible")
    dst = supernet.state_dict()
    with torch.no_grad():
        for name, t in subnet.state_dict().items():
            d = dst[name]
            d[tuple(slice(0, n) for n in t.shape)] = t.to(d.device, d.dtype)
    return supernet


def reorganize_weights(supernet: SuperLitePose) -> SuperLitePose:
    """Sort channels in place so the leading slices hold the most important
    ones, the L1 importance of the next layer's input weights (the JAX
    ``reorganize_weights``, stable argsort): the stem output by stage 0's
    first expand conv, each stage's output by the next stage's first expand
    conv.  The head's raw-branch consumers of a permuted output
    (``deconv_raw``, ``final_raw``) are permuted too, so the full-width
    function is unchanged."""
    sd = supernet.state_dict()
    n_stages = len(supernet.stage)
    n_deconv = len(supernet.deconv_raw)

    def take(name, idx, dim):
        sd[name].copy_(sd[name].index_select(dim, idx))

    def bn(prefix, idx):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            take(f"{prefix}.{leaf}", idx, 0)

    def raw_consumers(entry, idx):
        # deconv_raw[i] reads x_list[-i-2], the entry n_stages - 1 - i
        for i in range(n_deconv):
            if n_stages - 1 - i == entry:
                take(f"deconv_raw.{i}.weight", idx, 0)
        # final_raw[i-1] reads x_list[-i-3], the entry n_stages - 2 - i
        for i in range(1, n_deconv):
            if n_stages - 2 - i == entry:
                take(f"final_raw.{i - 1}.conv.0.weight", idx, 0)
                bn(f"final_raw.{i - 1}.conv.1", idx)
                take(f"final_raw.{i - 1}.conv.3.weight", idx, 1)

    def importance(name):
        return torch.argsort(-sd[name].abs().sum(dim=(0, 2, 3)), stable=True)

    with torch.no_grad():
        idx = importance("stage.0.0.inv.0.weight")
        take("first.2.weight", idx, 0)
        bn("first.3", idx)
        take("stage.0.0.inv.0.weight", idx, 1)
        raw_consumers(0, idx)
        for si in range(n_stages - 1):
            nxt = f"stage.{si + 1}.0.inv.0.weight"
            idx = importance(nxt)
            take(nxt, idx, 1)
            for bi in range(len(supernet.stage[si])):
                take(f"stage.{si}.{bi}.point_conv.0.weight", idx, 0)
                bn(f"stage.{si}.{bi}.point_conv.1", idx)
                if bi > 0:
                    take(f"stage.{si}.{bi}.inv.0.weight", idx, 1)
            raw_consumers(1 + si, idx)
    return supernet
