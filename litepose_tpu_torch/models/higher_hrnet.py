"""HigherHRNet as ``nn.Module``s, NCHW (counterpart of
``litepose_tpu/models/higher_hrnet.py``).

  stem:    two stride-2 3x3 conv-BN-ReLU (``conv1``/``bn1``, ``conv2``/``bn2``);
  layer1:  4 Bottlenecks (STEM_INPLANES -> x4);
  stages:  ``transition1..3`` then ``stage2..4``, each stage a list of
           ``HighResolutionModule``s: parallel branches of BASIC (or
           BOTTLENECK) blocks, or a single conv-BN-ReLU6 where a branch has 0
           blocks, then the fuse layers (a 1x1 conv-BN and a nearest 2^n
           upsample from a lower resolution, chains of strided 3x3 conv-BNs
           from a higher one);
  head:    ``final_layers`` (conv with bias) and ``deconv_layers``: a 2x
           transposed conv of the features, concatenated with the previous
           prediction where CAT_OUTPUT, BN + ReLU, then NUM_BASIC_BLOCKS.

Outputs: [heatmaps+tags at 1/4, heatmaps(+tags) at 1/2], LitePose's
contract, so the engine, decode and eval stack serve it as they are.

Parameter names are the reference ``PoseHigherResolutionNet``'s, the keys
``hrnet_from_torch`` (``litepose_tpu/models/torch_convert.py``) reads, so a
reference state dict loads with ``strict=True`` (``models.torch_convert``).
The reference numbers the transitions by the stage they leave
(``transition1`` feeds ``stage2``); the JAX pytree by the stage they feed.

Numerics: convolutions run in ``compute_dtype``.  At eval the model folds
its BNs as LitePose does (``layers.FoldsBN``): every conv followed by a BN
(``_conv_bn_pairs``: stem, Bottleneck, BasicBlock, downsample and every
``ConvBN`` of the transitions, fuse layers and 0-block branches) runs as
``layers.conv_bn``, the weight folded once in the JAX order and the bias
added after the conv, then its activation.  The head's transposed conv
keeps its BN unfolded (``layers.batch_norm``).  The final layers' and the
transposed conv's weights and the head BN's affine are stored once in
``compute_dtype`` with the folded pairs (``layers.prepare_eval_``), so the
forward casts none.  On a card the eval forward runs channels-last, cuDNN's
layout (``eval_layout``), and the stored weights are kept so.  In training
every BN takes batch statistics, as JAX's.
EfficientHRNet shares the stages and the head but never folds: a pair with
no folded weight keeps the BN unfolded after its conv, as the JAX module.

The forward opens ``litepose.hrnet.*`` spans (``utils/spans.py``): the
stem, each transition, each module's branches and its fuse, and the head.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.epilogue import unfused
from ..utils.spans import span
from . import layers as L


class StageSpec(NamedTuple):
    num_modules: int
    num_branches: int
    block: str  # 'BASIC' | 'BOTTLENECK'
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]


def stage_from_config(s) -> StageSpec:
    return StageSpec(s.NUM_MODULES, s.NUM_BRANCHES, s.BLOCK, tuple(s.NUM_BLOCKS),
                     tuple(s.NUM_CHANNELS))


class HRNetSpec(NamedTuple):
    """The part of the experiment config HigherHRNet needs (mirror of the
    JAX ``HRNetSpec``, whose module imports jax)."""

    num_joints: int = 14
    tag_per_joint: bool = True
    with_ae_loss: Tuple[bool, ...] = (True, False)
    stem_inplanes: int = 64
    final_conv_kernel: int = 1
    stage2: StageSpec = StageSpec(1, 2, "BASIC", (4, 4), (32, 64))
    stage3: StageSpec = StageSpec(4, 3, "BASIC", (4, 4, 4), (32, 64, 128))
    stage4: StageSpec = StageSpec(3, 4, "BASIC", (4, 4, 4, 4), (32, 64, 128, 256))
    num_deconvs: int = 1
    deconv_channels: Tuple[int, ...] = (32,)
    deconv_kernels: Tuple[int, ...] = (4,)
    deconv_num_basic_blocks: int = 4
    cat_output: Tuple[bool, ...] = (True,)

    @staticmethod
    def from_config(cfg) -> "HRNetSpec":
        e = cfg.MODEL.EXTRA
        return HRNetSpec(
            num_joints=cfg.MODEL.NUM_JOINTS,
            tag_per_joint=cfg.MODEL.TAG_PER_JOINT,
            with_ae_loss=tuple(cfg.LOSS.WITH_AE_LOSS),
            stem_inplanes=e.STEM_INPLANES,
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

    def expansion(self, block: str) -> int:
        return 4 if block == "BOTTLENECK" else 1

    def final_out_channels(self, idx: int) -> int:
        dim_tag = self.num_joints if self.tag_per_joint else 1
        return self.num_joints + (dim_tag if self.with_ae_loss[idx] else 0)


# -- primitive HRNet blocks --------------------------------------------------


def conv2d(cin: int, cout: int, k: int = 3, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """A conv with the JAX padding k // 2."""
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=bias)


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
            act: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv, BN, ``residual`` added where given (``layers.conv_bn``'s
    contract), then ``act`` ("none", "relu6", "relu"): a pair that
    ``FoldsBN.fold_bn_`` folded as ``layers.conv_bn`` (at bf16 eval the
    bias, residual and activation in one kernel after the conv); an unfolded
    one (training, EfficientHRNet) as the JAX ``_convbn``, the BN after the
    conv (``layers.batch_norm``)."""
    if hasattr(conv, "folded_w"):
        return L.conv_bn(x, conv, bn, dtype, act, residual)
    return unfused(L.batch_norm(L.conv(x, conv, dtype), bn), None, residual, act)


class ConvBN(nn.Sequential):
    """conv + BN (+ ReLU or ReLU6); children ``0`` conv, ``1`` BN, as the
    reference's ``Sequential``s of fuse layers, transitions and 0-block
    branches."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 act: Optional[str] = "relu"):
        super().__init__(conv2d(cin, cout, k, stride), L.bn2d(cout))
        self.act = act

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                residual: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
        """``conv_bn`` of the pair; ``act`` in place of the layer's own (a
        fuse row's ReLU, folded into its last term)."""
        return conv_bn(x, self[0], self[1], dtype, act or self.act or "none", residual)


def _downsample(cin: int, cout: int, stride: int) -> Optional[nn.Sequential]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(conv2d(cin, cout, 1, stride), L.bn2d(cout))


def _residual(x: torch.Tensor, down: Optional[nn.Sequential], dtype) -> torch.Tensor:
    return x if down is None else conv_bn(x, down[0], down[1], dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv2d(cin, cout, 3, stride)
        self.bn1 = L.bn2d(cout)
        self.conv2 = conv2d(cout, cout, 3)
        self.bn2 = L.bn2d(cout)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv_bn(x, self.conv1, self.bn1, dtype, "relu")
        return conv_bn(y, self.conv2, self.bn2, dtype, "relu",
                       _residual(x, self.downsample, dtype))

    def pairs(self):
        return [(self.conv1, self.bn1), (self.conv2, self.bn2)]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * 4
        self.conv1 = conv2d(cin, planes, 1)
        self.bn1 = L.bn2d(planes)
        self.conv2 = conv2d(planes, planes, 3, stride)
        self.bn2 = L.bn2d(planes)
        self.conv3 = conv2d(planes, cout, 1)
        self.bn3 = L.bn2d(cout)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv_bn(x, self.conv1, self.bn1, dtype, "relu")
        y = conv_bn(y, self.conv2, self.bn2, dtype, "relu")
        return conv_bn(y, self.conv3, self.bn3, dtype, "relu",
                       _residual(x, self.downsample, dtype))

    def pairs(self):
        return [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]


class HighResolutionModule(nn.Module):
    """Parallel branches, then (with more than one branch) the fuse layers:
    output i sums every branch j brought to i's resolution and width, then
    ReLU (``_module_init`` / ``_module_apply``).  ``multi_scale_output``
    False keeps output 0 only.  ``out_channels``: each branch's width."""

    def __init__(self, spec: StageSpec, in_channels: Sequence[int], exp: int,
                 multi_scale_output: bool):
        super().__init__()
        self.spec = spec
        out = list(in_channels)
        branches = []
        for bi in range(spec.num_branches):
            if spec.num_blocks[bi] == 0:
                # the gradual-shrinking variant: one conv-BN-ReLU6
                branches.append(ConvBN(in_channels[bi], spec.num_channels[bi], act="relu6"))
                out[bi] = spec.num_channels[bi]
                continue
            cout = spec.num_channels[bi] * exp
            blocks, cin = [], in_channels[bi]
            for _ in range(spec.num_blocks[bi]):
                blocks.append(Bottleneck(cin, spec.num_channels[bi]) if spec.block == "BOTTLENECK"
                              else BasicBlock(cin, cout))
                cin = cout
            branches.append(nn.Sequential(*blocks))
            out[bi] = cout
        self.branches = nn.ModuleList(branches)
        self.out_channels = out

        self.fuse_layers = None
        if spec.num_branches > 1:
            rows = []
            for i in range(spec.num_branches if multi_scale_output else 1):
                row = []
                for j in range(spec.num_branches):
                    if j > i:
                        row.append(ConvBN(out[j], out[i], k=1, act=None))
                    elif j == i:
                        row.append(None)
                    else:
                        row.append(nn.Sequential(*[
                            ConvBN(out[j], out[i] if k == i - j - 1 else out[j], stride=2,
                                   act=None if k == i - j - 1 else "relu")
                            for k in range(i - j)]))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        with span("litepose.hrnet.branches"):
            ys = []
            for branch, x in zip(self.branches, xs):
                if isinstance(branch, ConvBN):
                    ys.append(branch(x, dtype))
                else:
                    for block in branch:
                        x = block(x, dtype)
                    ys.append(x)
        if self.fuse_layers is None:
            return ys
        with span("litepose.hrnet.fuse"):
            return self._fuse(ys, dtype)

    def _fuse(self, ys: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        """Row i: ``acc`` summed left to right over j of branch j at i's
        resolution, then ReLU.  Each conv term's last ``conv_bn`` takes
        ``acc`` as its residual (a j > i term's output, at 1/2^(j-i) of
        i's plane, is upsampled into it there) and, as the row's last term,
        the ReLU; only a row that ends on its own branch adds and clamps
        apart.  The terms are summed in j's order, each into the running
        ``acc``: no sum is regrouped."""
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc, last = None, len(row) - 1
            for j, layer in enumerate(row):
                act = "relu" if j == last else None
                if j == i:
                    acc = ys[j] if acc is None else acc + ys[j]
                    if act:
                        acc = torch.relu(acc)
                    continue
                chain, z = [layer] if j > i else list(layer), ys[j]
                for step in chain[:-1]:
                    z = step(z, dtype)
                acc = chain[-1](z, dtype, acc, act)
            fused.append(acc)
        return fused


def make_stage(spec: StageSpec, in_channels: Sequence[int], exp: int,
               last_stage: bool) -> Tuple[nn.ModuleList, List[int]]:
    """A stage's modules; the last module of the last stage keeps output 0
    only.  Returns (modules, their output widths)."""
    modules, chans = [], list(in_channels)
    for mi in range(spec.num_modules):
        mso = not (last_stage and mi == spec.num_modules - 1)
        module = HighResolutionModule(spec, chans, exp, mso)
        chans = module.out_channels
        modules.append(module)
    return nn.ModuleList(modules), chans


def run_stage(modules: nn.ModuleList, xs: List[torch.Tensor],
              dtype: torch.dtype) -> List[torch.Tensor]:
    for module in modules:
        xs = module(xs, dtype)
    return xs


def make_higher_head(in_channels: int, final_out, final_kernel: int,
                     deconv_channels: Sequence[int], deconv_kernels: Sequence[int],
                     num_basic_blocks: int, cat_output: Sequence[bool]):
    """(``final_layers``, ``deconv_layers``): the 1/4 prediction's conv,
    then per deconv stage a 2x transposed conv (its input the features,
    concatenated with the previous prediction where ``cat_output``), BN +
    ReLU, basic blocks, and that stage's prediction conv.
    ``deconv_channels``: the deconv stages' widths, scaled by the caller
    where it scales them; ``final_out(i)``: stage i's output channels."""
    finals = [conv2d(in_channels, final_out(0), final_kernel, bias=True)]
    deconvs, cin = [], in_channels
    for i, cout in enumerate(deconv_channels):
        if cat_output[i]:
            cin += final_out(i)
        layers = [nn.Sequential(L.make_deconv(cin, cout, deconv_kernels[i]), L.bn2d(cout),
                                nn.ReLU())]
        layers += [nn.Sequential(BasicBlock(cout, cout)) for _ in range(num_basic_blocks)]
        deconvs.append(nn.Sequential(*layers))
        finals.append(conv2d(cout, final_out(i + 1), final_kernel, bias=True))
        cin = cout
    return nn.ModuleList(finals), nn.ModuleList(deconvs)


def apply_higher_head(final_layers: nn.ModuleList, deconv_layers: nn.ModuleList,
                      cat_output: Sequence[bool], feat: torch.Tensor, dtype: torch.dtype,
                      out_dtype: torch.dtype) -> List[torch.Tensor]:
    out = L.conv_bias(feat, final_layers[0], dtype)
    outputs = [out.to(out_dtype)]
    for i, stage in enumerate(deconv_layers):
        if cat_output[i]:
            feat = torch.cat([feat, out.to(feat.dtype)], dim=1)
        z = torch.relu(L.batch_norm(L.deconv(feat, stage[0][0], dtype), stage[0][1]))
        for block in stage[1:]:
            z = block[0](z, dtype)
        feat = z
        out = L.conv_bias(feat, final_layers[i + 1], dtype)
        outputs.append(out.to(out_dtype))
    return outputs


class HigherHRNet(L.FoldsBN, nn.Module):
    """Forward: ``x`` (B, 3, H, W) normalized images -> [(B, J+T, H/4, W/4),
    (B, J, H/2, W/2)] in ``out_dtype``.  ``compute_dtype``: the conv
    compute type (bf16 serving, fp32 for parity), the JAX ``Policy``.
    ``eval()`` folds the BNs (``fold_bn_``); after writing weights into a
    model in eval mode, call ``fold_bn_()`` again."""

    # cuDNN's convolutions are NHWC: in NCHW each would transpose its input
    # and output (two more launches, and about a quarter of the W48
    # forward's device time on an H100)
    eval_layout = torch.channels_last

    def __init__(self, spec: HRNetSpec, compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        self.conv1 = conv2d(3, 64, 3, 2)
        self.bn1 = L.bn2d(64)
        self.conv2 = conv2d(64, 64, 3, 2)
        self.bn2 = L.bn2d(64)
        blocks, cin = [], 64
        for _ in range(4):
            blocks.append(Bottleneck(cin, spec.stem_inplanes))
            cin = spec.stem_inplanes * 4
        self.layer1 = nn.Sequential(*blocks)

        pre = [cin]
        for n, st in ((2, spec.stage2), (3, spec.stage3), (4, spec.stage4)):
            exp = spec.expansion(st.block)
            cur = [c * exp for c in st.num_channels]
            setattr(self, f"transition{n - 1}", self._transition(pre, cur))
            modules, pre = make_stage(st, cur, exp, last_stage=n == 4)
            setattr(self, f"stage{n}", modules)
        self.final_layers, self.deconv_layers = make_higher_head(
            pre[0], spec.final_out_channels, spec.final_conv_kernel,
            spec.deconv_channels[:spec.num_deconvs], spec.deconv_kernels,
            spec.deconv_num_basic_blocks, spec.cat_output)

    def _conv_bn_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                pairs += m.pairs()
                if m.downsample is not None:
                    pairs.append((m.downsample[0], m.downsample[1]))
            elif isinstance(m, ConvBN):
                pairs.append((m[0], m[1]))
        return pairs

    @staticmethod
    def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
        """None where a branch passes as it is, a conv-BN-ReLU where its
        width changes, a chain of stride-2 ones for a new branch."""
        layers = []
        for i in range(len(cur)):
            if i < len(pre):
                layers.append(ConvBN(pre[i], cur[i]) if cur[i] != pre[i] else None)
            else:
                n = i + 1 - len(pre)
                layers.append(nn.Sequential(*[
                    ConvBN(pre[-1], cur[i] if j == n - 1 else pre[-1], stride=2)
                    for j in range(n)]))
        return nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.compute_dtype
        if x.is_cuda and not self.training:
            x = x.contiguous(memory_format=self.eval_layout)  # outputs stay in it
        with span("litepose.hrnet.stem"):
            y = conv_bn(x, self.conv1, self.bn1, dt, "relu")
            y = conv_bn(y, self.conv2, self.bn2, dt, "relu")
            for block in self.layer1:
                y = block(y, dt)
        ys = [y]
        for n in (2, 3, 4):
            with span("litepose.hrnet.transition"):
                ys = apply_transition(getattr(self, f"transition{n - 1}"), ys, dt)
            ys = run_stage(getattr(self, f"stage{n}"), ys, dt)
        with span("litepose.hrnet.head"):
            return apply_higher_head(self.final_layers, self.deconv_layers,
                                     self.spec.cat_output, ys[0], dt, self.out_dtype)


def apply_transition(layers: nn.ModuleList, prev: List[torch.Tensor],
                     dtype: torch.dtype) -> List[torch.Tensor]:
    """Every layer other than None reads the last branch's output, as the
    reference's forward does; None passes branch i (or the last) on."""
    outs = []
    for i, layer in enumerate(layers):
        if layer is None:
            outs.append(prev[i] if i < len(prev) else prev[-1])
        elif isinstance(layer, ConvBN):
            outs.append(layer(prev[-1], dtype))
        else:
            z = prev[-1]
            for step in layer:
                z = step(z, dtype)
            outs.append(z)
    return outs


def init_higher_hrnet(spec: HRNetSpec, generator: torch.Generator, **model_kw) -> HigherHRNet:
    """A freshly initialized ``HigherHRNet`` in training mode, on the CPU
    (counterpart of ``init_higher_hrnet``): ``layers.fan_in_init_``."""
    return L.fan_in_init_(HigherHRNet(spec, **model_kw), generator).train()
