"""Operations and bytes of an EfficientHRNet forward, from its configuration
alone (``cfg["effhrnet"]``, ``input_size``, ``num_joints``,
``tag_per_joint``, ``with_ae``), for ``mfu.effhrnet.serve``,
``forward_roofline.effhrnet.serve`` and ``se_roofline.effhrnet.serve``.

``conv_layers`` lists every convolution of one image's forward as a
``harness.macs.Conv``, in the order the forward runs them, each named by its
weight's prefix in a reference ``pose_efficient_hrnet`` state dict
(``bn_of`` names the BN after it, ``biased`` whether it has a bias of its
own): the backbone's stem, each MBConv block's expand, depthwise, two
squeeze-excitation 1x1 convs (on the 1x1 plane of the means) and project
conv, each transition's conv, the stages' (``harness/hrnet_macs.py``'s
BASIC modules) and the head's.  ``se_layers`` gives each block's gated
tensor (C, H, W), whose read and write, with the gate's weights, are the
squeeze-excitation's least bytes (``se_bytes``).

At H-1@480 (14 joints) that is 214 convolutions (16 depthwise, 58 dense
1x1, 105 dense 3x3 at stride 1, 34 at stride 2, one transposed) and the 32
linears of the 16 squeeze-excitations: 13.087 GMACs (1.501 in the backbone,
the linears' 0.53 M included, 11.586 in the transitions, stages and head),
the transposed conv counted at its input size (``Conv.macs``: each input
pixel meets each tap once).  Counted at its output size, as ptflops counts
it (``Conv.ptflops_macs``), 14.058 G.  LitePose's README gives 14.2 G for
H-1 (its ptflops count at 480): the remaining 0.14 G are the layers ptflops
counts beside the convolutions (BNs, activations, the squeeze-excitations'
pooling and products, upsampling), which this count of the multiply-adds a
forward's convolutions need leaves out, as ``hrnet_macs.py`` leaves them out
of HigherHRNet's 154.3 G.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from reference.efficient_hrnet import backbone_plan, stage_width

from .hrnet_macs import _block
from .macs import Conv


def _out(n: int, s: int) -> int:
    return -(-n // s)  # SAME: ceil(n / s)


def _backbone(cfg: Dict, out: List[Conv], se: List[Tuple[str, int, int, int]]) -> List[Tuple]:
    """The backbone's convs into ``out``, its gated tensors into ``se``;
    returns the taps (width, size)."""
    eff = cfg["effhrnet"]
    size, taps, ends = cfg["input_size"], [], set(eff["taps"])
    for i, (cin, cout, expand, k, s) in enumerate(backbone_plan(eff)):
        name, o = f"features.{i}", _out(size, s)
        if expand == 0:
            out.append(Conv(f"{name}.1", k, cin, cout, 1, size, size, o, o))
        else:
            hidden, j = cin * expand, 0
            if expand != 1:
                out.append(Conv(f"{name}.conv.0.1", 1, cin, hidden, 1, size, size, size, size))
                j = 1
            reduced = max(1, cin // 4)
            out += [Conv(f"{name}.conv.{j}.1", k, hidden, hidden, hidden, size, size, o, o),
                    Conv(f"{name}.conv.{j + 1}.se.1", 1, hidden, reduced, 1, 1, 1, 1, 1),
                    Conv(f"{name}.conv.{j + 1}.se.3", 1, reduced, hidden, 1, 1, 1, 1, 1),
                    Conv(f"{name}.conv.{j + 2}", 1, hidden, cout, 1, o, o, o, o)]
            se.append((f"{name}.conv.{j + 1}", hidden, o, o))
        size = o
        if i + 1 in ends:
            taps.append((cout, size))
    return taps


def _module(out: List[Conv], name: str, st: Dict, widths: List[int], sizes: List[int],
            rows: int) -> None:
    """One HRNet module of BASIC blocks: branches, then ``rows`` fuse rows."""
    for b in range(st["num_branches"]):
        for k in range(st["num_blocks"][b]):
            _block(out, f"{name}.branches.{b}.{k}", "BASIC", widths[b], widths[b], sizes[b])
    if st["num_branches"] == 1:
        return
    for i in range(rows):
        for j in range(st["num_branches"]):
            f = f"{name}.fuse_layers.{i}.{j}"
            if j > i:
                s = sizes[j]
                out.append(Conv(f + ".0", 1, widths[j], widths[i], 1, s, s, s, s))
            elif j < i:
                s = sizes[j]
                for k in range(i - j):
                    co = widths[i] if k == i - j - 1 else widths[j]
                    out.append(Conv(f"{f}.{k}.0", 3, widths[j], co, 1, s, s, s // 2, s // 2))
                    s //= 2


def layers(cfg: Dict) -> Tuple[List[Conv], List[Tuple[str, int, int, int]]]:
    """(every conv of one image's forward in order, each block's gated
    tensor as (name, C, H, W))."""
    eff = cfg["effhrnet"]
    out: List[Conv] = []
    se: List[Tuple[str, int, int, int]] = []
    taps = _backbone(cfg, out, se)
    sf = eff["scale_factor"]
    stages = [dict(st, num_channels=[stage_width(c, sf) for c in st["num_channels"]])
              for st in eff["stages"]]
    ins = [taps[0], taps[1]]
    widths: List[int] = []
    for n, st in enumerate(stages, start=2):
        if n > 2:
            ins = [(w, s) for w, s in zip(widths, sizes)] + [taps[n - 1]]
        widths, sizes = list(st["num_channels"]), [s for _, s in ins]
        for m, ((cin, s), cout) in enumerate(zip(ins, widths), start=1):
            out.append(Conv(f"trans{n - 1}_branch{m}.0", 3, cin, cout, 1, s, s, s, s))
        for m in range(st["num_modules"]):
            last = n == 4 and m == st["num_modules"] - 1
            _module(out, f"stage{n}.{m}", st, widths, sizes, 1 if last else st["num_branches"])

    joints = cfg["num_joints"]
    tags = joints if cfg["tag_per_joint"] else 1
    outs = [joints + (tags if ae else 0) for ae in cfg["with_ae"]]
    dc, fk = eff["deconv"], eff["final_conv_kernel"]
    h, feat = sizes[0], widths[0]
    out.append(Conv("final_layers.0", fk, feat, outs[0], 1, h, h, h, h))
    for i in range(dc["num_deconvs"]):
        cin = feat + (outs[i] if dc["cat_output"][i] else 0)
        cout = stage_width(dc["num_channels"][i], sf)
        out.append(Conv(f"deconv_layers.{i}.0.0", dc["kernel_size"][i], cin, cout, 1, h, h,
                        2 * h, 2 * h, True))
        h *= 2
        for k in range(dc["num_basic_blocks"]):
            _block(out, f"deconv_layers.{i}.{k + 1}.0", "BASIC", cout, cout, h)
        out.append(Conv(f"final_layers.{i + 1}", fk, cout, outs[i + 1], 1, h, h, h, h))
        feat = cout
    return out, se


def conv_layers(cfg: Dict) -> List[Conv]:
    return layers(cfg)[0]


def se_layers(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    return layers(cfg)[1]


def is_se(conv: Conv) -> bool:
    return ".se." in conv.name


def biased(conv: Conv) -> bool:
    """Whether the conv has a bias of its own: the squeeze-excitations'
    linears, the transitions' convs and the final layers."""
    return is_se(conv) or conv.name.startswith(("trans", "final_layers."))


def bn_of(conv: Conv) -> Optional[str]:
    """The reference name of the BN after ``conv``, None for the
    squeeze-excitations' linears and the final layers: a conv-BN-Swish's
    child ``2`` after child ``1``, a project conv's BN the next child, and
    HRNet's ``bnN`` after ``convN``, child ``1`` after child ``0``."""
    if is_se(conv) or conv.name.startswith("final_layers."):
        return None
    head, _, last = conv.name.rpartition(".")
    if conv.name.startswith("features."):
        if last == "1":
            return f"{head}.2"
        block, _, child = conv.name.rpartition(".")  # a project conv: features.i.conv.j
        return f"{block}.{int(child) + 1}"
    bn = "1" if last == "0" else "bn" + last[len("conv"):]
    return f"{head}.{bn}"


def macs(cfg: Dict) -> int:
    return sum(c.macs for c in conv_layers(cfg))


def ptflops_macs(cfg: Dict) -> int:
    return sum(c.ptflops_macs for c in conv_layers(cfg))


def se_bytes(cfg: Dict, images: int, itemsize: int) -> int:
    """The squeeze-excitations' least bytes for ``images`` images: each
    gated tensor read once and written once, and each gate's weights and
    biases read once."""
    convs = {c.name: c for c in conv_layers(cfg) if is_se(c)}
    weights = sum(c.cin * c.cout + c.cout for c in convs.values())
    return itemsize * (images * sum(2 * c * h * w for _, c, h, w in se_layers(cfg)) + weights)


def least_seconds(cfg: Dict, itemsize: int, peak_flops: float, peak_bytes_per_s: float) -> float:
    """One image's forward at the roofline: for each conv the larger of its
    operations over the peak rate and its bytes over the bandwidth, and the
    squeeze-excitations' gating bytes over the bandwidth."""
    convs = sum(max(2 * c.macs / peak_flops, c.bytes(itemsize) / peak_bytes_per_s)
                for c in conv_layers(cfg))
    return convs + se_bytes(cfg, 1, itemsize) / peak_bytes_per_s
