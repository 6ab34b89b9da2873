"""Operations and bytes of a HigherHRNet forward, from its configuration's
widths alone (``cfg["hrnet"]``, ``input_size``, ``num_joints``,
``tag_per_joint``, ``with_ae``), for ``mfu.hrnet.serve`` and
``forward_roofline.hrnet.serve``: every convolution of one image's forward
as a ``harness.macs.Conv``, in the order the forward runs them, as
``harness/macs.py`` lists LitePose's, each named by its weight's prefix in
a reference ``PoseHigherResolutionNet`` state dict (``bn_of`` names the BN
after it).  Branches of BASIC or BOTTLENECK blocks, one block or more each
(the published configurations).

A transposed conv counts at its input size (``Conv.macs``): each input
pixel meets each kernel tap once.  The published count (the paper's
154.3 GFLOPs at W48@640) counts it at its output size
(``Conv.ptflops_macs``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .macs import Conv

STEM = 64  # the stem's two stride-2 convs
EXPANSION = {"BASIC": 1, "BOTTLENECK": 4}


def _block(out: List[Conv], name: str, kind: str, cin: int, planes: int, h: int) -> int:
    """One BasicBlock or Bottleneck at stride 1 and h x h; returns its
    output width."""
    if kind == "BOTTLENECK":
        cout = planes * 4
        out += [Conv(f"{name}.conv1", 1, cin, planes, 1, h, h, h, h),
                Conv(f"{name}.conv2", 3, planes, planes, 1, h, h, h, h),
                Conv(f"{name}.conv3", 1, planes, cout, 1, h, h, h, h)]
    else:
        cout = planes
        out += [Conv(f"{name}.conv1", 3, cin, cout, 1, h, h, h, h),
                Conv(f"{name}.conv2", 3, cout, cout, 1, h, h, h, h)]
    if cin != cout:
        out.append(Conv(f"{name}.downsample.0", 1, cin, cout, 1, h, h, h, h))
    return cout


def conv_layers(cfg: Dict) -> List[Conv]:
    """Every conv of one image's forward, in order."""
    hr = cfg["hrnet"]
    size = cfg["input_size"]
    h = size // 4
    out = [Conv("conv1", 3, 3, STEM, 1, size, size, size // 2, size // 2),
           Conv("conv2", 3, STEM, STEM, 1, size // 2, size // 2, h, h)]
    cin = STEM
    for k in range(4):
        cin = _block(out, f"layer1.{k}", "BOTTLENECK", cin, hr["stem_inplanes"], h)
    pre = [cin]
    sizes = [h]
    stages = hr["stages"]
    for n, st in enumerate(stages, start=2):
        exp = EXPANSION[st["block"]]
        cur = [c * exp for c in st["num_channels"]]
        # the transition: a width change reads the last branch, as the
        # reference's forward does; a new branch halves the last one's size
        for i, c in enumerate(cur):
            if i < len(pre):
                if c != pre[i]:
                    out.append(Conv(f"transition{n - 1}.{i}.0", 3, pre[-1], c, 1, sizes[-1],
                                    sizes[-1], sizes[-1], sizes[-1]))
            else:
                s = sizes[-1]
                for j in range(i + 1 - len(pre)):
                    co = c if j == i - len(pre) else pre[-1]
                    out.append(Conv(f"transition{n - 1}.{i}.{j}.0", 3, pre[-1], co, 1, s, s,
                                    s // 2, s // 2))
                    s //= 2
                sizes.append(s)
        widths = list(cur)
        for m in range(st["num_modules"]):
            name = f"stage{n}.{m}"
            for b in range(st["num_branches"]):
                w = widths[b]
                for k in range(st["num_blocks"][b]):
                    w = _block(out, f"{name}.branches.{b}.{k}", st["block"], w,
                               st["num_channels"][b], sizes[b])
                widths[b] = w
            last = n == len(stages) + 1 and m == st["num_modules"] - 1
            if st["num_branches"] > 1:
                for i in range(1 if last else st["num_branches"]):
                    for j in range(st["num_branches"]):
                        f = f"{name}.fuse_layers.{i}.{j}"
                        if j > i:
                            s = sizes[j]
                            out.append(Conv(f + ".0", 1, widths[j], widths[i], 1, s, s, s, s))
                        elif j < i:
                            s = sizes[j]
                            for k in range(i - j):
                                co = widths[i] if k == i - j - 1 else widths[j]
                                out.append(Conv(f"{f}.{k}.0", 3, widths[j], co, 1, s, s, s // 2,
                                                s // 2))
                                s //= 2
        pre = widths

    joints = cfg["num_joints"]
    tags = joints if cfg["tag_per_joint"] else 1
    outs = [joints + (tags if ae else 0) for ae in cfg["with_ae"]]
    dc = hr["deconv"]
    fk = hr["final_conv_kernel"]
    feat = pre[0]
    out.append(Conv("final_layers.0", fk, feat, outs[0], 1, h, h, h, h))
    for i in range(dc["num_deconvs"]):
        cin = feat + (outs[i] if dc["cat_output"][i] else 0)
        cout = dc["num_channels"][i]
        out.append(Conv(f"deconv_layers.{i}.0.0", dc["kernel_size"][i], cin, cout, 1, h, h,
                        2 * h, 2 * h, True))
        h *= 2
        for k in range(dc["num_basic_blocks"]):
            _block(out, f"deconv_layers.{i}.{k + 1}.0", "BASIC", cout, cout, h)
        out.append(Conv(f"final_layers.{i + 1}", fk, cout, outs[i + 1], 1, h, h, h, h))
        feat = cout
    return out


def bn_of(conv: Conv) -> Optional[str]:
    """The reference name of the BN after ``conv``, None for a final layer:
    ``bnN`` after ``convN``, child ``1`` after child ``0``."""
    head, _, last = conv.name.rpartition(".")
    if conv.name.startswith("final_layers."):
        return None
    bn = "1" if last == "0" else "bn" + last[len("conv"):]
    return f"{head}.{bn}" if head else bn


def macs(cfg: Dict) -> int:
    return sum(c.macs for c in conv_layers(cfg))


def ptflops_macs(cfg: Dict) -> int:
    return sum(c.ptflops_macs for c in conv_layers(cfg))


def least_seconds(cfg: Dict, itemsize: int, peak_flops: float, peak_bytes_per_s: float) -> float:
    """One image's forward at the roofline: for each conv the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return sum(max(2 * c.macs / peak_flops, c.bytes(itemsize) / peak_bytes_per_s)
               for c in conv_layers(cfg))
