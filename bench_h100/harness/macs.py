"""Operations and bytes of a LitePose forward, from its arch descriptor
alone (a frozen copy of the conv terms of ``litepose_tpu_torch/arch/macs.py``,
``include_elementwise=False``), for ``mfu.serve``, ``mfu.train`` and
``forward_roofline.serve``.

``conv_layers`` lists every convolution with its shapes.  Two counts come
from it:

- ``ptflops_macs``: the published convention (the reference's ptflops, the
  papers' GMACs), which counts a transposed conv at its output size;
  Auto-S@448 4.818 GMACs, Auto-XS@256 1.153.
- ``macs``: the multiply-adds a forward needs.  A stride-2 transposed conv
  meets each input pixel with each kernel tap once, a quarter of the
  published count, which counts the zeros of its lhs-dilated form; the
  other convs count the same.  The utilization and roofline shares use
  this count, so they never credit the card with work it need not do.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence

STEM_CHANNELS = 32
DECONV_KERNEL = 4
FINAL_KERNEL = 5


def make_divisible(v: float, divisor: int) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Conv(NamedTuple):
    name: str
    k: int
    cin: int
    cout: int
    groups: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    transposed: bool = False

    @property
    def ptflops_macs(self) -> int:
        return self.k * self.k * (self.cin // self.groups) * self.cout * self.h_out * self.w_out

    @property
    def macs(self) -> int:
        if self.transposed:
            return self.k * self.k * self.cin * self.cout * self.h_in * self.w_in
        return self.ptflops_macs

    def bytes(self, itemsize: int) -> int:
        """Input and output activations and the weights, each once."""
        weights = self.k * self.k * (self.cin // self.groups) * self.cout
        return itemsize * (self.cin * self.h_in * self.w_in
                           + self.cout * self.h_out * self.w_out + weights)


def conv_layers(arch: Dict[str, Any], num_joints: int = 14,
                with_ae: Sequence[bool] = (True, False)) -> List[Conv]:
    """Every conv of one image's forward, in order."""
    size = arch["img_size"]
    cin = arch["input_channel"]
    h = size // 2
    out = [Conv("first.0", 3, 3, STEM_CHANNELS, 1, size, size, h, h),
           Conv("first.1", 3, STEM_CHANNELS, STEM_CHANNELS, STEM_CHANNELS, h, h, h, h),
           Conv("first.2", 1, STEM_CHANNELS, cin, 1, h, h, h, h)]
    channels = [cin]
    cur = cin
    for si, st in enumerate(arch["backbone_setting"]):
        for bi in range(st["num_blocks"]):
            t, k = st["block_setting"][bi]
            stride = st["stride"] if bi == 0 else 1
            feat = make_divisible(round(cur * t), 8)
            ho = h // stride
            name = f"stage.{si}.{bi}"
            out += [Conv(f"{name}.inv", 1, cur, feat, 1, h, h, h, h),
                    Conv(f"{name}.depth", k, feat, feat, feat, h, h, ho, ho),
                    Conv(f"{name}.point", 1, feat, st["channel"], 1, ho, ho, ho, ho)]
            h = ho
            cur = st["channel"]
        channels.append(st["channel"])
    filters = arch["deconv_setting"]
    inplanes = channels[-1]
    for i in range(3):
        ho = 2 * h
        out += [Conv(f"deconv_refined.{i}", DECONV_KERNEL, inplanes, filters[i], 1, h, h, ho, ho,
                     True),
                Conv(f"deconv_raw.{i}", DECONV_KERNEL, channels[-i - 2], filters[i], 1, h, h, ho,
                     ho, True)]
        inplanes = filters[i]
        h = ho
        if i > 0:
            oup = num_joints * (2 if with_ae[i - 1] else 1)
            for head, c in (("final_refined", filters[i]), ("final_raw", channels[-i - 3])):
                out += [Conv(f"{head}.{i - 1}.dw", FINAL_KERNEL, c, c, c, h, h, h, h),
                        Conv(f"{head}.{i - 1}.pw", 1, c, oup, 1, h, h, h, h)]
    return out


def ptflops_macs(arch: Dict[str, Any], **kw) -> int:
    return sum(c.ptflops_macs for c in conv_layers(arch, **kw))


def macs(arch: Dict[str, Any], **kw) -> int:
    return sum(c.macs for c in conv_layers(arch, **kw))


def least_seconds(arch: Dict[str, Any], itemsize: int, peak_flops: float,
                  peak_bytes_per_s: float, **kw) -> float:
    """One image's forward at the roofline: for each conv the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return sum(max(2 * c.macs / peak_flops, c.bytes(itemsize) / peak_bytes_per_s)
               for c in conv_layers(arch, **kw))
