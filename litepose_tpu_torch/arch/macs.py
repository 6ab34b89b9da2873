"""Static MAC/param counter for LitePose architectures (the port's copy of
``litepose_tpu/arch/macs.py``, held to it by tests/test_torch_nas.py).

Pure arithmetic over the arch descriptor — no model instantiation — replacing
the reference's ptflops-based efficiency predictor
(``arch_search/eff_pred.py:13-19`` and
``lib/utils/utils.py:107-166``).  Used by the evolutionary
search as the efficiency constraint and validated against the published GMACs
(XS 1.2 / S 5.0 / M 7.8 / L 13.7, the reference's README).

Counting convention follows ptflops (the tool behind the published numbers):
one MAC per multiply-accumulate; convolutions count
``k*k*cin/groups*cout*Hout*Wout`` with *output* spatial dims (also for
transposed convs); BatchNorm and ReLU count one op per output element.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .schema import ArchConfig, make_divisible

NUM_STEM_CHANNELS = 32
DECONV_KERNEL = 4
FINAL_KERNEL = 5


def _conv(k: int, cin: int, cout: int, h: int, w: int, groups: int = 1) -> int:
    return k * k * (cin // groups) * cout * h * w


def _bn_relu(c: int, h: int, w: int, n_ops: int = 2) -> int:
    # ptflops: BN counts affine elementwise (~2 ops/elt with affine), ReLU 1.
    return n_ops * c * h * w


def count_litepose_macs(
    arch: ArchConfig,
    num_joints: int = 14,
    with_ae: Tuple[bool, ...] = (True, False),
    include_elementwise: bool = True,
) -> Dict[str, int]:
    """Count MACs (ptflops convention) and parameters for a LitePose arch.

    Returns a dict with ``macs``, ``params`` and a per-section breakdown.
    """
    R = arch.img_size
    macs = 0
    params = 0
    breakdown: Dict[str, int] = {}

    def ew(c: int, h: int, w: int, n: int = 2) -> int:
        return _bn_relu(c, h, w, n) if include_elementwise else 0

    # --- stem ("first"): 3x3 s2 convbnrelu(3->32), 3x3 dw, 1x1 -> input_channel, BN
    h = w = R // 2
    cin = arch.input_channel
    sec = 0
    sec += _conv(3, 3, NUM_STEM_CHANNELS, h, w) + ew(NUM_STEM_CHANNELS, h, w, 3)
    sec += _conv(3, NUM_STEM_CHANNELS, NUM_STEM_CHANNELS, h, w, groups=NUM_STEM_CHANNELS)
    sec += ew(NUM_STEM_CHANNELS, h, w, 3)
    sec += _conv(1, NUM_STEM_CHANNELS, cin, h, w) + ew(cin, h, w, 2)
    params += 3 * 3 * 3 * NUM_STEM_CHANNELS + 2 * NUM_STEM_CHANNELS
    params += 3 * 3 * NUM_STEM_CHANNELS + 2 * NUM_STEM_CHANNELS
    params += NUM_STEM_CHANNELS * cin + 2 * cin
    macs += sec
    breakdown["stem"] = sec

    # --- backbone stages of InvBottleneck blocks
    channels = [cin]
    cur = cin
    for si, st in enumerate(arch.backbone_setting):
        sec = 0
        for bi in range(st.num_blocks):
            t, k = st.block_setting[bi]
            stride = st.stride if bi == 0 else 1
            feat = make_divisible(round(cur * t), 8)
            # 1x1 expand at input resolution
            sec += _conv(1, cur, feat, h, w) + ew(feat, h, w, 3)
            params += cur * feat + 2 * feat
            # depthwise at output resolution
            ho, wo = h // stride, w // stride
            sec += _conv(k, feat, feat, ho, wo, groups=feat) + ew(feat, ho, wo, 3)
            params += k * k * feat + 2 * feat
            # 1x1 project
            sec += _conv(1, feat, st.channel, ho, wo) + ew(st.channel, ho, wo, 2)
            params += feat * st.channel + 2 * st.channel
            h, w = ho, wo
            cur = st.channel
        channels.append(st.channel)
        macs += sec
        breakdown[f"stage{si}"] = sec

    # --- fusion deconv head (3 levels), two final heads
    # channels == reference self.channel == [stem, c0, c1, c2, c3]
    filters = arch.deconv_setting
    inplanes = channels[-1]
    sec = 0
    for i in range(3):
        ho, wo = h * 2, w * 2
        # refined transposed conv (ptflops counts with output dims)
        sec += _conv(DECONV_KERNEL, inplanes, filters[i], ho, wo)
        params += DECONV_KERNEL * DECONV_KERNEL * inplanes * filters[i]
        # raw transposed conv from the matching backbone skip
        raw_c = channels[-i - 2]
        sec += _conv(DECONV_KERNEL, raw_c, filters[i], ho, wo)
        params += DECONV_KERNEL * DECONV_KERNEL * raw_c * filters[i]
        sec += ew(filters[i], ho, wo, 3)  # BN + ReLU
        params += 2 * filters[i]
        inplanes = filters[i]
        h, w = ho, wo
        if i > 0:
            oup = num_joints * (2 if with_ae[i - 1] else 1)
            # final_refined: SepConv2d(filters[i] -> oup, k5)
            sec += _conv(FINAL_KERNEL, filters[i], filters[i], h, w, groups=filters[i])
            sec += ew(filters[i], h, w, 3)
            sec += _conv(1, filters[i], oup, h, w)
            params += FINAL_KERNEL**2 * filters[i] + 2 * filters[i] + filters[i] * oup
            # final_raw: SepConv2d(channel[-i-3] -> oup, k5)
            raw_c2 = channels[-i - 3]
            sec += _conv(FINAL_KERNEL, raw_c2, raw_c2, h, w, groups=raw_c2)
            sec += ew(raw_c2, h, w, 3)
            sec += _conv(1, raw_c2, oup, h, w)
            params += FINAL_KERNEL**2 * raw_c2 + 2 * raw_c2 + raw_c2 * oup
    macs += sec
    breakdown["head"] = sec

    return {"macs": macs, "params": params, "breakdown": breakdown}


def gmacs(arch: ArchConfig, num_joints: int = 14, **kw) -> float:
    return count_litepose_macs(arch, num_joints, **kw)["macs"] / 1e9
