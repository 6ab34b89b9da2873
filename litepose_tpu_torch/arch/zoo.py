"""The published LitePose-Auto-* architectures (the port's copy of
``litepose_tpu/arch/zoo.py``).

Every searched arch of the reference's ``mobile_configs/*.json`` has stage
depths (6, 8, 10, 10), strides (2, 2, 2, 1) and blocks [expansion 6,
kernel 7]; they differ in resolution and widths, so each is a width tuple
expanded here.
"""

from __future__ import annotations

from typing import Dict

from .schema import ArchConfig, StageConfig

_STAGE_DEPTHS = (6, 8, 10, 10)
_STAGE_STRIDES = (2, 2, 2, 1)
_EXPANSION = 6
_KERNEL = 7


def _expand(img_size: int, input_channel: int, deconv, stage_channels) -> ArchConfig:
    stages = tuple(
        StageConfig(num_blocks=n, stride=s, channel=c,
                    block_setting=tuple((_EXPANSION, _KERNEL) for _ in range(n)))
        for n, s, c in zip(_STAGE_DEPTHS, _STAGE_STRIDES, stage_channels)
    )
    return ArchConfig(img_size=img_size, input_channel=input_channel,
                      deconv_setting=tuple(deconv), backbone_setting=stages)


# (img_size, input_channel, deconv_setting, stage_channels)
_ZOO_SPECS = {
    # searched (NAS) architectures: mobile_configs/search-{XS,S,M,L}.json
    "search-XS": (256, 16, (16, 24, 24), (16, 32, 48, 80)),
    "search-S": (448, 16, (32, 24, 32), (16, 32, 48, 120)),
    "search-M": (448, 16, (64, 40, 32), (24, 48, 72, 120)),
    "search-L": (512, 24, (64, 40, 32), (24, 64, 96, 160)),
    # uniformly pruned baselines: mobile_configs/prune-{S,M,L}.json
    "prune-S": (512, 16, (32, 24, 16), (16, 32, 48, 80)),
    "prune-M": (512, 24, (48, 40, 24), (24, 48, 72, 120)),
    "prune-L": (512, 24, (64, 48, 32), (32, 64, 96, 160)),
}

ARCH_ZOO: Dict[str, ArchConfig] = {name: _expand(*spec) for name, spec in _ZOO_SPECS.items()}

# the paper's model names
ARCH_ZOO["auto-XS"] = ARCH_ZOO["search-XS"]
ARCH_ZOO["auto-S"] = ARCH_ZOO["search-S"]
ARCH_ZOO["auto-M"] = ARCH_ZOO["search-M"]
ARCH_ZOO["auto-L"] = ARCH_ZOO["search-L"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_ZOO:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCH_ZOO)}")
    return ARCH_ZOO[name]
