"""Search-space manager: samples LitePose architectures (the port's copy of
``litepose_tpu/arch/manager.py``, held to it by tests/test_torch_config.py).

Reimplements the sampling semantics of the reference ``ArchManager``
(``arch_manager.py:18-89``): expansion fixed at 6, kernel
fixed at 7, stem width 24, width multipliers {1.0, 0.75, 0.5, 0.25},
stage table [[32,4,2],[64,6,2],[96,8,2],[160,8,1]], and the elastic input
resolution 256 + 64*{0..4}.

TPU-first difference: sampling is driven by an explicit ``numpy`` RNG (or an
integer seed) instead of global ``random`` state so the input pipeline can
sample per-step architectures deterministically and feed them to the jitted
supernet step as static/masked descriptors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .schema import ArchConfig, StageConfig, make_divisible

# (channel, num_blocks, stride) per backbone stage — the search space.
#
# NOTE: the reference repo is internally inconsistent here: its
# ``arch_manager.py:28-34`` table says depths (4, 6, 8, 8), but its supernet
# hardcodes (6, 8, 10, 10) (``pose_supermobilenet.py:27-33``) and every
# published searched arch (mobile_configs/*.json) has depths (6, 8, 10, 10).
# We use the supernet-consistent depths so sampled archs are hostable by the
# supernet and match the published search space.
DEFAULT_STAGE_SETTING = ((32, 6, 2), (64, 8, 2), (96, 10, 2), (160, 10, 1))
DEFAULT_DECONV_SETTING = (64, 48, 32)
DEFAULT_INPUT_CHANNEL = 24
WIDTH_MULTS = (1.0, 0.75, 0.5, 0.25)
IMG_SIZES = (256, 320, 384, 448, 512)
EXPANSION = 6
KERNEL = 7


class ArchManager:
    """Samples architectures from the LitePose search space."""

    def __init__(
        self,
        deconv_setting: Sequence[int] = DEFAULT_DECONV_SETTING,
        input_channel: int = DEFAULT_INPUT_CHANNEL,
        stage_setting: Sequence[Sequence[int]] = DEFAULT_STAGE_SETTING,
        width_mults: Sequence[float] = WIDTH_MULTS,
        img_sizes: Sequence[int] = IMG_SIZES,
        seed: Optional[int] = None,
    ):
        self.deconv_setting = tuple(deconv_setting)
        self.input_channel = input_channel
        self.stage_setting = tuple(tuple(s) for s in stage_setting)
        self.width_mults = tuple(width_mults)
        self.img_sizes = tuple(img_sizes)
        self.rng = np.random.default_rng(seed)
        # When pinned (NAS evaluation), random_sample returns this arch —
        # mirrors `is_search`/`search_arch` (arch_manager.py:49-51).
        self.is_search = False
        self.search_arch: Optional[ArchConfig] = None

    # -- sampling helpers ----------------------------------------------------

    def rand_channel(self, c: int, rng: Optional[np.random.Generator] = None) -> int:
        rng = rng or self.rng
        mult = self.width_mults[int(rng.integers(len(self.width_mults)))]
        return make_divisible(c * mult, 8)

    def random_sample(self, rng: Optional[np.random.Generator] = None) -> ArchConfig:
        """Sample a random sub-architecture (resolution + per-stage widths)."""
        if self.is_search and self.search_arch is not None:
            return self.search_arch
        rng = rng or self.rng
        img_size = self.img_sizes[int(rng.integers(len(self.img_sizes)))]
        input_channel = self.rand_channel(self.input_channel, rng)
        deconv = tuple(self.rand_channel(c, rng) for c in self.deconv_setting)
        stages = []
        for c, n, s in self.stage_setting:
            stages.append(
                StageConfig(
                    num_blocks=n,
                    stride=s,
                    channel=self.rand_channel(c, rng),
                    block_setting=tuple((EXPANSION, KERNEL) for _ in range(n)),
                )
            )
        return ArchConfig(
            img_size=img_size,
            input_channel=input_channel,
            deconv_setting=deconv,
            backbone_setting=tuple(stages),
        )

    def fixed_sample(self, reso: int = 256, ratio: float = 0.5) -> ArchConfig:
        """Deterministic arch with a uniform width ratio (reference
        ``fixed_sample``, arch_manager.py:71-89)."""
        stages = tuple(
            StageConfig(
                num_blocks=n,
                stride=s,
                channel=make_divisible(c * ratio, 8),
                block_setting=tuple((EXPANSION, KERNEL) for _ in range(n)),
            )
            for c, n, s in self.stage_setting
        )
        return ArchConfig(
            img_size=reso,
            input_channel=make_divisible(self.input_channel * ratio, 8),
            deconv_setting=tuple(
                make_divisible(c * ratio, 8) for c in self.deconv_setting
            ),
            backbone_setting=stages,
        )

    def max_arch(self, img_size: int = 512) -> ArchConfig:
        """The supernet (maximal) architecture — every width at full scale."""
        return self.fixed_sample(reso=img_size, ratio=1.0)

    def channel_choices(self, c: int) -> List[int]:
        """All widths a base channel count can take in this space."""
        return sorted({make_divisible(c * m, 8) for m in self.width_mults})
