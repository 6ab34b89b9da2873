"""Architecture descriptor of the LitePose search space (the port's copy of
``litepose_tpu/arch/schema.py``; the port imports nothing of the JAX
package).

The descriptor is the reference's arch JSON:

.. code-block:: json

    {
      "img_size": 448,
      "input_channel": 16,
      "deconv_setting": [32, 24, 32],
      "backbone_setting": [
        {"num_blocks": 6, "stride": 2, "channel": 16,
         "block_setting": [[6, 7], ...]},   // [expansion, kernel] per block
        ...
      ]
    }

``to_dict`` of an ``ArchConfig`` equals the JAX package's for the same
descriptor (``tests/test_torch_arch.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple


def make_divisible(v: float, divisor: int, min_value: int | None = None) -> int:
    """Channel rounding of the MobileNet family: the nearest multiple of
    ``divisor``, never more than 10% below ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One backbone stage: ``num_blocks`` inverted bottlenecks, the first
    with ``stride``; each ``block_setting`` entry is ``(expansion, kernel)``."""

    num_blocks: int
    stride: int
    channel: int
    block_setting: Tuple[Tuple[int, int], ...]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "num_blocks": self.num_blocks,
            "stride": self.stride,
            "channel": self.channel,
            "block_setting": [list(b) for b in self.block_setting],
        }


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A complete LitePose architecture: input resolution ``img_size``, stem
    width ``input_channel``, the three fusion-deconv widths
    ``deconv_setting`` and the four ``backbone_setting`` stages."""

    img_size: int
    input_channel: int
    deconv_setting: Tuple[int, ...]
    backbone_setting: Tuple[StageConfig, ...]

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ArchConfig":
        stages = tuple(
            StageConfig(
                num_blocks=int(s["num_blocks"]),
                stride=int(s["stride"]),
                channel=int(s["channel"]),
                block_setting=tuple((int(b[0]), int(b[1])) for b in s["block_setting"]),
            )
            for s in d["backbone_setting"]
        )
        return ArchConfig(
            img_size=int(d["img_size"]),
            input_channel=int(d["input_channel"]),
            deconv_setting=tuple(int(c) for c in d["deconv_setting"]),
            backbone_setting=stages,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "img_size": self.img_size,
            "input_channel": self.input_channel,
            "deconv_setting": list(self.deconv_setting),
            "backbone_setting": [s.to_dict() for s in self.backbone_setting],
        }

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        """The stem width followed by each stage's output width."""
        return (self.input_channel,) + tuple(s.channel for s in self.backbone_setting)

    def with_img_size(self, img_size: int) -> "ArchConfig":
        return dataclasses.replace(self, img_size=img_size)


def validate_arch(d: Dict[str, Any]) -> List[str]:
    """The problems of an arch dict; empty when it is valid."""
    errs: List[str] = []
    for key in ("img_size", "input_channel", "deconv_setting", "backbone_setting"):
        if key not in d:
            errs.append(f"missing key: {key}")
    if errs:
        return errs
    if d["img_size"] % 64 != 0:
        errs.append(f"img_size {d['img_size']} must be a multiple of 64")
    if len(d["deconv_setting"]) != 3:
        errs.append("deconv_setting must have exactly 3 entries")
    if len(d["backbone_setting"]) != 4:
        errs.append("backbone_setting must have exactly 4 stages")
    for i, s in enumerate(d["backbone_setting"]):
        n = s.get("num_blocks")
        bs = s.get("block_setting", [])
        if n != len(bs):
            errs.append(f"stage {i}: num_blocks={n} != len(block_setting)={len(bs)}")
        for j, b in enumerate(bs):
            if len(b) != 2:
                errs.append(f"stage {i} block {j}: block_setting entry must be [exp, kernel]")
            elif b[1] % 2 != 1:
                errs.append(f"stage {i} block {j}: kernel {b[1]} must be odd")
        if s.get("stride") not in (1, 2):
            errs.append(f"stage {i}: stride must be 1 or 2")
    return errs


def load_arch(path_or_dict: str | Dict[str, Any]) -> ArchConfig:
    """Load and validate an architecture from a JSON path or a dict."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            d = json.load(f)
    else:
        d = dict(path_or_dict)
    errs = validate_arch(d)
    if errs:
        raise ValueError("invalid arch config: " + "; ".join(errs))
    return ArchConfig.from_dict(d)
