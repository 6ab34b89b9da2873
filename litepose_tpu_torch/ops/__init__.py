"""Decode: NMS + top-M peaks (K1, or K5 and the top-M image by image),
greedy (K2) or Hungarian (K3) AE grouping, and refine (K4), each a CUDA
kernel with a plain PyTorch twin, registered together as the torch ops
``torch.ops.litepose.*`` (``library.py``).

The names below are the counterparts of the JAX package's ops API
(``litepose_tpu/ops/__init__.py``); ``greedy_assign``, ``hungarian_prefix``
and ``match_by_tag`` are batched over images here."""

from .nms import heatmap_nms, top_k_peaks
from .hungarian import greedy_assign, hungarian, hungarian_prefix
from .group import (GroupParams, StaticGroupCfg, adjust, match_by_tag, parse_batch,
                    parse_single, refine)

__all__ = [
    "heatmap_nms", "top_k_peaks",
    "greedy_assign", "hungarian", "hungarian_prefix",
    "StaticGroupCfg", "adjust", "match_by_tag", "parse_batch", "parse_single",
    "refine", "GroupParams",
]
