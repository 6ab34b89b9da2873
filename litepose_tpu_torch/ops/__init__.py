"""Decode: NMS + top-M peaks (K1, or K5 and the top-M image by image),
greedy (K2) or Hungarian (K3) AE grouping, and refine (K4), each a CUDA
kernel with a plain PyTorch twin, registered together as the torch ops
``torch.ops.litepose.*`` (``library.py``).

The names below are the JAX package's ops API
(``litepose_tpu/ops/__init__.py``) with JAX's arguments and values:
``heatmap_nms``, ``greedy_assign``, ``hungarian_prefix``, ``match_by_tag``,
``adjust`` and ``refine`` take one image or one cost as JAX's do
(``api.py``, over the batched functions of ``group.py``, ``hungarian.py``
and ``nms.py``, which keep their names there)."""

from .api import adjust, greedy_assign, heatmap_nms, hungarian_prefix, match_by_tag, refine
from .group import GroupParams, StaticGroupCfg, parse_batch, parse_single
from .hungarian import hungarian
from .nms import top_k_peaks

__all__ = [
    "heatmap_nms", "top_k_peaks",
    "greedy_assign", "hungarian", "hungarian_prefix",
    "StaticGroupCfg", "adjust", "match_by_tag", "parse_batch", "parse_single",
    "refine", "GroupParams",
]
