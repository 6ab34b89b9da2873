"""Left-right joint permutations for flip test (counterpart of
``litepose_tpu/data/flip.py``, whose package imports cv2).

COCO joints: nose, eyes, ears, shoulders, elbows, wrists, hips, knees,
ankles (left and right interleaved; the nose mirrors onto itself).
CrowdPose joints: shoulders, elbows, wrists, hips, knees, ankles, then
head-top and neck, which mirror onto themselves.  A centre joint comes
last and mirrors onto itself.
"""

from __future__ import annotations

from typing import List

COCO_PAIRS = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16)]
CROWDPOSE_PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11)]


def _mirror_pairs(num_joints: int, pairs) -> List[int]:
    idx = list(range(num_joints))
    for a, b in pairs:
        idx[a], idx[b] = b, a
    return idx


FLIP_CONFIG = {
    "COCO": _mirror_pairs(17, COCO_PAIRS),
    "COCO_WITH_CENTER": _mirror_pairs(18, COCO_PAIRS),
    "CROWDPOSE": _mirror_pairs(14, CROWDPOSE_PAIRS),
    "CROWDPOSE_WITH_CENTER": _mirror_pairs(15, CROWDPOSE_PAIRS),
}


def flip_index_for(dataset: str, with_center: bool = False) -> List[int]:
    """The flip permutation of a dataset name (COCO or CrowdPose)."""
    if "coco" in dataset:
        name = "COCO"
    elif "crowd_pose" in dataset or "crowdpose" in dataset:
        name = "CROWDPOSE"
    else:
        raise ValueError(f"no flip_index known for dataset {dataset!r}")
    return FLIP_CONFIG[name + "_WITH_CENTER" if with_center else name]
