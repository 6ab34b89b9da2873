"""Left-right joint permutation for flip test, CrowdPose only (counterpart
of ``litepose_tpu/data/flip.py``, whose package imports cv2).

CrowdPose joints: shoulders, elbows, wrists, hips, knees, ankles (left and
right interleaved), then head-top and neck, which mirror onto themselves.
The COCO tables come with the eval slice.
"""

from __future__ import annotations

from typing import List

CROWDPOSE_PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11)]


def _mirror_pairs(num_joints: int, pairs) -> List[int]:
    idx = list(range(num_joints))
    for a, b in pairs:
        idx[a], idx[b] = b, a
    return idx


FLIP_CONFIG = {
    "CROWDPOSE": _mirror_pairs(14, CROWDPOSE_PAIRS),
    "CROWDPOSE_WITH_CENTER": _mirror_pairs(15, CROWDPOSE_PAIRS),
}


def flip_index_for(dataset: str, with_center: bool = False) -> List[int]:
    """The flip permutation of a CrowdPose dataset name."""
    if "crowd_pose" not in dataset and "crowdpose" not in dataset:
        raise ValueError(f"no flip_index ported for dataset {dataset!r} "
                         "(only CrowdPose so far)")
    return FLIP_CONFIG["CROWDPOSE_WITH_CENTER" if with_center else "CROWDPOSE"]
