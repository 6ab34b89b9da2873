"""Affine transforms and the resize ladder, COCO annotation IO, JPEG
decoding, OKS evaluation, datasets on disk, synthetic scenes and the
training input pipeline, without cv2; and the part labels and skeletons
that ``utils.vis`` draws."""

# Part labels and skeletons for visualization (reference VIS_CONFIG,
# lib/dataset/__init__.py:12-70; the port's copy of
# litepose_tpu/data/__init__.py:10-35, whose package imports cv2).
COCO_PART_LABELS = [
    "nose", "eye_l", "eye_r", "ear_l", "ear_r", "sho_l", "sho_r",
    "elb_l", "elb_r", "wri_l", "wri_r", "hip_l", "hip_r",
    "kne_l", "kne_r", "ank_l", "ank_r",
]
COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]
CROWDPOSE_PART_LABELS = [
    "sho_l", "sho_r", "elb_l", "elb_r", "wri_l", "wri_r",
    "hip_l", "hip_r", "kne_l", "kne_r", "ank_l", "ank_r", "head", "neck",
]
CROWDPOSE_SKELETON = [
    (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (0, 6), (1, 7), (6, 7),
    (6, 8), (7, 9), (8, 10), (9, 11), (12, 13), (13, 0), (13, 1),
]
VIS_CONFIG = {
    "COCO": {"part_labels": COCO_PART_LABELS, "vis_skeleton": COCO_SKELETON},
    "CROWDPOSE": {"part_labels": CROWDPOSE_PART_LABELS, "vis_skeleton": CROWDPOSE_SKELETON},
}
