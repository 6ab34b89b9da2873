"""Training-time augmentation, numpy (counterpart of
``litepose_tpu/data/transforms.py``, with ``cv2.warpAffine`` replaced by
``data.affine.warp_image``, which equals OpenCV 5.0's warp bit for bit).

Joint-aware random affine and horizontal flip, drawn from an explicit
``numpy`` Generator.  The affine scales the (200*s)-sized crop around
``center`` to the square output, then rotates about the output centre.
Output images are uint8 RGB; normalization happens on the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .affine import warp_image


def crop_affine_matrix(center, scale: float, res: Tuple[int, int], rot: float = 0.0) -> np.ndarray:
    """3x3 matrix: source coords -> (res, res) output, rotation about the
    output center."""
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rad = -rot * np.pi / 180  # cropping rotation direction convention
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
        shift_to = np.eye(3)
        shift_to[0, 2] = -res[1] / 2
        shift_to[1, 2] = -res[0] / 2
        shift_back = np.eye(3)
        shift_back[0, 2] = res[1] / 2
        shift_back[1, 2] = res[0] / 2
        t = shift_back @ rot_mat @ shift_to @ t
    return t


def apply_affine_to_points(pts: np.ndarray, mat: np.ndarray) -> np.ndarray:
    shape = pts.shape
    flat = pts.reshape(-1, 2)
    out = flat @ mat[:2, :2].T + mat[:2, 2]
    return out.reshape(shape)


class TrainTransform:
    """Random affine + flip over (image, per-scale masks, per-scale joints)."""

    def __init__(self, input_size: int, output_sizes: Sequence[int],
                 max_rotation: float = 30.0, min_scale: float = 0.75,
                 max_scale: float = 1.5, scale_type: str = "short",
                 max_translate: int = 40, flip_prob: float = 0.5,
                 flip_index: Optional[Sequence[int]] = None,
                 scale_aware_sigma: bool = False):
        self.input_size = input_size
        self.output_sizes = list(output_sizes)
        self.max_rotation = max_rotation
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.scale_type = scale_type
        self.max_translate = max_translate
        self.flip_prob = flip_prob
        self.flip_index = list(flip_index) if flip_index is not None else None
        self.scale_aware_sigma = scale_aware_sigma

    def __call__(self, image: np.ndarray, masks: List[np.ndarray],
                 joints: List[np.ndarray], rng: np.random.Generator):
        assert len(masks) == len(joints) == len(self.output_sizes)
        height, width = image.shape[:2]
        center = np.array((width / 2, height / 2))
        if self.scale_type == "long":
            scale = max(height, width) / 200
        elif self.scale_type == "short":
            scale = min(height, width) / 200
        else:
            raise ValueError(f"unknown scale type {self.scale_type!r}")
        aug_scale = rng.random() * (self.max_scale - self.min_scale) + self.min_scale
        scale *= aug_scale
        aug_rot = (rng.random() * 2 - 1) * self.max_rotation

        if self.max_translate > 0:
            bound = int(self.max_translate * scale)
            center[0] += rng.integers(-bound, bound)
            center[1] += rng.integers(-bound, bound)

        for i, out_size in enumerate(self.output_sizes):
            mat = crop_affine_matrix(center, scale, (out_size, out_size), aug_rot)[:2]
            warped = warp_image((masks[i] * 255).astype(np.uint8), mat, (out_size, out_size)) / 255
            masks[i] = (warped > 0.5).astype(np.float32)
            joints[i][:, :, 0:2] = apply_affine_to_points(joints[i][:, :, 0:2], mat)
            if self.scale_aware_sigma:
                joints[i][:, :, 3] = joints[i][:, :, 3] / aug_scale

        mat_in = crop_affine_matrix(center, scale, (self.input_size, self.input_size), aug_rot)[:2]
        image = warp_image(image, mat_in, (self.input_size, self.input_size))

        # horizontal flip
        if self.flip_index is not None and rng.random() < self.flip_prob:
            image = np.ascontiguousarray(image[:, ::-1])
            for i, out_size in enumerate(self.output_sizes):
                masks[i] = np.ascontiguousarray(masks[i][:, ::-1])
                joints[i] = joints[i][:, self.flip_index]
                joints[i][:, :, 0] = out_size - joints[i][:, :, 0] - 1

        return image, masks, joints
