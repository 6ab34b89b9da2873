"""Training target generation, numpy (a copy of
``litepose_tpu/data/targets.py``, which cannot be imported without cv2: its
package's ``__init__`` imports the dataset, whose transforms import cv2).

Produces, per output scale: Gaussian heatmaps (max-combined stamps) and the
flattened joint-index array consumed by the gather-based AE loss
(``idx = joint * res^2 + y * res + x``, which the loss gathers from the
NCHW tag maps).  The arithmetic is the JAX package's, so the targets are
bit-equal.
"""

from __future__ import annotations

import numpy as np


def _gaussian_patch(sigma: float) -> np.ndarray:
    size = 6 * sigma + 3
    x = np.arange(0, size, 1, float)
    y = x[:, None]
    x0 = y0 = 3 * sigma + 1
    return np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))


def _stamp(hms: np.ndarray, joint_id: int, x: int, y: int, g: np.ndarray, sigma: float):
    res_h, res_w = hms.shape[1:]
    ul = int(np.round(x - 3 * sigma - 1)), int(np.round(y - 3 * sigma - 1))
    br = int(np.round(x + 3 * sigma + 2)), int(np.round(y + 3 * sigma + 2))
    c, d = max(0, -ul[0]), min(br[0], res_w) - ul[0]
    a, b = max(0, -ul[1]), min(br[1], res_h) - ul[1]
    cc, dd = max(0, ul[0]), min(br[0], res_w)
    aa, bb = max(0, ul[1]), min(br[1], res_h)
    hms[joint_id, aa:bb, cc:dd] = np.maximum(hms[joint_id, aa:bb, cc:dd], g[a:b, c:d])


class HeatmapGenerator:
    """Fixed-sigma Gaussian heatmaps; sigma defaults to output_res/64."""

    def __init__(self, output_res: int, num_joints: int, sigma: float = -1):
        self.output_res = output_res
        self.num_joints = num_joints
        self.sigma = output_res / 64 if sigma < 0 else sigma
        self.g = _gaussian_patch(self.sigma)

    def __call__(self, joints: np.ndarray) -> np.ndarray:
        hms = np.zeros((self.num_joints, self.output_res, self.output_res), np.float32)
        for person in joints:
            for jid, pt in enumerate(person):
                if pt[2] > 0:
                    x, y = int(pt[0]), int(pt[1])
                    if 0 <= x < self.output_res and 0 <= y < self.output_res:
                        _stamp(hms, jid, x, y, self.g, self.sigma)
        return hms


class ScaleAwareHeatmapGenerator:
    """Per-person sigma carried in ``joints[..., 3]``."""

    def __init__(self, output_res: int, num_joints: int):
        self.output_res = output_res
        self.num_joints = num_joints

    def __call__(self, joints: np.ndarray) -> np.ndarray:
        hms = np.zeros((self.num_joints, self.output_res, self.output_res), np.float32)
        for person in joints:
            sigma = person[0, 3]
            g = _gaussian_patch(sigma)
            for jid, pt in enumerate(person):
                if pt[2] > 0:
                    x, y = int(pt[0]), int(pt[1])
                    if 0 <= x < self.output_res and 0 <= y < self.output_res:
                        _stamp(hms, jid, x, y, g, sigma)
        return hms


class JointsGenerator:
    """Flattened gather indices for the AE loss: each visible joint becomes
    ``(joint * res^2 + y * res + x, 1)`` packed per person."""

    def __init__(self, max_num_people: int, num_joints: int, output_res: int,
                 tag_per_joint: bool = True):
        self.max_num_people = max_num_people
        self.num_joints = num_joints
        self.output_res = output_res
        self.tag_per_joint = tag_per_joint

    def __call__(self, joints: np.ndarray) -> np.ndarray:
        out = np.zeros((self.max_num_people, self.num_joints, 2), np.float64)
        res = self.output_res
        for i in range(len(joints)):
            tot = 0
            for jid, pt in enumerate(joints[i]):
                x, y = int(pt[0]), int(pt[1])
                if pt[2] > 0 and 0 <= x < res and 0 <= y < res:
                    flat = (jid * res * res + y * res + x) if self.tag_per_joint \
                        else (y * res + x)
                    out[i, tot] = (flat, 1)
                    tot += 1
        return out
