"""Synthetic multi-person scenes without cv2 (counterpart of
``bench_scene_batch`` in ``litepose_tpu/data/synthetic.py``).

Stick figures on dark noise: the same random draws as the JAX package, so
the same people stand at the same joint positions; the lines and dots are
rasterized here in numpy (8-connected lines, filled discs), which differ
from cv2's rasterization in a few edge pixels.  The trained bench
checkpoints were fitted to such scenes, so their peaks on them are real
detections rather than noise.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

LINE_RGB = (110, 110, 110)
DOT_RADIUS = 3


def person_keypoints(rng, cx, cy, size, num_joints) -> np.ndarray:
    """(num_joints, 3) joints on a jittered circle around (cx, cy), all
    visible; the draw order of the JAX ``_person_keypoints``."""
    kps = []
    for j in range(num_joints):
        ang = 2 * np.pi * j / num_joints
        r = size * (0.2 + 0.3 * rng.random())
        kps.append((float(cx + r * np.cos(ang)), float(cy + r * np.sin(ang)), 2.0))
    return np.asarray(kps)


def joint_color(j: int) -> Tuple[int, int, int]:
    return (80 + (j * 97) % 176, 80 + (j * 57 + 41) % 176, 80 + (j * 151 + 83) % 176)


def _line(img: np.ndarray, p0, p1, color) -> None:
    """1-pixel 8-connected line from p0 to p1 (integer endpoints)."""
    (x0, y0), (x1, y1) = p0, p1
    n = max(abs(x1 - x0), abs(y1 - y0)) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _disc(img: np.ndarray, c, radius: int, color) -> None:
    """Filled disc of the pixels within ``radius`` of c."""
    x, y = c
    h, w = img.shape[:2]
    y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
    x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
    ys, xs = np.ogrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][(xs - x) ** 2 + (ys - y) ** 2 <= radius * radius] = color


def draw_person(img: np.ndarray, pts: np.ndarray) -> None:
    """Skeleton polygon through the joints, then one coloured dot each."""
    n = len(pts)
    ij = [(int(x), int(y)) for x, y, _ in pts]
    for j in range(n):
        _line(img, ij[j], ij[(j + 1) % n], LINE_RGB)
    for j, p in enumerate(ij):
        _disc(img, p, DOT_RADIUS, joint_color(j))


def bench_scene_batch(batch: int, size: int, num_joints: int = 14,
                      seed: int = 7, return_gt: bool = False):
    """Deterministic uint8 RGB (batch, size, size, 3) scenes of 2-6 people.

    return_gt=True also returns, per image, the list of drawn people as
    (num_joints, 3) keypoint arrays."""
    rng = np.random.default_rng(seed)
    out = np.empty((batch, size, size, 3), np.uint8)
    gts: List[List[np.ndarray]] = []
    for b in range(batch):
        img = rng.uniform(0, 60, (size, size, 3)).astype(np.uint8)
        people = []
        for _ in range(int(rng.integers(2, 7))):
            cx = rng.uniform(40, size - 40)
            cy = rng.uniform(40, size - 40)
            psize = rng.uniform(30, 100) * size / 512.0
            kps = person_keypoints(rng, cx, cy, psize, num_joints)
            draw_person(img, kps)
            people.append(kps)
        out[b] = img
        gts.append(people)
    return (out, gts) if return_gt else out
