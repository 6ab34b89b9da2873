"""Synthetic multi-person scenes, a frozen copy of ``bench_scene_batch`` in
``litepose_tpu_torch/data/synthetic.py`` with the seed and the scene
parameters taken from the traffic mix.

Stick figures on dark noise: per image, uniform noise in [0, 60), then
2-6 people (``people``), each a jittered circle of joints of size 30-100 px
at 512 px (``person_size``, scaled to the image), drawn as an 8-connected
polygon and one coloured disc a joint.  The draw order is the copied
function's, so a seed gives the same scenes as ``bench_scene_batch`` does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

LINE_RGB = (110, 110, 110)
DOT_RADIUS = 3


def person_keypoints(rng, cx, cy, size, num_joints) -> np.ndarray:
    kps = []
    for j in range(num_joints):
        ang = 2 * np.pi * j / num_joints
        r = size * (0.2 + 0.3 * rng.random())
        kps.append((float(cx + r * np.cos(ang)), float(cy + r * np.sin(ang)), 2.0))
    return np.asarray(kps)


def joint_color(j: int) -> Tuple[int, int, int]:
    return (80 + (j * 97) % 176, 80 + (j * 57 + 41) % 176, 80 + (j * 151 + 83) % 176)


def _line(img: np.ndarray, p0, p1, color) -> None:
    (x0, y0), (x1, y1) = p0, p1
    n = max(abs(x1 - x0), abs(y1 - y0)) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _disc(img: np.ndarray, c, radius: int, color) -> None:
    x, y = c
    h, w = img.shape[:2]
    y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
    x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
    ys, xs = np.ogrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][(xs - x) ** 2 + (ys - y) ** 2 <= radius * radius] = color


def draw_person(img: np.ndarray, pts: np.ndarray) -> None:
    n = len(pts)
    ij = [(int(x), int(y)) for x, y, _ in pts]
    for j in range(n):
        _line(img, ij[j], ij[(j + 1) % n], LINE_RGB)
    for j, p in enumerate(ij):
        _disc(img, p, DOT_RADIUS, joint_color(j))


def scene_batch(batch: int, size: int, seed: int, num_joints: int = 14,
                people: Sequence[int] = (2, 6), person_size: Sequence[float] = (30, 100)
                ) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
    """uint8 RGB (batch, size, size, 3) scenes and, per image, its people
    as (num_joints, 3) keypoint arrays (x, y, visibility 2)."""
    rng = np.random.default_rng(seed)
    out = np.empty((batch, size, size, 3), np.uint8)
    gts: List[List[np.ndarray]] = []
    for b in range(batch):
        img = rng.uniform(0, 60, (size, size, 3)).astype(np.uint8)
        drawn = []
        for _ in range(int(rng.integers(people[0], people[1] + 1))):
            cx = rng.uniform(40, size - 40)
            cy = rng.uniform(40, size - 40)
            psize = rng.uniform(person_size[0], person_size[1]) * size / 512.0
            kps = person_keypoints(rng, cx, cy, psize, num_joints)
            draw_person(img, kps)
            drawn.append(kps)
        out[b] = img
        gts.append(drawn)
    return out, gts
