"""Synthetic multi-person scenes without cv2 (counterpart of
``bench_scene_batch`` and ``make_fixture`` in ``litepose_tpu/data/synthetic.py``).

Stick figures on dark noise: the same random draws as the JAX package, so
the same people stand at the same joint positions; the lines and dots are
rasterized here in numpy (8-connected lines, filled discs), which differ
from cv2's rasterization in a few edge pixels.  The trained bench
checkpoints were fitted to such scenes, so their peaks on them are real
detections rather than noise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


class SyntheticSource:
    """An in-memory training source (``data.dataset.TrainPipeline``'s
    protocol) of ``make_fixture``'s scenes: the same draws, so the same
    people at the same joints, without the JPEG round trip of its files.

    Every person has all joints visible and there are no crowd regions (the
    ``with_edge_cases=False`` set), so the ignore mask is all True.
    n_people_range / size_range: (lo, hi) scene density and person size;
    None keeps ``make_fixture``'s defaults (1-3 people, size 30-60)."""

    def __init__(self, n_images: int = 4, h: int = 160, w: int = 200, num_joints: int = 14,
                 seed: int = 0, n_people_range: Optional[Tuple[int, int]] = None,
                 size_range: Optional[Tuple[float, float]] = None):
        rng = np.random.default_rng(seed)
        self.h, self.w = h, w
        self.images: List[np.ndarray] = []
        self.annotations: List[List[dict]] = []
        ann_id = 1
        for i in range(n_images):
            img = rng.uniform(0, 60, (h, w, 3)).astype(np.uint8)
            if n_people_range is not None:
                n_people = int(rng.integers(n_people_range[0], n_people_range[1] + 1))
            else:
                n_people = 1 + i % 3
            anns = []
            for _ in range(n_people):
                cx = rng.uniform(40, w - 40)
                cy = rng.uniform(40, h - 40)
                size = rng.uniform(*(size_range or (30, 60)))
                pts = person_keypoints(rng, cx, cy, size, num_joints)
                draw_person(img, pts)
                x0, y0 = pts[:, 0].min(), pts[:, 1].min()
                x1, y1 = pts[:, 0].max(), pts[:, 1].max()
                bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
                anns.append({
                    "id": ann_id, "image_id": i, "category_id": 1,
                    "keypoints": [float(v) for v in pts.reshape(-1)],
                    "num_keypoints": num_joints, "bbox": bbox,
                    "area": float(bbox[2] * bbox[3]), "iscrowd": 0,
                    "segmentation": [[float(v) for v in (x0, y0, x1, y0, x1, y1, x0, y1)]],
                })
                ann_id += 1
            self.images.append(img)
            self.annotations.append(anns)

    def __len__(self) -> int:
        return len(self.images)

    def load_raw(self, idx: int):
        """(image RGB uint8, annotations, image_id)."""
        return self.images[idx], list(self.annotations[idx]), idx

    def ignore_mask(self, image_id: int) -> np.ndarray:
        return np.ones((self.h, self.w), bool)
