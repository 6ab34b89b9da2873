"""Training targets from the scene generator's keypoints, a frozen copy of
``litepose_tpu_torch/data/targets.py`` (``HeatmapGenerator``,
``JointsGenerator``): per output size, max-combined Gaussian stamps of
``sigma`` and the flat AE gather indices ``joint * res^2 + y * res + x``.
Made by the benchmark and handed to the program and to the reference."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _gaussian(sigma: float) -> np.ndarray:
    size = 6 * sigma + 3
    x = np.arange(0, size, 1, float)
    y = x[:, None]
    c = 3 * sigma + 1
    return np.exp(-((x - c) ** 2 + (y - c) ** 2) / (2 * sigma ** 2))


def heatmaps(people: Sequence[np.ndarray], res: int, num_joints: int, sigma: float) -> np.ndarray:
    hms = np.zeros((num_joints, res, res), np.float32)
    g = _gaussian(sigma)
    for person in people:
        for j, pt in enumerate(person):
            x, y = int(pt[0]), int(pt[1])
            if pt[2] <= 0 or not (0 <= x < res and 0 <= y < res):
                continue
            ul = int(np.round(x - 3 * sigma - 1)), int(np.round(y - 3 * sigma - 1))
            br = int(np.round(x + 3 * sigma + 2)), int(np.round(y + 3 * sigma + 2))
            c, d = max(0, -ul[0]), min(br[0], res) - ul[0]
            a, b = max(0, -ul[1]), min(br[1], res) - ul[1]
            cc, dd = max(0, ul[0]), min(br[0], res)
            aa, bb = max(0, ul[1]), min(br[1], res)
            hms[j, aa:bb, cc:dd] = np.maximum(hms[j, aa:bb, cc:dd], g[a:b, c:d])
    return hms


def joint_indices(people: Sequence[np.ndarray], res: int, num_joints: int,
                  max_people: int) -> np.ndarray:
    out = np.zeros((max_people, num_joints, 2), np.int32)
    for i, person in enumerate(people[:max_people]):
        tot = 0
        for j, pt in enumerate(person):
            x, y = int(pt[0]), int(pt[1])
            if pt[2] > 0 and 0 <= x < res and 0 <= y < res:
                out[i, tot] = (j * res * res + y * res + x, 1)
                tot += 1
    return out


def batch(images: np.ndarray, people: List[List[np.ndarray]], output_sizes: Sequence[int],
          num_joints: int, sigma: float, max_people: int) -> Dict:
    """The train step's host batch: images (B, S, S, 3) uint8 and, per
    output size, heatmaps (B, J, R, R) f32, masks (B, R, R) f32 (all ones:
    the scenes have no crowd regions), joints (B, P, J, 2) int32."""
    size = images.shape[1]
    out = {"images": images, "heatmaps": [], "masks": [], "joints": []}
    for res in output_sizes:
        scaled = [[p * np.array([res / size, res / size, 1.0]) for p in ppl] for ppl in people]
        out["heatmaps"].append(np.stack([heatmaps(p, res, num_joints, sigma) for p in scaled]))
        out["masks"].append(np.ones((len(images), res, res), np.float32))
        out["joints"].append(np.stack([joint_indices(p, res, num_joints, max_people)
                                       for p in scaled]))
    return out
