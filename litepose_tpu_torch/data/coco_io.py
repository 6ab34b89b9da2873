"""Self-contained COCO-format annotation IO without cv2 (the port's copy of
``litepose_tpu/data/coco_io.py``).

Parses COCO-style keypoint annotation JSONs and provides the two mask
primitives the data pipeline needs (reference usage:
``lib/dataset/COCOKeypoints.py:124-141``):

  * compressed/uncompressed RLE decoding (exact COCO spec), and
  * polygon rasterization equal to ``cv2.fillPoly`` pixel for pixel, by the
    host library's ``csrc/poly_fill.cpp`` (boundary pixels can differ from
    pycocotools' integer rasterizer by <=1 px, irrelevant for training
    ignore-masks).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np


def rle_decode_counts(s: str) -> List[int]:
    """Decode the COCO compressed-RLE `counts` string (LEB128-style 6-bit
    chunks with sign extension and delta coding from the 3rd run on)."""
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """RLE dict {'size': [h, w], 'counts': str|list} -> (h, w) uint8 mask.
    COCO RLE is column-major with runs of 0s first."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = rle_decode_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((w, h)).T


def fill_poly(mask: np.ndarray, contours: Sequence[np.ndarray], color: int = 1) -> np.ndarray:
    """``cv2.fillPoly(mask, contours, color)`` for a uint8 (h, w) mask and
    int32 (n, 2) contours (no shift, 8-connected), in place; returns mask."""
    from ..kernels import build

    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags.c_contiguous:
        raise ValueError("mask must be a C-contiguous uint8 (h, w) array")
    pts = [np.ascontiguousarray(c, np.int32).reshape(-1, 2) for c in contours]
    if not pts:
        return mask
    flat = np.ascontiguousarray(np.concatenate(pts), np.int32)
    npts = np.asarray([len(p) for p in pts], np.int32)
    build.load_host().lp_fill_poly(mask.ctypes.data, mask.shape[0], mask.shape[1],
                                   flat.ctypes.data, npts.ctypes.data, len(pts), int(color))
    return mask


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32) for p in polys if len(p) >= 6]
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list / RLE dict) -> (h, w) uint8."""
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    raise ValueError(f"unsupported segmentation type: {type(seg)}")


class CocoAnnotations:
    """Minimal COCO-format index: images, keypoint annotations, categories."""

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = path_or_dict
        self.dataset = d
        self.imgs: Dict[int, dict] = {img["id"]: img for img in d.get("images", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in d.get("annotations", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for a in d.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
        self.cats = {c["id"]: c for c in d.get("categories", [])}

    @property
    def image_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def annotations_for(self, image_id: int) -> List[dict]:
        return list(self.img_to_anns.get(image_id, []))

    def image_info(self, image_id: int) -> dict:
        return self.imgs[image_id]

    def ignore_mask(self, image_id: int) -> np.ndarray:
        """Training ignore-region mask: True where the loss IS applied.
        Regions of crowd annotations and of keypoint-less instances are
        masked out (reference COCOKeypoints.get_mask semantics)."""
        info = self.imgs[image_id]
        h, w = info["height"], info["width"]
        m = np.zeros((h, w), np.float64)
        for obj in self.img_to_anns.get(image_id, []):
            seg = obj.get("segmentation")
            if seg is None:
                continue
            if obj.get("iscrowd"):
                m += segmentation_to_mask(seg, h, w)
            elif obj.get("num_keypoints", 0) == 0:
                if isinstance(seg, list):
                    for poly in seg:
                        m += polygons_to_mask([poly], h, w)
                else:
                    m += segmentation_to_mask(seg, h, w)
        return m < 0.5
