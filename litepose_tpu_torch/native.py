"""The host decoder: heatmaps to people on the CPU with the C++ peak finder
and grouping of ``csrc/fast_group.cpp`` (counterpart of
``litepose_tpu/native/__init__.py``).

The source is built into the host library (``kernels.build.load_host``,
the JPEG decoder's, with ``c++ -std=c++17 -O2``) at first use and bound
through ctypes with the JAX package's signatures.  It is the demo's
``--backend native`` (``tools/demo.py``): the caller's choice, never a
fallback for the card.  It takes the port's ``GroupParams``
(``ops/group.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np

from .ops.group import GroupParams


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The host library with ``lp_find_peaks`` and ``lp_assign`` typed
    (building it if needed; a failed build raises)."""
    from .kernels import build

    lib = build.load_host()
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.lp_find_peaks.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, i32p, f32p, f32p, f32p,
    ]
    lib.lp_find_peaks.restype = None
    lib.lp_assign.argtypes = [
        i32p, f32p, f32p, f32p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.lp_assign.restype = ctypes.c_int32
    return lib


class NativeHeatmapParser:
    """One image's decode on the host: windowed-maximum peaks (a point is a
    peak when no window neighbour is strictly greater, maxpool-equality
    NMS), the ``max_num_people`` best a joint, then grouping joint by joint
    in ``joint_order`` by the optimal assignment of round(tag distance) *
    100 - score (``use_detection_val``) with 1e10 padding, joining a cluster
    below ``tag_threshold``.  No adjust or refine."""

    def __init__(self, params: GroupParams):
        if not isinstance(params, GroupParams):
            raise TypeError(f"expected ops.group.GroupParams, got {type(params).__name__}")
        self.p = params
        self.lib = load_library()

    def parse(self, det: np.ndarray, tag: np.ndarray) -> Tuple[np.ndarray, List[float]]:
        """det: (K, H, W); tag: (K, H, W, T) -> (people (N, K, 3+T) rows
        [x, y, score, tag...] in heatmap pixels, each person's mean score)."""
        p = self.p
        K, H, W = det.shape
        T = tag.shape[-1]
        order = np.asarray(p.joint_order, np.int32)
        # the C code indexes by these: check them before passing pointers
        if tag.ndim != 4 or tag.shape[:3] != det.shape:
            raise ValueError(f"tag {tuple(tag.shape)} does not match det {tuple(det.shape)} "
                             f"as (K, H, W, T)")
        if sorted(order.tolist()) != list(range(K)):
            raise ValueError(f"joint_order {order.tolist()} is not an order of the {K} joints")
        M = p.max_num_people
        det = np.ascontiguousarray(det, np.float32)
        tag = np.ascontiguousarray(tag, np.float32)
        counts = np.zeros((K,), np.int32)
        vals = np.zeros((K, M), np.float32)
        xys = np.zeros((K, M, 2), np.float32)
        tags = np.zeros((K, M, T), np.float32)
        self.lib.lp_find_peaks(det, tag, K, H, W, T, p.detection_threshold, M, p.nms_kernel,
                               counts, vals, xys, tags)
        people = np.zeros((p.max_clusters, K, 3 + T), np.float32)
        n = self.lib.lp_assign(counts, vals, xys, tags, order, K, M, T, p.tag_threshold,
                               int(p.use_detection_val), int(p.ignore_too_much), M,
                               p.max_clusters, people)
        people = people[:n]
        return people, [float(person[:, 2].mean()) for person in people]
