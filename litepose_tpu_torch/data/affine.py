"""Affine transforms of the eval protocol, numpy only (counterpart of
``litepose_tpu/data/affine.py``, whose package imports cv2).

``get_affine_transform``, ``affine_transform_points``,
``get_multi_scale_size``, ``transform_preds`` and ``get_final_preds`` copy
the JAX package's semantics (the reference's similarity transform by center,
scale x 200 px and rotation, and its 64-px-aligned resize ladder).
``warp_image`` replaces ``cv2.warpAffine`` (bilinear, constant 0 border)
with OpenCV 5.0's float32 arithmetic in numpy, so the port needs no cv2.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

F32, F64 = np.float32, np.float64


def _rot2d(pt, rad):
    sn, cs = np.sin(rad), np.cos(rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32)


def _perp(d):
    return np.array([-d[1], d[0]], dtype=np.float32)


def get_affine_transform(center, scale, rot: float, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """2x3 affine matrix mapping source image coords -> output coords.

    ``scale`` is in units of 200 px; ``rot`` in degrees."""
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], np.float32)
    center = np.asarray(center, np.float32)
    shift = np.asarray(shift, np.float32)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rad = np.pi * rot / 180.0
    src_dir = _rot2d([0.0, src_w * -0.5], rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    src[2] = src[1] + _perp(src[0] - src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = dst[1] + _perp(dst[0] - dst[1])

    if inv:
        src, dst = dst, src
    # solve [x, y, 1] @ M.T = [x', y'] for the three correspondences
    P = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1).astype(np.float64)
    M = np.linalg.solve(P, dst.astype(np.float64))  # (3, 2)
    return M.T  # (2, 3)


def affine_transform_points(pts: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to (N, 2) points."""
    pts = np.asarray(pts, np.float64)
    return pts @ mat[:, :2].T + mat[:, 2]


def _invert_affine(mat: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine in OpenCV's float64 operation order."""
    m = [float(x) for x in np.asarray(mat, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1] = a11, m[1] * -d
    m[3], m[4] = m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.asarray(m).reshape(2, 3)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add.

    The product of two float32 is exact in float64, and the float64 sum
    rounds to float32 as one rounding would, except where it lands exactly
    on a float32 midpoint (o = 2s - r is then the other float32
    neighbour): there the float64 rounding's own error, from TwoSum,
    decides the direction."""
    p = np.asarray(a, F32).astype(F64) * np.asarray(b, F32).astype(F64)
    c = np.asarray(c, F32).astype(F64)
    s = np.asarray(p + c)
    r = s.astype(F32)
    r64 = r.astype(F64)
    o = 2.0 * s - r64
    mid = (s != r64) & (o.astype(F32) == o)
    if not mid.any():
        return r
    pm, cm, sm = np.broadcast_to(p, s.shape)[mid], np.broadcast_to(c, s.shape)[mid], s[mid]
    bv = sm - pm
    err = (pm - (sm - bv)) + (cm - bv)
    rm, om = r[mid], o[mid].astype(F32)
    r[mid] = np.where(err > 0, np.maximum(rm, om), np.where(err < 0, np.minimum(rm, om), rm))
    return r


def warp_image(image: np.ndarray, mat: np.ndarray, output_size) -> np.ndarray:
    """``cv2.warpAffine(image, mat, output_size)`` for uint8 images, bilinear
    with a constant 0 border, in numpy; bit-equal to OpenCV 5.0's float
    warp on the resize ladder's matrices.

    With m the inverted matrix in float32, output pixel (x, y) samples the
    source at X = fma(m00, x, m01*y + m02), Y = fma(m10, x, m11*y + m12)
    (each row term rounded twice, plainly); its four neighbours (zero
    outside the image) mix by two float32 lerps along x and one along y,
    each an FMA, and the result rounds half to even."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"warp_image takes uint8 images, got {image.dtype}")
    out_w, out_h = int(output_size[0]), int(output_size[1])
    h, w = image.shape[:2]
    m = _invert_affine(mat).astype(F32)
    xs = np.arange(out_w, dtype=F32)[None, :]
    ys = np.arange(out_h, dtype=F32)[:, None]
    X = _fma32(m[0, 0], xs, m[0, 1] * ys + m[0, 2])  # (out_h, out_w)
    Y = _fma32(m[1, 0], xs, m[1, 1] * ys + m[1, 2])
    x0 = np.floor(X)
    y0 = np.floor(Y)
    ax = (X - x0)[..., None]
    ay = (Y - y0)[..., None]
    # a zero border of one pixel: every neighbour outside the image reads 0
    src = np.pad(image.reshape(h, w, -1), ((1, 1), (1, 1), (0, 0))).astype(F32)
    xi = np.clip(x0, -1, w).astype(np.int64) + 1
    yi = np.clip(y0, -1, h).astype(np.int64) + 1
    xj = np.clip(x0 + 1, -1, w).astype(np.int64) + 1
    yj = np.clip(y0 + 1, -1, h).astype(np.int64) + 1
    top = _lerp_pixels(ax, src[yi, xi], src[yi, xj])
    bottom = _lerp_pixels(ax, src[yj, xi], src[yj, xj])
    out = np.clip(np.rint(_fma32(ay, bottom - top, top)), 0, 255).astype(np.uint8)
    return out.reshape((out_h, out_w) + image.shape[2:])


def _lerp_pixels(a: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """fma(a, p1 - p0, p0) for integer pixel values p0, p1 in [0, 255] and
    a in [0, 1).  The float64 sum is exact, so one rounding to float32
    suffices, unless 0 < a < 2^-20 leaves the product's low bits below
    float64's reach: those elements take ``_fma32``."""
    d = p1 - p0
    out = (a.astype(F64) * d + p0).astype(F32)
    tiny = np.broadcast_to((a > 0) & (a < 2.0 ** -20), out.shape)
    if tiny.any():
        out[tiny] = _fma32(np.broadcast_to(a, out.shape)[tiny], d[tiny], p0[tiny])
    return out


def get_multi_scale_size(image_shape: Tuple[int, int], input_size: int,
                         current_scale: float, min_scale: float):
    """64-aligned resize target for a test scale.

    image_shape: (h, w).  Returns ((w_resized, h_resized), center, scale)."""
    h, w = image_shape[:2]
    center = np.array([int(w / 2.0 + 0.5), int(h / 2.0 + 0.5)], np.float32)
    min_input_size = int((min_scale * input_size + 63) // 64 * 64)
    if w < h:
        w_resized = int(min_input_size * current_scale / min_scale)
        h_resized = int(int((min_input_size / w * h + 63) // 64 * 64) * current_scale / min_scale)
        scale_w = w / 200.0
        scale_h = h_resized / w_resized * w / 200.0
    else:
        h_resized = int(min_input_size * current_scale / min_scale)
        w_resized = int(int((min_input_size / h * w + 63) // 64 * 64) * current_scale / min_scale)
        scale_h = h / 200.0
        scale_w = w_resized / h_resized * h / 200.0
    return (w_resized, h_resized), center, np.array([scale_w, scale_h], np.float32)


def transform_preds(coords: np.ndarray, center, scale, output_size) -> np.ndarray:
    """Project (x, y, ...) rows from heatmap space back to source image
    coords."""
    out = np.array(coords, np.float64, copy=True)
    mat = get_affine_transform(center, scale, 0, output_size, inv=True)
    out[:, :2] = affine_transform_points(coords[:, :2], mat)
    return out


def get_final_preds(grouped_people: np.ndarray, center, scale,
                    heatmap_size) -> List[np.ndarray]:
    """Inverse-project each person's joints to source image coordinates.

    grouped_people: (N, K, >=3); heatmap_size: (w, h)."""
    return [transform_preds(person, center, scale, heatmap_size)
            for person in grouped_people]
