"""``cv2.resize(img, (w, h))`` (INTER_LINEAR) of uint8 images, bit for bit,
in numpy: the resize the NAS predictors' calibration batches take
(``litepose_tpu/nas/predictors.py:_calib_batches``).

OpenCV's 8-bit bilinear path is fixed point with 11-bit coefficients:

* a coefficient is ``cvRound(c * 2048)`` of the float32 weight ``c``, the
  source coordinate ``(d + 0.5) * scale - 0.5`` computed in double and
  rounded to float;
* the horizontal pass sums ``S[x] * a0 + S[x + 1] * a1`` in integers; a
  column left of the first pixel or right of the last takes that pixel with
  weight 2048 alone;
* the vertical pass is ``((b0 * (R0 >> 4)) >> 16) + ((b1 * (R1 >> 4)) >> 16)
  + 2 >> 2`` over the two rows' sums; its coefficients are not clamped at
  the borders (the two rows are the same clipped row there, and the two
  floors can lose one);
* an exact 2x downscale on both axes is INTER_AREA's fast path,
  ``(a + b + c + d + 2) >> 2`` over each 2x2 block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_SCALE = 2048  # 1 << INTER_RESIZE_COEF_BITS


def _coeffs(n_in: int, n_out: int, clamp: bool):
    """(first source index, second, weight of the first, of the second)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        left, right = s < 0, s >= n_in - 1
        f[left], s[left] = 0, 0
        f[right], s[right] = 0, n_in - 1
    c0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    c1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), c0, c1


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> (h, w[, C]) for ``size = (w, h)``, equal to
    ``cv2.resize(img, size)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, got {img.dtype}")
    w, h = size
    height, width = img.shape[:2]
    x = img.astype(np.int64)
    if width == 2 * w and height == 2 * h:
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    tail = (1,) * (img.ndim - 2)
    sx0, sx1, a0, a1 = _coeffs(width, w, clamp=True)
    sy0, sy1, b0, b1 = _coeffs(height, h, clamp=False)
    rows = x[:, sx0] * a0.reshape((1, -1) + tail) + x[:, sx1] * a1.reshape((1, -1) + tail)
    out = (((b0.reshape((-1, 1) + tail) * (rows[sy0] >> 4)) >> 16)
           + ((b1.reshape((-1, 1) + tail) * (rows[sy1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
