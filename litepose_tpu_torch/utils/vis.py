"""Visualization: skeletons, heatmap and tag-map grids, debug images, PNG
files, without cv2 (the port's copy of ``litepose_tpu/utils/vis.py``).

The JAX package draws with cv2; this module sets the same pixels:

- ``line``: ``cv2.line(img, p0, p1, color, thickness)`` with 8-connected
  edges (the default) for thickness >= 2.  OpenCV 5.0 first clips the
  segment to the image grown by ``thickness`` on every side
  (``clipLine``), then draws it as a convex polygon in 16.16 fixed point
  (``ThickLine`` -> ``FillConvexPoly``, its edges stepped in fixed point
  as ``Line2``) and a filled circle of radius ``thickness / 2`` at each
  end;
- ``circle``: ``cv2.circle(img, center, radius, color, -1)`` (the
  midpoint circle's spans, ``Circle`` with ``fill``);
- the JET colour map is cv2's 256-entry table (``COLORMAP_JET``), and
  resizes are ``data.resize.resize_linear`` (``cv2.resize``).

Images are written as 8-bit RGB PNG (stdlib ``zlib``): the port has no
JPEG encoder.  Rasterization is in Python integers, which hold the
fixed-point products as C's int64 does.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ..data import VIS_CONFIG
from ..data.resize import resize_linear

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_DBL_EPSILON = 2.220446049250313e-16

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET), BGR
_JET_BGR = bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc0000"
    "c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000"
    "ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00"
    "ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00"
    "ffc000ffc400ffc800ffcc00ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2eceff32caff36c6ff3ac2ff3e"
    "beff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e"
    "7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe"
    "00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff"
    "00bcff00b8ff00b4ff00b0ff00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff004cff0048ff0044ff0040ff"
    "003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff"
    "0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c000088000084000080"
)



def _colors(n: int):
    rng = np.random.default_rng(1234)
    return [tuple(int(c) for c in rng.integers(60, 255, 3)) for _ in range(n)]


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` to the (w, h) image: the clipped end points, or
    None when the segment misses it."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """``Line2``: an 8-connected line between 16.16 fixed-point points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    along_x = abs(dx) > abs(dy)
    if along_x:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        x_step, y_step = _tdiv(dx << XY_SHIFT, abs(dy) | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT, color)
    x1 += half
    y1 += half
    if along_x:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1


def _fill_convex(img: np.ndarray, v: Sequence[Tuple[int, int]], color) -> None:
    """``FillConvexPoly`` of 16.16 fixed-point vertices, 8-connected edges."""
    h, w = img.shape[:2]
    n = len(v)
    half = XY_ONE >> 1
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per side: [vertex index, step, x, dx, the row it ends at]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    x0, x1 = v[idx0][0], v[idx][0]
                    e[3] = _tdiv((x1 - x0) * 2 + (ty - y), 2 * (ty - y))
                    e[2], e[0], e[4] = x0, idx, ty
                    break
                idx0 = idx
                idx = (idx + e[1]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            xx1 = (left[2] + half) >> XY_SHIFT
            xx2 = (right[2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center: Tuple[int, int], radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` in place."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, x1, x2):
        if 0 <= y < h:
            img[y, max(x1, 0):min(x2, w - 1) + 1] = color

    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and cy - dx < h and cy + dx >= 0:
            span(cy - dy, x11, x12)
            span(cy + dy, x11, x12)
            if x21 < w and x22 >= 0:
                span(cy - dx, x21, x22)
                span(cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color,
         thickness: int = 2) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` in place, thickness >= 2."""
    if thickness < 2:
        raise ValueError(f"line draws thickness 2 and more, got {thickness}")
    h, w = img.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, p0[0] + m, p0[1] + m, p1[0] + m, p1[1] + m)
    if clipped is None:
        return
    ax, ay, bx, by = (c - m for c in clipped)
    ax, ay, bx, by = ax << XY_SHIFT, ay << XY_SHIFT, bx << XY_SHIFT, by << XY_SHIFT
    ddx, ddy = (ax - bx) / XY_ONE, (by - ay) / XY_ONE
    r = ddx * ddx + ddy * ddy
    half_width = thickness << (XY_SHIFT - 1)
    if abs(r) > _DBL_EPSILON:
        r = (half_width + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(ddy * r), round(ddx * r)  # cvRound: half to even
        _fill_convex(img, [(ax + dpx, ay + dpy), (ax - dpx, ay - dpy),
                           (bx - dpx, by - dpy), (bx + dpx, by + dpy)], color)
    cap = (half_width + (XY_ONE >> 1)) >> XY_SHIFT
    for px, py in ((ax, ay), (bx, by)):
        circle(img, ((px + (XY_ONE >> 1)) >> XY_SHIFT, (py + (XY_ONE >> 1)) >> XY_SHIFT),
               cap, color)


def draw_skeleton(
    image_rgb: np.ndarray,
    people: Sequence[np.ndarray],
    dataset: str = "CROWDPOSE",
    score_threshold: float = 0.1,
    radius: int = 3,
    thickness: int = 2,
) -> np.ndarray:
    """Render detected people onto a copy of the image.

    people: iterable of (K, >=3) arrays in image coordinates.
    """
    canvas = np.ascontiguousarray(image_rgb.copy())
    skeleton = VIS_CONFIG[dataset]["vis_skeleton"]
    palette = _colors(max(len(people), 1))
    for pid, person in enumerate(people):
        color = palette[pid % len(palette)]
        pts = np.asarray(person)
        for a, b in skeleton:
            if a < len(pts) and b < len(pts) and pts[a, 2] > score_threshold and pts[b, 2] > score_threshold:
                pa = (int(pts[a, 0]), int(pts[a, 1]))
                pb = (int(pts[b, 0]), int(pts[b, 1]))
                line(canvas, pa, pb, color, thickness)
        for j in range(len(pts)):
            if pts[j, 2] > score_threshold:
                circle(canvas, (int(pts[j, 0]), int(pts[j, 1])), radius, color)
    return canvas


def write_png(path: str, image_rgb: np.ndarray) -> None:
    """Write uint8 (H, W, 3) RGB or (H, W) gray as an 8-bit PNG."""
    img = np.ascontiguousarray(image_rgb)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W, 3) or (H, W), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as ``write_png`` writes it: 8-bit gray or RGB, no
    interlace, unfiltered rows."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    refused = ValueError(f"{path}: only 8-bit gray or RGB PNG without interlace or row "
                         f"filters is read")
    if depth != 8 or color_type not in (0, 2) or interlace:
        raise refused
    bpp = 3 if color_type == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * bpp + 1)
    if raw[:, 0].any():
        raise refused
    return raw[:, 1:].reshape((h, w, 3) if bpp == 3 else (h, w)).copy()


def save_valid_image(image_rgb, people, path: str, dataset: str = "CROWDPOSE"):
    """``draw_skeleton`` written to ``path`` as PNG."""
    canvas = draw_skeleton(image_rgb, people, dataset)
    write_png(path, canvas)
    return canvas


def make_heatmaps_grid(image_rgb: np.ndarray, heatmaps: np.ndarray) -> np.ndarray:
    """Side-by-side grid of the image blended with each joint heatmap.

    heatmaps: (K, H, W) in [0, 1]-ish.
    """
    K, h, w = heatmaps.shape
    image = resize_linear(image_rgb, (w, h))
    jet_rgb = np.frombuffer(_JET_BGR, np.uint8).reshape(256, 3)[:, ::-1]
    panels = [image]
    for k in range(K):
        hm = np.clip(heatmaps[k], 0, 1)
        hm8 = (hm * 255).astype(np.uint8)
        colored = jet_rgb[hm8]
        blend = (image * 0.3 + colored * 0.7).astype(np.uint8)
        panels.append(blend)
    return np.concatenate(panels, axis=1)


def make_tagmaps_grid(image_rgb: np.ndarray, tagmaps: np.ndarray) -> np.ndarray:
    """Grid of normalized tag maps. tagmaps: (K, H, W[, T])."""
    if tagmaps.ndim == 4:
        tagmaps = tagmaps[..., 0]
    lo, hi = float(tagmaps.min()), float(tagmaps.max())
    norm = (tagmaps - lo) / max(hi - lo, 1e-6)
    return make_heatmaps_grid(image_rgb, norm)


def save_debug_images(
    image_rgb: np.ndarray,
    prefix: str,
    heatmaps_gt: Optional[np.ndarray] = None,
    heatmaps_pred: Optional[np.ndarray] = None,
    tagmaps_pred: Optional[np.ndarray] = None,
):
    """Dump the debug grids the reference writes during training
    (``lib/utils/vis.py:209-238``), as ``<prefix>_<name>.png``."""

    def w(name, grid):
        write_png(f"{prefix}_{name}.png", grid)

    if heatmaps_gt is not None:
        w("hm_gt", make_heatmaps_grid(image_rgb, heatmaps_gt))
    if heatmaps_pred is not None:
        w("hm_pred", make_heatmaps_grid(image_rgb, heatmaps_pred))
    if tagmaps_pred is not None:
        w("tag_pred", make_tagmaps_grid(image_rgb, tagmaps_pred))
