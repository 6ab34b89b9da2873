"""JPEG files to RGB arrays without cv2 (the image reader of
``litepose_tpu/data/dataset.py:_load_image``).

``decode_jpeg`` gives the bytes of ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``: the decode itself is the host
library built from ``csrc/jpeg_decode.cpp`` (libjpeg-turbo's default
integer pipeline, step for step), and the EXIF orientation that ``imread``
applies for ``IMREAD_COLOR`` is applied here.  Baseline and extended
sequential Huffman JPEGs with 8-bit samples and 1 or 3 components decode;
every other kind (progressive, arithmetic-coded, lossless, hierarchical,
12-bit, CMYK/YCCK) raises a ``ValueError`` that names the file and the
kind.  ``jpeg_size`` reads the size from the headers alone.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple, Union

import numpy as np

# frame markers that are not baseline or extended sequential Huffman
_FRAME_KINDS = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "hierarchical sequential (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
_SOF = (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)
# lp_jpeg_decode's error codes
_ERRORS = {
    1: "not a JPEG file (no SOI marker)", 2: "corrupt or truncated data",
    3: "progressive JPEG", 4: "arithmetic-coded JPEG", 5: "lossless or hierarchical JPEG",
    6: "sample precision other than 8 bits", 7: "component count other than 1 or 3",
    8: "sampling factors that do not divide the largest", 9: "no frame header",
    10: "a scan uses an undefined Huffman or quantization table",
    11: "frame size differs from its header",
}

Source = Union[str, os.PathLike, bytes]


def _read(src: Source) -> Tuple[bytes, str]:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


def _segments(data: bytes) -> Iterator[Tuple[int, int, int]]:
    """(marker, payload offset, payload length) of the header segments, up
    to the first scan."""
    if data[:2] != b"\xff\xd8":
        return
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xD9, 0xDA):
            return
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        yield marker, pos + 4, length - 2
        pos += 2 + length


def _frame(data: bytes, name: str) -> Tuple[int, int, int, int, int]:
    """(marker, precision, height, width, components) of the frame header."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: {_ERRORS[1]}")
    for marker, off, n in _segments(data):
        if marker in _SOF:
            if n < 6:
                raise ValueError(f"{name}: {_ERRORS[2]}")
            p, h, w, nc = struct.unpack(">BHHB", data[off:off + 6])
            return marker, p, h, w, nc
    raise ValueError(f"{name}: {_ERRORS[9]}")


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of the first ``Exif`` APP1 segment's
    IFD0, else 1, as OpenCV's ExifReader reads it."""
    for marker, off, n in _segments(data):
        if marker != 0xE1 or n <= 6 or data[off:off + 6] != b"Exif\x00\x00":
            continue
        tiff = data[off + 6:off + n]
        if tiff[:2] not in (b"II", b"MM") or len(tiff) < 8:
            return 1
        e = "<" if tiff[:2] == b"II" else ">"
        ifd = struct.unpack(e + "I", tiff[4:8])[0]
        if ifd + 2 > len(tiff):
            return 1
        count = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
        for i in range(count):
            at = ifd + 2 + 12 * i
            if at + 12 > len(tiff):
                break
            tag, typ = struct.unpack(e + "HH", tiff[at:at + 4])
            if tag == 0x0112:
                if typ == 3:  # SHORT: the value's first two bytes
                    value = struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
                else:
                    value = struct.unpack(e + "I", tiff[at + 8:at + 12])[0]
                return value if 1 <= value <= 8 else 1
        return 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: flips and transposes of the stored image."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def jpeg_size(src: Source) -> Tuple[int, int]:
    """(height, width) of the image ``decode_jpeg`` returns, from the
    headers alone (EXIF orientations 5-8 swap the two)."""
    data, name = _read(src)
    _, _, h, w, _ = _frame(data, name)
    return (w, h) if exif_orientation(data) >= 5 else (h, w)


def decode_jpeg(src: Source) -> np.ndarray:
    """A JPEG file (a path, or its bytes) -> (H, W, 3) uint8 RGB, equal to
    cv2's ``imread(IMREAD_COLOR)`` turned to RGB.  Raises ``ValueError``,
    naming the file and the kind, for a JPEG it does not decode.  The host
    library builds at first use (``kernels.build.load_host``)."""
    from ..kernels import build

    data, name = _read(src)
    marker, precision, h, w, nc = _frame(data, name)
    if marker in _FRAME_KINDS:
        raise ValueError(f"{name}: {_FRAME_KINDS[marker]} JPEG is not supported "
                         f"(baseline or extended sequential Huffman only)")
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG is not supported (8-bit only)")
    if nc not in (1, 3):
        raise ValueError(f"{name}: {nc}-component JPEG (CMYK/YCCK) is not supported")
    out = np.empty((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    err = build.load_host().lp_jpeg_decode(buf.ctypes.data, len(data), out.ctypes.data, h, w)
    if err:
        raise ValueError(f"{name}: {_ERRORS.get(err, f'decoder error {err}')}")
    return _orient(out, exif_orientation(data))
