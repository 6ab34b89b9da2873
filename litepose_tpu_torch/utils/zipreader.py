"""Images inside zip archives: ``path/to/archive.zip@inner/img.jpg``
(counterpart of ``litepose_tpu/utils/zipreader.py``, the reference's
``lib/utils/zipreader.py``), with cached archive handles.

``imread`` returns what the JAX package's returns,
``cv2.imdecode(..., IMREAD_COLOR)``: BGR, EXIF orientation applied.  It
decodes with the port's JPEG decoder (``data/jpeg.py``), so a member that
is not a baseline or extended sequential JPEG raises ``ValueError`` naming
the path.  Neither package's dataset reads ``DATA_FORMAT: zip``.
"""

from __future__ import annotations

import zipfile
from typing import Dict, Tuple

import numpy as np

_SPLIT = "@"
_handles: Dict[str, zipfile.ZipFile] = {}


def is_zip_path(path: str) -> bool:
    return _SPLIT in path and ".zip" in path


def split_zip_path(path: str) -> Tuple[str, str]:
    archive, inner = path.split(_SPLIT, 1)
    assert archive.endswith(".zip"), f"not a zip archive: {archive}"
    return archive, inner


def read_bytes(path: str) -> bytes:
    """The bytes of ``archive.zip@inner``; the archive stays open for the
    next read until ``close_all``."""
    archive, inner = split_zip_path(path)
    handle = _handles.get(archive)
    if handle is None:
        handle = zipfile.ZipFile(archive, "r")
        _handles[archive] = handle
    return handle.read(inner)


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of the JPEG member ``path``."""
    from ..data.jpeg import decode_jpeg

    return np.ascontiguousarray(decode_jpeg(read_bytes(path), name=path)[..., ::-1])


def close_all() -> None:
    for h in _handles.values():
        h.close()
    _handles.clear()
