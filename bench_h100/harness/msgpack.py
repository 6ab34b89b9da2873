"""A frozen msgpack reader for flax checkpoints (copied from
``litepose_tpu_torch/train/checkpoint.py``), so that the benchmark loads
weights with code of its own and hands the same arrays to the program and
to the reference.

A checkpoint is ``{"params", "model_state"}``; arrays are msgpack ext type
1, ``packb((shape, dtype_name, raw_bytes))`` in C order, bfloat16 widened
exactly to float32; lists are maps keyed "0".."n-1".
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Optional, Tuple

import numpy as np

EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def bin_(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int):
        code = self.unpack(">b")
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not an ndarray")
        return _ndarray(bytes(self.take(n)))

    def list_(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.map_(t & 0x0F)
        if t <= 0x9F:
            return self.list_(t & 0x0F)
        if t <= 0xBF:
            return self.str_(t & 0x1F)
        if t in _SIMPLE:
            return _SIMPLE[t]
        if t in _SIZED:
            fmt, method = _SIZED[t]
            return getattr(self, method)(self.unpack(fmt))
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not valid")


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: (">B", "bin_"), 0xC5: (">H", "bin_"), 0xC6: (">I", "bin_"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
          0xD9: (">B", "str_"), 0xDA: (">H", "str_"), 0xDB: (">I", "str_"),
          0xDC: (">H", "list_"), 0xDD: (">I", "list_"),
          0xDE: (">H", "map_"), 0xDF: (">I", "map_")}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw=raw)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape, order="C")


def _restore_lists(tree):
    if not isinstance(tree, dict):
        return tree
    out = {k: _restore_lists(v) for k, v in tree.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def load_params(path: str, sha256: Optional[str] = None) -> Tuple[Any, Any]:
    """(params, model_state): nested dicts and lists of numpy arrays in the
    JAX pytree layout (HWIO conv kernels, spatially flipped HWIO transposed
    conv kernels, BN ``scale``/``bias`` and ``mean``/``var``).  With
    ``sha256``, a file whose bytes hash otherwise raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if sha256 is not None and hashlib.sha256(data).hexdigest() != sha256:
        raise ValueError(f"{path}: its sha256 is {hashlib.sha256(data).hexdigest()}, the "
                         f"configuration pins {sha256}")
    payload = unpackb(data)
    return _restore_lists(payload["params"]), _restore_lists(payload["model_state"])
