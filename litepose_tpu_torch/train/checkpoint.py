"""Read the JAX package's flax msgpack checkpoints without flax or msgpack
(counterpart of ``load_params`` in ``litepose_tpu/train/checkpoint.py``).

A checkpoint is ``flax.serialization.msgpack_serialize`` of
``{"params": ..., "model_state": ...}``.  The reader covers what flax
writes:

* msgpack maps, arrays, str, bin, nil, bool, int and float;
* ext type 1 (ndarray): ``packb((shape, dtype_name, raw_bytes))``, C order
  (bfloat16 widened exactly to fp32, numpy having no bfloat16);
* lists, which flax stores as maps keyed ``"0"``, ``"1"``, ...;
  ``load_params`` turns those back into lists.

Flax's other ext types (numpy scalars, complex) and its chunked form of
arrays above 1 GiB do not occur in LitePose checkpoints and are refused.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1


class _Reader:
    """A msgpack decoder over one bytes object (big-endian wire format)."""

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
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not an ndarray")
        return _ndarray(bytes(self.take(n)))

    def read(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: (">B", lambda n: bytes(self.take(n))),
            0xC5: (">H", lambda n: bytes(self.take(n))),
            0xC6: (">I", lambda n: bytes(self.take(n))),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
            0xD9: (">B", self.str_), 0xDA: (">H", self.str_), 0xDB: (">I", self.str_),
            0xDC: (">H", lambda n: [self.read() for _ in range(n)]),
            0xDD: (">I", lambda n: [self.read() for _ in range(n)]),
            0xDE: (">H", self.map_), 0xDF: (">I", self.map_),
        }
        if t in sized:
            fmt, fn = sized[t]
            return fn(self.unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not valid")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object (str as ``str`` unless ``raw``)."""
    r = _Reader(data, raw=raw)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":  # no numpy dtype: widen exactly to fp32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape, order="C")


def _is_list_map(d: dict) -> bool:
    return bool(d) and all(isinstance(k, str) for k in d) and \
        sorted(d) == sorted(str(i) for i in range(len(d)))


def _as_list(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _restore_lists(tree):
    """Maps keyed "0".."n-1" (flax's form of a list) become lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _restore_lists(v) for k, v in tree.items()}
    return _as_list(out) if _is_list_map(out) else out


def msgpack_restore(data: bytes) -> Any:
    """Decode a flax msgpack payload into dicts of numpy leaves, as
    ``flax.serialization.msgpack_restore`` does (lists stay maps)."""
    return unpackb(data)


def load_params(path: str) -> Tuple[Any, Any]:
    """(params, model_state) of a checkpoint written by the JAX package's
    ``save_params`` / ``save_checkpoint``: nested dicts and lists of numpy
    arrays, the layout of the JAX pytrees."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return _restore_lists(payload["params"]), _restore_lists(payload["model_state"])
