"""Checkpoints in the JAX package's flax msgpack format, read and written
without flax or msgpack (counterpart of ``litepose_tpu/train/checkpoint.py``),
so that each package resumes the other's.

A checkpoint is ``flax.serialization.msgpack_serialize`` of
``{"params", "model_state"}`` (``save_params``) or of the training payload
``{"params", "model_state", "opt_state", "step", "epoch", "best_perf"}``
(``save_checkpoint``).  The reader covers what flax writes:

* msgpack maps, arrays, str, bin, nil, bool, int and float;
* ext type 1 (ndarray): ``packb((shape, dtype_name, raw_bytes))``, C order
  (bfloat16 widened exactly to fp32, numpy having no bfloat16);
* lists, which flax stores as maps keyed ``"0"``, ``"1"``, ...;
  ``load_params`` turns those back into lists.

Flax's other ext types (numpy scalars, complex) and its chunked form of
arrays above 1 GiB do not occur in LitePose checkpoints and are refused.
The writer emits the same subset, with map keys sorted as flax's
``msgpack_serialize`` leaves them, so its bytes equal flax's for the same
tree.

Parameters and BN statistics take the JAX pytree layout
(``models.convert``) of the model, a ``LitePose`` or the NAS supernet
``SuperLitePose`` (whose layout adds each block's ``lin5`` / ``lin3``);
the optimizer state takes optax's layout, each
moment in its parameter's pytree layout:

* adam: ``{"0": {"count", "mu", "nu"}, "1": {"count"}}``
  (``scale_by_adam``, then the schedule's count);
* sgd: ``{"0": {}, "1": {"0": {"trace"}, "1": {"count"}}}``
  (``add_decayed_weights``, then ``trace`` and the schedule's count).
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.convert import (entries, family_entries, family_state_dict_from_jax,
                              named_from_tree, super_entries, super_state_dict_from_jax,
                              state_dict_from_jax, tree_from_named)
from .optim import set_schedule_step

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
    """(params, model_state) of a checkpoint written by either package's
    ``save_params`` / ``save_checkpoint``: nested dicts and lists of numpy
    arrays, the layout of the JAX pytrees."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return _restore_lists(payload["params"]), _restore_lists(payload["model_state"])


# -- writer -------------------------------------------------------------------


def _head(out: list, n: int, fix: int, fix_max: int, *wide) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``wide`` = ((type byte, struct format, max), ...) that holds n."""
    if n <= fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for t, fmt, top in wide:
        if n <= top:
            out.append(struct.pack(">B", t) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xD0, ">b", -0x80, -1), (0xCD, ">H", 0, 0xFFFF),
             (0xD1, ">h", -0x8000, -1), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xD2, ">i", -0x80000000, -1), (0xCF, ">Q", 0, 2**64 - 1),
             (0xD3, ">q", -2**63, -1))
    for t, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(struct.pack(">B", t) + struct.pack(fmt, v))
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
              (0xDB, ">I", 0xFFFFFFFF))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), 0xC4, -1, (0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
              (0xC6, ">I", 0xFFFFFFFF))
        out.append(bytes(obj))
    elif isinstance(obj, np.ndarray):  # flax gives numpy scalars another ext type
        _pack_ext(obj, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
        for k in sorted(obj):
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):  # flax's to_state_dict form of a list
        _pack({str(i): v for i, v in enumerate(obj)}, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_ext(arr: np.ndarray, out: list) -> None:
    """Ext type 1: ``packb((shape, dtype_name, raw_bytes))``, C order."""
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise TypeError(f"cannot pack an ndarray of dtype {arr.dtype}")
    if arr.nbytes >= 2**30:
        raise ValueError("arrays of 1 GiB and more (flax chunks them) are not written")
    inner: list = [b"\x93"]  # the 3-tuple
    _head(inner, arr.ndim, 0x90, 15, (0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
    for d in arr.shape:
        _pack_int(inner, int(d))
    _pack(arr.dtype.name, inner)
    _pack(arr.tobytes("C"), inner)
    data = b"".join(inner)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(struct.pack(">B", fixext[len(data)]))
    else:
        _head(out, len(data), 0xC7, -1, (0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
              (0xC9, ">I", 0xFFFFFFFF))
    out.append(struct.pack(">b", EXT_NDARRAY) + data)


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(to_state_dict(tree))``
    gives for a tree of None, bool, int, float, str, bytes, numpy arrays
    (ext type 1), dicts with str keys (sorted), and lists or tuples (maps
    keyed "0", "1", ..., flax's form)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# -- training state -----------------------------------------------------------


class TrainState(NamedTuple):
    """What a training run carries between steps: the model (parameters and
    BN statistics), the optimizer and its LR schedule (updated in place by
    each step), and the counters of the JAX ``TrainState``."""

    model: Any  # models.litepose.LitePose
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    epoch: int = 0
    best_perf: float = -1.0


def init_train_state(model, optimizer, scheduler, step: int = 0, epoch: int = 0,
                     best_perf: float = -1.0) -> TrainState:
    return TrainState(model, optimizer, scheduler, int(step), int(epoch), float(best_perf))


def _is_supernet(model) -> bool:
    return hasattr(model, "dims")


def _tables(model):
    if _is_supernet(model):
        return super_entries(model.spec, model.dims)
    if not hasattr(model, "arch"):  # a baseline family (HigherHRNet, ...)
        return family_entries(model)
    return entries(model.spec, model.arch, model.with_skips)


def _named_params(ts: TrainState):
    """(name, parameter) of the model, with each parameter's optimizer state."""
    names = {id(p): n for n, p in ts.model.named_parameters()}
    for group in ts.optimizer.param_groups:
        for p in group["params"]:
            yield names[id(p)], p, ts.optimizer.state.get(p, {})


def _count(x) -> np.ndarray:
    return np.asarray(int(x), np.int32)


def opt_state_tree(ts: TrainState) -> dict:
    """The optimizer's state in optax's layout (see the module docstring)."""
    table = _tables(ts.model)
    sched_count = _count(ts.scheduler.last_epoch)
    named = list(_named_params(ts))

    def moment(key):
        return tree_from_named({n: st[key] if key in st else torch.zeros_like(p)
                                for n, p, st in named}, table)

    if isinstance(ts.optimizer, torch.optim.Adam):
        steps = [st["step"] for _, _, st in named if "step" in st]
        return {"0": {"count": _count(steps[0] if steps else 0),
                      "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")},
                "1": {"count": sched_count}}
    if isinstance(ts.optimizer, torch.optim.SGD):
        return {"0": {}, "1": {"0": {"trace": moment("momentum_buffer")},
                               "1": {"count": sched_count}}}
    raise TypeError(f"no optax layout for {type(ts.optimizer).__name__}")


def load_opt_state_tree(ts: TrainState, opt: dict) -> None:
    """Set the optimizer and its schedule from an optax-layout state."""
    table = _tables(ts.model)
    if isinstance(ts.optimizer, torch.optim.Adam):
        count, sched_count = int(opt["0"]["count"]), int(opt["1"]["count"])
        mu = named_from_tree(_restore_lists(opt["0"]["mu"]), table)
        nu = named_from_tree(_restore_lists(opt["0"]["nu"]), table)

        def state(n):
            return {"step": torch.tensor(float(count)), "exp_avg": torch.from_numpy(mu[n].copy()),
                    "exp_avg_sq": torch.from_numpy(nu[n].copy())}
    elif isinstance(ts.optimizer, torch.optim.SGD):
        count = sched_count = int(opt["1"]["1"]["count"])
        trace = named_from_tree(_restore_lists(opt["1"]["0"]["trace"]), table)

        def state(n):
            return {"momentum_buffer": torch.from_numpy(trace[n].copy())}
    else:
        raise TypeError(f"no optax layout for {type(ts.optimizer).__name__}")
    sd = ts.optimizer.state_dict()
    sd["state"] = {i: state(n) for i, (n, _, _) in enumerate(_named_params(ts))} if count else {}
    ts.optimizer.load_state_dict(sd)
    set_schedule_step(ts.scheduler, sched_count)


def _model_trees(model):
    table, sd = _tables(model), model.state_dict()
    return tree_from_named(sd, table, "params"), tree_from_named(sd, table, "state")


def _load_model_trees(model, params, state) -> None:
    """Load pytrees into the model; a supernet checkpoint without ``lin5`` /
    ``lin3`` (a JAX supernet after a backbone pretrain) keeps the model's."""
    if _is_supernet(model):
        sd = super_state_dict_from_jax(params, state, model.spec, model.dims,
                                       keep=model.state_dict())
    elif not hasattr(model, "arch"):
        sd = family_state_dict_from_jax(model, params, state)
    else:
        sd = state_dict_from_jax(params, state, model.spec, model.arch, model.with_skips)
    model.load_state_dict(sd, strict=True)
    if not model.training and hasattr(model, "fold_bn_"):
        model.fold_bn_()


def _write(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)


def save_checkpoint(directory: str, ts: TrainState, is_best: bool = False,
                    filename: str = "checkpoint.msgpack") -> str:
    """Write the training payload of the JAX ``save_checkpoint``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    params, state = _model_trees(ts.model)
    _write(path, {"params": params, "model_state": state, "opt_state": opt_state_tree(ts),
                  "step": int(ts.step), "epoch": int(ts.epoch),
                  "best_perf": float(ts.best_perf)})
    if is_best:
        shutil.copyfile(path, os.path.join(directory, "model_best.msgpack"))
    return path


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint of either package into ``template``'s model,
    optimizer and schedule (in place) and return the resumed state."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    _load_model_trees(template.model, _restore_lists(payload["params"]),
                      _restore_lists(payload["model_state"]))
    load_opt_state_tree(template, payload["opt_state"])
    for m in template.model.modules():  # JAX keeps no count: one update per step
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.num_batches_tracked.fill_(int(payload["step"]))
    return template._replace(step=int(payload["step"]), epoch=int(payload["epoch"]),
                             best_perf=float(payload["best_perf"]))


def auto_resume(directory: str, template: TrainState) -> TrainState:
    """Resume from ``directory/checkpoint.msgpack`` if present."""
    path = os.path.join(directory, "checkpoint.msgpack")
    if os.path.isfile(path):
        return load_checkpoint(path, template)
    return template


def save_params(path: str, model) -> None:
    """Weights-only export of a ``LitePose``, ``SuperLitePose`` or baseline
    family model, which both packages' ``load_params`` read."""
    params, state = _model_trees(model)
    _write(path, {"params": params, "model_state": state})


def load_model_params(path: str, model) -> None:
    """Load a weights file of either package (``save_params``,
    ``save_checkpoint``) into ``model``, a ``LitePose`` or ``SuperLitePose``
    of its layout."""
    _load_model_trees(model, *load_params(path))


def load_pretrained_backbone(model, torch_sd) -> None:
    """Load the stem (``first``) and the backbone (``stage``) of ``model`` from
    a full reference LitePose state dict, keeping its own head (the JAX
    ``load_pretrained_backbone``, the reference pretrain rule); a state dict
    without head keys is refused.  On a supernet the blocks' ``lin5`` /
    ``lin3`` keep their init: the JAX rule replaces its blocks whole with the
    LitePose ones, which have none (ROADMAP Queue 3)."""
    from ..models.torch_convert import state_dict_from_torch, strip_prefixes

    sd = strip_prefixes(torch_sd)
    if not any("deconv" in k or "final" in k for k in sd):
        raise ValueError("checkpoint has no head keys; expected a full LitePose state_dict")
    arch = model.dims.max_arch() if _is_supernet(model) else model.arch
    full = state_dict_from_torch(sd, model.spec, arch)
    own = model.state_dict()
    new = {k: full[k] if k.split(".")[0] in ("first", "stage") and k in full else v
           for k, v in own.items()}
    model.load_state_dict(new, strict=True)
    if not model.training and hasattr(model, "fold_bn_"):
        model.fold_bn_()
