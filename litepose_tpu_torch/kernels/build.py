"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with ctypes.

Counterpart of ``litepose_tpu/ops/runtime.py`` (which picks the Pallas
execution mode): here the choice is made by the tensor's device in each
wrapper, and this module only turns ``csrc/*.cu`` into one shared library
with a plain C interface.

The library lands in ``kernels/_build/<hash>/`` (listed in ``.gitignore``),
keyed by a hash of the sources and flags, so an edited source never loads a
stale build.  Nothing is built or loaded at import time: ``load()`` runs the
first time a wrapper sees a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("nms_topk.cu", "group_greedy.cu", "group_hungarian.cu", "refine_argmax.cu")
HEADERS = ("group_common.cuh",)
LIB_NAME = "liblitepose_kernels.so"

# sm_90a keeps Hopper-only instructions available to later kernels.
# --fmad=false: the grouping and refine kernels must round every multiply and
# add the way their plain twins do (see csrc/group_common.cuh); never
# --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint
_FLOAT = ctypes.c_float
_INT_P = ctypes.POINTER(ctypes.c_int)
_GROUP_ARGS = (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
               _INT, _INT, _FLOAT, _FLOAT, _INT, _INT, _PTR)
_SIGNATURES = {
    # det, is_bf16, band_keys, val, pos, planes, H, W, M, r, stream
    "lp_nms_topk": (_PTR, _INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR),
    # H, W, M, r -> the band count, or -1 / -2 for a shape it does not take
    "lp_nms_topk_bands": (_INT, _INT, _INT, _INT),
    # r, widest plane, merge keys, largest M (outputs)
    "lp_nms_topk_limits": (_INT, _INT_P, _INT_P, _INT_P),
    # tag, val, order, cid, ncl, B, K, M, T, n_steps, P, PC, det_thr,
    # tag_thr, use_val, ignore_too_much, stream
    "lp_group_greedy": _GROUP_ARGS,
    "lp_group_hungarian": _GROUP_ARGS,
    # lo, hi, bad, stream: the card check of the grouping kernels' sqrt_fast
    "lp_group_sqrt_mismatches": (_UINT, _UINT, _PTR, _PTR),
    # need, prev, det, tag, best, pos, B, K, P, T, HW, vec, stream
    "lp_refine_argmax": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                         _INT, _INT, _INT, _PTR),
}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the default toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash(extra_flags: tuple = ()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(extra_flags: tuple = ()) -> tuple[Path, float, str]:
    """Compile the sources unless this exact build exists.  ``extra_flags``
    (e.g. ``-DLP_GROUP_CLOCK`` for ``tools/group_clock.py``) go to every
    nvcc and into the build's hash.

    Returns (library path, seconds spent compiling, compiler log); seconds
    is 0.0 when an existing build was reused."""
    out_dir = BUILD_ROOT / source_hash(extra_flags)
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.is_file():
        return lib, 0.0, log_path.read_text() if log_path.is_file() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    compiles = []
    for name in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(out_dir / (name + ".o")),
               str(CSRC / name)]
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = False
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    # link under a private name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp,
           *(str(out_dir / (name + ".o")) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library, with typed entry points."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
