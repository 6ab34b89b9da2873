"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with ctypes.

Counterpart of ``litepose_tpu/ops/runtime.py`` (which picks the Pallas
execution mode): here the choice is made by the tensor's device in each
wrapper, and this module only turns ``csrc/*.cu`` into one shared library
with a plain C interface.  It also builds the host library (the JPEG
decoder ``csrc/jpeg_decode.cpp``, the polygon fill ``csrc/poly_fill.cpp``
and the host decoder ``csrc/fast_group.cpp``) with the host C++ compiler:
``load_host()``.

The libraries land in ``kernels/_build/<hash>/`` (listed in ``.gitignore``),
keyed by a hash of the sources and flags, so an edited source never loads a
stale build.  Nothing is built or loaded at import time: ``load()`` runs the
first time a wrapper sees a CUDA tensor, ``load_host()`` the first time an
image is decoded, a polygon filled or maps decoded on the host.
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
SOURCES = ("nms_topk.cu", "nms_topk_loop.cu", "group_greedy.cu", "group_hungarian.cu",
           "refine_argmax.cu", "heatmap_nms.cu", "depthwise_conv.cu", "conv_epilogue.cu",
           "dense_conv3x3.cu", "squeeze_excite.cu")
HEADERS = ("group_common.cuh", "nms_common.cuh", "conv_common.cuh")
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
    # det, is_bf16, val, pos, planes, H, W, M, r, stream (K1')
    "lp_nms_topk_loop": (_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR),
    # H, W, r, is_bf16, shared memory bytes, a CTA's budget (outputs) -> the
    # instance (1 staged, 2 lean) or -1 beyond both
    "lp_nms_topk_loop_plan": (_INT, _INT, _INT, _INT, _INT_P, _INT_P),
    # tag, val, order, cid, ncl, B, K, M, T, n_steps, P, PC, det_thr,
    # tag_thr, use_val, ignore_too_much, stream
    "lp_group_greedy": _GROUP_ARGS,
    "lp_group_hungarian": _GROUP_ARGS,
    # lo, hi, bad, stream: the card check of the grouping kernels' sqrt_fast
    "lp_group_sqrt_mismatches": (_UINT, _UINT, _PTR, _PTR),
    # need, prev, det, tag, best, pos, B, K, P, T, HW, vec, stream
    "lp_refine_argmax": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                         _INT, _INT, _INT, _PTR),
    # det, is_bf16, out, planes, H, W, r, stream (K5)
    "lp_heatmap_nms": (_PTR, _INT, _PTR, _INT, _INT, _INT, _INT, _PTR),
    # det, is_bf16, planes, H, W, r, info[9] (output): K5's instance and geometry
    "lp_heatmap_nms_plan": (_PTR, _INT, _INT, _INT, _INT, _INT, _INT_P),
    # x, w, bias, out, B, C, H, W, k, stride, pad, act, stream
    "lp_depthwise_conv": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                          _INT, _PTR),
    # y, bias, bias_bf16, residual (or null), out, B, C, H, W, k, nhwc, act, stream (K7)
    "lp_conv_epilogue": (_PTR, _PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                         _PTR),
    # x, w, bias, residual (or null), out, B, H, W, Cin, Cout, act, stream (K8)
    "lp_conv3x3_bn_act": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT,
                          _PTR),
    # y, w1, b1, w2, b2, means, gate, arrived, out, B, C, H, W, R, stream (SE)
    "lp_squeeze_excite": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                          _INT, _INT, _PTR),
}


# the host library, the JPEG decoder and the polygon fill (integer
# arithmetic only, clipping aside) and the host decoder; never -ffast-math,
# and no -march=native, which lets the compiler contract a*b + c into an FMA
HOST_SOURCES = ("jpeg_decode.cpp", "poly_fill.cpp", "fast_group.cpp")
HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
HOST_LIB_NAME = "liblitepose_host.so"
_HOST_SIGNATURES = {
    # data, n, out, height, width
    "lp_jpeg_decode": (_PTR, ctypes.c_long, _PTR, _INT, _INT),
    # mask, h, w, pts, npts, ncontours, color
    "lp_fill_poly": (_PTR, _INT, _INT, _PTR, _PTR, _INT, _INT),
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


def source_hash(flags: tuple = NVCC_FLAGS, sources: tuple = SOURCES + HEADERS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the sources unless this exact build exists.

    Returns (library path, seconds spent compiling, compiler log); seconds
    is 0.0 when an existing build was reused."""
    out_dir = BUILD_ROOT / source_hash()
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
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out_dir / (name + ".o")), str(CSRC / name)]
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


def build_host() -> Path:
    """Compile the host library with the C++ compiler (``$CXX``, else
    ``c++``) unless this exact build exists; raises if the compiler fails."""
    out_dir = BUILD_ROOT / source_hash(HOST_FLAGS, HOST_SOURCES)
    lib = out_dir / HOST_LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++ or $CXX): the host library "
                           "cannot be built")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [cxx, *HOST_FLAGS, "-o", tmp, *(str(CSRC / name) for name in HOST_SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_host() -> ctypes.CDLL:
    """Build if needed and load the host library, with typed entry points."""
    lib = ctypes.CDLL(str(build_host()))
    for name, argtypes in _HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
