"""The port's kernels as registered torch ops, ``torch.ops.litepose.*``:
the decode kernels and the forward's depthwise conv, dense 3x3 conv, conv
epilogue and squeeze-excitation.

A ctypes call is opaque to ``torch.export``; a registered op lands in an
exported program as one graph node, which a loaded artifact dispatches by
its inputs' device.  The ops are defined on a ``torch.library.Library``
with their schemas written out and registered per dispatch key: no Python
layer sits between the dispatcher and a launch (``torch.library.custom_op``
would add its autograd wrapper, in Python, to every call).  Every
wrapper calls its op through ``call``: a plain card tensor outside any
tracing (``eager``) goes straight to the CUDA implementation, for the
dispatcher's boxed call into a Python implementation costs the host about
9 us, more than some launches (the forward makes one after every conv);
anything else (a CPU tensor, ``torch.export``'s fake tensors, a dispatch
mode, the compiler) goes through ``torch.ops.litepose.<op>``, one graph
node under tracing.  Each op has three implementations:

- CUDA: one launch of the kernel in ``csrc/`` (built by ``kernels/build.py``
  at first use), on the inputs' card (the implementation runs under
  ``torch.cuda.device`` of its first tensor where that is not the current
  device: the ctypes launch and
  ``cudaFuncSetAttribute`` act on the calling thread's current device,
  which a mesh engine's shard thread need not have set), counted on its
  wrapper's ``launches``
  (``ops.topk.nms_topk.launches`` / ``.loop_launches``,
  ``ops.group.group_greedy.launches`` / ``group_hungarian.launches``,
  ``ops.refine.refine_argmax.launches``, ``ops.nms.nms_suppress.launches``,
  ``ops.depthwise.depthwise_conv.launches``,
  ``ops.epilogue.conv_epilogue.launches``,
  ``ops.dense_conv.conv3x3_bn_act.launches``,
  ``ops.squeeze_excite.squeeze_excite.launches``, two a call),
  so an artifact's launches count too (under a lock: shard threads launch
  at once).  The kernels are built and loaded at the first launch, by one
  thread.  A failed build or launch raises;
- CPU: the plain twin (``nms_topk_ref``, ``match_by_tag``,
  ``refine_argmax_ref``, ``nms_suppress_ref``, ``depthwise_conv_ref``,
  ``conv_epilogue_ref``, ``conv3x3_bn_act_ref``, ``squeeze_excite_ref``);
- fake: the output shapes and dtypes, for tracing.

=====================  ===  ==========================  ================================
op                     #    kernel                      TPU kernel
=====================  ===  ==========================  ================================
``nms_topk``           K1   ``csrc/nms_topk.cu``        ``ops/pallas_topk.py:43``
``nms_topk_loop``      K1'  ``csrc/nms_topk_loop.cu``   ``ops/pallas_topk.py:111``
``group_greedy``       K2   ``csrc/group_greedy.cu``    ``ops/pallas_group.py:164``
``group_hungarian``    K3   ``csrc/group_hungarian.cu`` ``ops/pallas_group.py:56``
``refine_argmax``      K4   ``csrc/refine_argmax.cu``   ``ops/pallas_refine.py:38``
``heatmap_nms``        K5   ``csrc/heatmap_nms.cu``     ``ops/pallas_nms.py:27``
``depthwise_conv``     K6   ``csrc/depthwise_conv.cu``  none (``lax.conv_general_dilated``)
``conv_epilogue``      K7   ``csrc/conv_epilogue.cu``   none (XLA's fusion after the conv)
``conv3x3_bn_act``     K8   ``csrc/dense_conv3x3.cu``   none (``lax.conv_general_dilated``)
``squeeze_excite``     SE   ``csrc/squeeze_excite.cu``  none (XLA's mean, dots, multiply)
=====================  ===  ==========================  ================================

The grouping configuration crosses as plain arguments (the joint order as
``int[]``, thresholds as floats that reach the kernel as ``c_float``).
Shape and dtype checks stay in the wrappers (``ops/topk.py``,
``ops/group.py``, ``ops/refine.py``, ``ops/nms.py``,
``ops/depthwise.py``, ``ops/epilogue.py``, ``ops/dense_conv.py``,
``ops/squeeze_excite.py``); what
depends on the card (limits of a kernel's geometry, contiguity,
alignment) is checked here.  This module imports nothing of the package at import time, so a
process that loads an artifact imports it, and through it the twins,
without any model code.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Tuple

import torch
from torch import Tensor

HUGE_I = 2**31 - 1
MAX_TAG_DIM = 8  # kMaxTagDim in csrc/group_common.cuh and csrc/refine_argmax.cu
MAX_PEAKS = 32  # one lane per peak row
MAX_COLUMNS = 32  # one lane per cluster column (the JV solver's M + 1)
MAX_PLANES = 65535  # the kernels' grid.y
MAX_NMS_RADIUS = 7  # kMaxR in csrc/heatmap_nms.cu: windows up to 15

_LIB = torch.library.Library("litepose", "DEF")
_GROUP_ARGS = ("Tensor tag_k, Tensor val_k, int[] joint_order, int max_people, "
               "int max_clusters, float detection_threshold, float tag_threshold, "
               "bool use_detection_val, bool ignore_too_much")
SCHEMAS = {
    "nms_topk": "(Tensor det, int max_people, int nms_kernel) -> (Tensor, Tensor)",
    "nms_topk_loop": "(Tensor det, int max_people, int nms_kernel) -> (Tensor, Tensor)",
    "group_greedy": f"({_GROUP_ARGS}) -> (Tensor, Tensor)",
    "group_hungarian": f"({_GROUP_ARGS}) -> (Tensor, Tensor)",
    "refine_argmax": "(Tensor need, Tensor prev, Tensor det, Tensor tag) -> Tensor",
    "heatmap_nms": "(Tensor det, int nms_kernel) -> Tensor",
    "depthwise_conv": ("(Tensor x, Tensor w, Tensor bias, int stride, str act, int pad=-1) "
                       "-> Tensor"),
    "conv_epilogue": "(Tensor y, Tensor bias, Tensor? residual, str act) -> Tensor",
    "conv3x3_bn_act": ("(Tensor x, Tensor w, Tensor bias, Tensor? residual, str act) "
                       "-> Tensor"),
    "squeeze_excite": "(Tensor y, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
}
OPS = tuple(SCHEMAS)


_OP = {}  # op name -> torch.ops.litepose.<name>.default
_EAGER = {}  # op name -> its CUDA implementation as ``call`` runs it


def _register(name: str, cuda, cpu, fake, eager=None) -> None:
    """Define the op ``name`` with its CUDA, CPU and fake implementations;
    ``eager``, where given, is what ``call`` runs outside the dispatcher in
    place of ``cuda`` (K7's, which may write into its input)."""
    _LIB.define(name + SCHEMAS[name])
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"litepose::{name}", fake, lib=_LIB)
    _OP[name] = getattr(torch.ops.litepose, name).default
    _EAGER[name] = eager or cuda


_dispatch_modes = torch._C._len_torch_dispatch_stack


def eager(t: Tensor) -> bool:
    """Whether ``t`` is a plain card tensor outside any tracing: no compiler
    and no dispatch mode at work, no tensor subclass (a fake tensor of
    ``torch.export``)."""
    return (t.is_cuda and type(t) is Tensor and not _dispatch_modes()
            and not torch.compiler.is_compiling())


def call(name: str, t: Tensor, *args):
    """The op ``name`` on ``(t, *args)``, ``t`` its first tensor, as every
    wrapper calls it: the CUDA implementation itself where ``eager(t)``,
    else ``torch.ops.litepose.<name>`` (the twin on a CPU tensor, one node
    under tracing)."""
    if eager(t):
        return _EAGER[name](t, *args)
    return _OP[name](t, *args)


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load_kernels():
    from ..kernels import build

    return build, build.load()


def _kernels():
    """``(kernels.build, the loaded kernel library)``: imported, built and
    loaded at the first launch, not at every one, and by one thread while
    the others wait (two builds at once would write the same objects)."""
    with _BUILD_LOCK:
        return _load_kernels()


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to a wrapper's launch count.  Under a lock: ``+=`` on an
    attribute is a read, an add and a write, which the shard threads of a
    mesh engine could interleave and so lose a launch."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _on_its_device(impl):
    """``impl`` run under its first tensor's device (see the module doc),
    which is entered only where it is not the current one."""
    @functools.wraps(impl)
    def run(t: Tensor, *args):
        dev = t.get_device()
        if dev == torch.cuda.current_device():
            return impl(t, *args)
        with torch.cuda.device(dev):
            return impl(t, *args)

    return run


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: Tensor) -> int:
    """The current stream's handle on ``t``'s card, made into no Python
    stream object where the build has the raw lookup."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def _contiguous(names: str, *tensors: Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{names} must be contiguous")


# -- K1 and K1': NMS + exact top-M ---------------------------------------------


@_on_its_device
def nms_topk_cuda(det: Tensor, max_people: int, nms_kernel: int) -> Tuple[Tensor, Tensor]:
    """K1: det (B, K, H, W) fp32/bf16 -> (val (B, K, M) f32, pos (B, K, M)
    int32), one band launch and one merge launch."""
    from .topk import nms_topk as wrapper

    _contiguous("det", det)
    B, K, H, W = det.shape
    if B * K > MAX_PLANES:
        raise ValueError(f"the K1 kernel takes at most {MAX_PLANES} planes, got {B * K}")
    build, lib = _kernels()
    r = nms_kernel // 2
    n_bands = lib.lp_nms_topk_bands(H, W, max_people, r)
    if n_bands < 0:
        widest, keys, max_m = (ctypes.c_int() for _ in range(3))
        lib.lp_nms_topk_limits(r, ctypes.byref(widest), ctypes.byref(keys), ctypes.byref(max_m))
        if n_bands == -1:
            raise ValueError(f"plane width {W} exceeds the widest the K1 kernel takes for "
                             f"nms_kernel={nms_kernel}: {widest.value} (a band of one row "
                             f"and its halo in shared memory)")
        raise ValueError(f"{H}x{W} planes with max_people={max_people} exceed the K1 "
                         f"kernel's merge of {keys.value} band keys a plane "
                         f"(max_people <= {max_m.value})")
    val = torch.empty((B, K, max_people), dtype=torch.float32, device=det.device)
    pos = torch.empty((B, K, max_people), dtype=torch.int32, device=det.device)
    if B * K:
        band_keys = torch.empty((B * K, n_bands, max_people), dtype=torch.int64,
                                device=det.device)
        err = lib.lp_nms_topk(
            det.data_ptr(), int(det.dtype == torch.bfloat16), band_keys.data_ptr(),
            val.data_ptr(), pos.data_ptr(), B * K, H, W, max_people, r, _stream(det))
        build.check(err, "nms_topk")
        count_launch(wrapper)
    return val, pos


@_on_its_device
def nms_topk_loop_cuda(det: Tensor, max_people: int, nms_kernel: int) -> Tuple[Tensor, Tensor]:
    """K1': K1's contract by ``max_people`` serial rounds over each plane's
    row keys, in one warp a plane; the kernel picks its instance (staged or
    lean) by shape."""
    from .topk import nms_topk as wrapper

    _contiguous("det", det)
    B, K, H, W = det.shape
    build, lib = _kernels()
    r = nms_kernel // 2
    smem, budget = ctypes.c_int(), ctypes.c_int()
    if lib.lp_nms_topk_loop_plan(H, W, r, int(det.dtype == torch.bfloat16), ctypes.byref(smem),
                                 ctypes.byref(budget)) < 0:
        raise ValueError(f"{H}x{W} planes exceed the shared memory of the K1' kernel's "
                         f"CTA: its lean instance needs {smem.value} bytes (8 a row for the "
                         f"row keys, 4 (W + {2 * r}) for the row buffer) of the "
                         f"{budget.value} a CTA may have")
    val = torch.empty((B, K, max_people), dtype=torch.float32, device=det.device)
    pos = torch.empty((B, K, max_people), dtype=torch.int32, device=det.device)
    if B * K:
        err = lib.lp_nms_topk_loop(det.data_ptr(), int(det.dtype == torch.bfloat16),
                                   val.data_ptr(), pos.data_ptr(), B * K, H, W, max_people, r,
                                   _stream(det))
        build.check(err, "nms_topk (K1')")
        count_launch(wrapper, "loop_launches")
    return val, pos


def _nms_topk_twin(det: Tensor, max_people: int, nms_kernel: int) -> Tuple[Tensor, Tensor]:
    from .topk import nms_topk_ref

    return nms_topk_ref(det, max_people, nms_kernel)


def _nms_topk_fake(det: Tensor, max_people: int, nms_kernel: int) -> Tuple[Tensor, Tensor]:
    B, K = det.shape[:2]
    return (det.new_empty((B, K, max_people), dtype=torch.float32),
            det.new_empty((B, K, max_people), dtype=torch.int32))


_register("nms_topk", nms_topk_cuda, _nms_topk_twin, _nms_topk_fake)
_register("nms_topk_loop", nms_topk_loop_cuda, _nms_topk_twin, _nms_topk_fake)


# -- K2 and K3: AE grouping ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _order_on(order: Tuple[int, ...], device: torch.device) -> Tensor:
    """The joint order as an int32 tensor on ``device``, uploaded once: a
    fresh host copy per call would make the host wait for the card's queue."""
    return torch.tensor(order, dtype=torch.int32).to(device)


def _group_launch(entry: str, wrapper_name: str, tag_k: Tensor, val_k: Tensor,
                  joint_order: List[int], max_people: int, max_clusters: int,
                  detection_threshold: float, tag_threshold: float,
                  use_detection_val: bool, ignore_too_much: bool) -> Tuple[Tensor, Tensor]:
    """One launch of the grouping kernel ``entry``, counted on the wrapper
    ``ops.group.<wrapper_name>``."""
    from . import group

    B, K, M, T = tag_k.shape
    if not 1 <= T <= MAX_TAG_DIM:
        raise ValueError(f"the kernel takes tag dims 1 to {MAX_TAG_DIM}, got {T}")
    if M > MAX_PEAKS or max_people > MAX_COLUMNS:
        raise ValueError(f"the kernel takes at most {MAX_PEAKS} peaks and "
                         f"{MAX_COLUMNS} people, got {M} and {max_people}")
    _contiguous("tag_k and val_k", tag_k, val_k)
    order = tuple(joint_order)
    if any(not 0 <= k < K for k in order):
        raise ValueError(f"joint order {order} out of range for {K} joints")
    build, lib = _kernels()
    dev = tag_k.device
    order_t = _order_on(order, dev)
    cid = torch.empty((B, K, M), dtype=torch.int32, device=dev)
    n_cl = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        err = getattr(lib, entry)(
            tag_k.data_ptr(), val_k.data_ptr(), order_t.data_ptr(),
            cid.data_ptr(), n_cl.data_ptr(), B, K, M, T, len(order),
            max_people, max_clusters, detection_threshold, tag_threshold,
            int(use_detection_val), int(ignore_too_much), _stream(tag_k))
        build.check(err, wrapper_name)
        count_launch(getattr(group, wrapper_name))
    return cid, n_cl


@_on_its_device
def group_greedy_cuda(tag_k: Tensor, val_k: Tensor, joint_order: List[int], max_people: int,
                      max_clusters: int, detection_threshold: float, tag_threshold: float,
                      use_detection_val: bool, ignore_too_much: bool) -> Tuple[Tensor, Tensor]:
    """K2: tag_k (B, K, M, T) f32, val_k (B, K, M) f32 -> (cid (B, K, M)
    int32, n_cl (B,) int32)."""
    return _group_launch("lp_group_greedy", "group_greedy", tag_k, val_k, joint_order,
                         max_people, max_clusters, detection_threshold, tag_threshold,
                         use_detection_val, ignore_too_much)


@_on_its_device
def group_hungarian_cuda(tag_k: Tensor, val_k: Tensor, joint_order: List[int],
                         max_people: int, max_clusters: int, detection_threshold: float,
                         tag_threshold: float, use_detection_val: bool,
                         ignore_too_much: bool) -> Tuple[Tensor, Tensor]:
    """K3: ``group_greedy``'s contract with the exact JV assignment."""
    return _group_launch("lp_group_hungarian", "group_hungarian", tag_k, val_k, joint_order,
                         max_people, max_clusters, detection_threshold, tag_threshold,
                         use_detection_val, ignore_too_much)


def _group_twin(assignment: str):
    def twin(tag_k: Tensor, val_k: Tensor, joint_order: List[int], max_people: int,
             max_clusters: int, detection_threshold: float, tag_threshold: float,
             use_detection_val: bool, ignore_too_much: bool) -> Tuple[Tensor, Tensor]:
        from .group import StaticGroupCfg, match_by_tag

        cfg = StaticGroupCfg(
            joint_order=tuple(joint_order), max_people=max_people, max_clusters=max_clusters,
            detection_threshold=detection_threshold, tag_threshold=tag_threshold,
            use_detection_val=use_detection_val, ignore_too_much=ignore_too_much,
            nms_kernel=5, nms_padding=2, assignment=assignment)
        return match_by_tag(tag_k, val_k, cfg)

    return twin


def _group_fake(tag_k: Tensor, val_k: Tensor, joint_order: List[int], max_people: int,
                max_clusters: int, detection_threshold: float, tag_threshold: float,
                use_detection_val: bool, ignore_too_much: bool) -> Tuple[Tensor, Tensor]:
    B, K, M = tag_k.shape[:3]
    return (tag_k.new_empty((B, K, M), dtype=torch.int32),
            tag_k.new_empty((B,), dtype=torch.int32))


_register("group_greedy", group_greedy_cuda, _group_twin("greedy"), _group_fake)
_register("group_hungarian", group_hungarian_cuda, _group_twin("hungarian"), _group_fake)


# -- K4: the penalized argmax of refine ------------------------------------------


@_on_its_device
def refine_argmax_cuda(need: Tensor, prev: Tensor, det: Tensor, tag: Tensor) -> Tensor:
    """K4: need (B, K, P) int32, prev (B, P, T), det (B, K, H, W), tag
    (B, K, T, H, W) f32 -> pos (B, K, P) int32."""
    from .refine import refine_argmax as wrapper

    B, K, H, W = det.shape
    P, T = prev.shape[1], prev.shape[2]
    if not 1 <= T <= MAX_TAG_DIM:
        raise ValueError(f"the kernel takes tag dims 1 to {MAX_TAG_DIM}, got {T}")
    if H * W >= HUGE_I:
        raise ValueError(f"plane of {H}x{W} pixels overflows int32 indices")
    if B * K > MAX_PLANES:
        raise ValueError(f"the kernel's grid takes at most {MAX_PLANES} planes, got {B * K}")
    _contiguous("need, prev, det and tag", need, prev, det, tag)
    build, lib = _kernels()
    pos = torch.empty((B, K, P), dtype=torch.int32, device=det.device)
    if B * K and P:
        # per (plane, slot) the max of a 64-bit (penalty, -index) key
        best = torch.zeros((B, K, P), dtype=torch.int64, device=det.device)
        vec = (H * W) % 4 == 0 and det.data_ptr() % 16 == 0 and tag.data_ptr() % 16 == 0
        err = lib.lp_refine_argmax(
            need.data_ptr(), prev.data_ptr(), det.data_ptr(), tag.data_ptr(),
            best.data_ptr(), pos.data_ptr(), B, K, P, T, H * W, int(vec), _stream(det))
        build.check(err, "refine_argmax")
        count_launch(wrapper)
    return pos


def _refine_argmax_twin(need: Tensor, prev: Tensor, det: Tensor, tag: Tensor) -> Tensor:
    from .refine import refine_argmax_ref

    return refine_argmax_ref(need, prev, det, tag)


def _refine_argmax_fake(need: Tensor, prev: Tensor, det: Tensor, tag: Tensor) -> Tensor:
    return need.new_empty(need.shape, dtype=torch.int32)


_register("refine_argmax", refine_argmax_cuda, _refine_argmax_twin, _refine_argmax_fake)


# -- K5: the suppressed map ------------------------------------------------------


@_on_its_device
def heatmap_nms_cuda(det: Tensor, nms_kernel: int) -> Tensor:
    """K5: det (N, H, W) fp32/bf16 -> the suppressed map, same shape and
    dtype, in one launch."""
    from .nms import nms_suppress as wrapper

    _contiguous("det", det)
    N, H, W = det.shape
    r = nms_kernel // 2
    if r > MAX_NMS_RADIUS:
        raise ValueError(f"the K5 kernel takes NMS windows up to {2 * MAX_NMS_RADIUS + 1}, "
                         f"got {nms_kernel}")
    build, lib = _kernels()
    out = torch.empty_like(det)
    if det.numel():
        err = lib.lp_heatmap_nms(det.data_ptr(), int(det.dtype == torch.bfloat16),
                                 out.data_ptr(), N, H, W, r, _stream(det))
        build.check(err, "heatmap_nms")
        count_launch(wrapper)
    return out


K5_INSTANCES = {1: "ring", 2: "tiled"}
# info[1:] of csrc/heatmap_nms.cu:lp_heatmap_nms_plan
K5_PLAN_KEYS = ("threads", "smem_bytes", "stage_rows", "stages", "ctas_per_sm", "grid",
                "rows_per_cta", "ring_budget")


def heatmap_nms_plan(det: Tensor, nms_kernel: int, lib=None) -> dict:
    """The launch K5 makes for ``det`` (N, H, W) on its card: the instance
    (``"ring"``, or ``"tiled"`` for a row that is no 16-byte multiple, a
    base off 16 bytes or a row wider than the ring's threads) and its
    geometry (``csrc/heatmap_nms.cu:lp_heatmap_nms_plan``).  ``lib``: a
    kernel library other than the loaded one (a clock build, whose
    registers and so CTAs an SM may differ)."""
    if det.device.type != "cuda" or det.dim() != 3:
        raise ValueError(f"heatmap_nms_plan takes a CUDA (N, H, W) tensor, got "
                         f"{tuple(det.shape)} on {det.device}")
    N, H, W = det.shape
    if lib is None:
        _, lib = _kernels()
    info = (ctypes.c_int * (1 + len(K5_PLAN_KEYS)))()
    with torch.cuda.device(det.device):
        err = lib.lp_heatmap_nms_plan(det.data_ptr(), int(det.dtype == torch.bfloat16), N, H, W,
                                      nms_kernel // 2, info)
    if err:
        raise RuntimeError(f"lp_heatmap_nms_plan: CUDA error {err}")
    return {"instance": K5_INSTANCES[info[0]], **dict(zip(K5_PLAN_KEYS, info[1:]))}


def _heatmap_nms_twin(det: Tensor, nms_kernel: int) -> Tensor:
    from .nms import nms_suppress_ref

    return nms_suppress_ref(det, nms_kernel)


def _heatmap_nms_fake(det: Tensor, nms_kernel: int) -> Tensor:
    return torch.empty_like(det)


_register("heatmap_nms", heatmap_nms_cuda, _heatmap_nms_twin, _heatmap_nms_fake)


# -- K6: the depthwise conv of a folded conv + BN, bias and activation fused ---


# kActNone, kActRelu6, kActRelu, kActSilu in csrc/conv_common.cuh
DEPTHWISE_ACTS = ("none", "relu6", "relu", "silu")


@_on_its_device
def depthwise_conv_cuda(x: Tensor, w: Tensor, bias: Tensor, stride: int, act: str,
                        pad: int = -1) -> Tensor:
    """K6: x (B, C, H, W) bf16, w (C, 1, k, k) bf16, bias (C) fp32 ->
    act(conv + bias) (B, C, Ho, Wo) bf16, in one launch; ``pad`` -1 is k //
    2."""
    from .depthwise import depthwise_conv as wrapper

    _contiguous("x, w and bias", x, w, bias)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"the K6 kernel takes bf16 x and w and an fp32 bias, got {x.dtype}, "
                        f"{w.dtype} and {bias.dtype}")
    B, C, H, W = x.shape
    build, lib = _kernels()
    out = torch.empty((B, C, (H - 1) // stride + 1, (W - 1) // stride + 1), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        k = w.shape[-1]
        err = lib.lp_depthwise_conv(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                    B, C, H, W, k, stride, k // 2 if pad == -1 else pad,
                                    DEPTHWISE_ACTS.index(act), _stream(x))
        build.check(err, "depthwise_conv")
        count_launch(wrapper)
    return out


def _depthwise_conv_twin(x: Tensor, w: Tensor, bias: Tensor, stride: int, act: str,
                         pad: int = -1) -> Tensor:
    from .depthwise import depthwise_conv_ref

    return depthwise_conv_ref(x, w, bias, stride, act, pad)


def _depthwise_conv_fake(x: Tensor, w: Tensor, bias: Tensor, stride: int, act: str,
                         pad: int = -1) -> Tensor:
    B, C, H, W = x.shape
    return x.new_empty((B, C, (H - 1) // stride + 1, (W - 1) // stride + 1))


_register("depthwise_conv", depthwise_conv_cuda, _depthwise_conv_twin, _depthwise_conv_fake)


# -- K7: the epilogue of a folded dense conv: bias, residual, activation ---------


@functools.lru_cache(maxsize=None)
def _epilogue():
    """``ops.epilogue`` (the contract, the wrapper and its counter), imported
    once: an import statement a call would cost the host after every conv."""
    from . import epilogue

    return epilogue


def _conv_epilogue(y: Tensor, bias: Tensor, residual, act: str, into_y: bool) -> Tensor:
    """K7: y (B, C, H, W) bf16, NCHW or channels-last, bias (C) fp32 or
    bf16, residual None or bf16 in y's layout, of y's shape or 2, 4 or 8
    times its plane -> act(upsample(y + bias) + residual) bf16 in y's
    layout, in one launch; written into y itself where ``into_y`` and the
    output has y's shape, else into a new tensor."""
    ep = _epilogue()
    fmt, k = ep.contract(y, bias, residual, act)
    if y.numel() << (2 * k) >= 2**31:
        raise ValueError(f"the K7 kernel takes fewer than 2^31 elements a tensor, got "
                         f"{tuple(y.shape)} upsampled {2**k} times")
    if into_y and not k:
        out = y
    else:
        out = torch.empty(y.shape if residual is None else residual.shape, dtype=y.dtype,
                          device=y.device, memory_format=fmt)
    if out.numel():
        build, lib = _kernels()
        B, C, H, W = y.shape
        err = lib.lp_conv_epilogue(y.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.bfloat16),
                                   None if residual is None else residual.data_ptr(),
                                   out.data_ptr(), B, C, H, W, k,
                                   int(fmt is torch.channels_last), ep.ACTS.index(act),
                                   _stream(y))
        build.check(err, "conv_epilogue")
        count_launch(ep.conv_epilogue)
    return out


@_on_its_device
def conv_epilogue_cuda(y: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    """K7 through the dispatcher: its output in a new tensor (the op's
    schema writes none of its inputs)."""
    return _conv_epilogue(y, bias, residual, act, False)


@_on_its_device
def conv_epilogue_into_y(y: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    """K7 as ``call`` runs it on an eager card tensor: an output of y's
    shape written into y itself (the wrapper's caller gives y up), which
    spares an allocation a call."""
    return _conv_epilogue(y, bias, residual, act, True)


def _conv_epilogue_twin(y: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    from .epilogue import contract, conv_epilogue_ref

    contract(y, bias, residual, act)
    return conv_epilogue_ref(y, bias, residual, act)


def _conv_epilogue_fake(y: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    from .epilogue import contract

    fmt, _ = contract(y, bias, residual, act)
    shape = y.shape if residual is None else residual.shape
    return torch.empty(shape, dtype=y.dtype, device=y.device, memory_format=fmt)


_register("conv_epilogue", conv_epilogue_cuda, _conv_epilogue_twin, _conv_epilogue_fake,
          eager=conv_epilogue_into_y)


# -- K8: a dense 3x3 stride-1 conv with K7's epilogue in its store ---------------


@functools.lru_cache(maxsize=None)
def _dense_conv():
    """``ops.dense_conv`` (the contract, the wrapper and its counter),
    imported once."""
    from . import dense_conv

    return dense_conv


@_on_its_device
def conv3x3_bn_act_cuda(x: Tensor, w: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    """K8: x (B, Cin, H, W) and w (Cout, Cin, 3, 3) bf16 channels-last, bias
    (Cout) fp32, residual None or (B, Cout, H, W) bf16
    channels-last -> act(conv(x, w) + bias + residual) (B, Cout, H, W) bf16
    channels-last, in one launch."""
    dc = _dense_conv()
    shape = dc.contract(x, w, bias, residual, act)
    if any(t is not None and t.data_ptr() % 16 for t in (x, w, residual)):
        raise ValueError("the K8 kernel takes x, w and residual at 16-byte aligned addresses")
    out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if out.numel():
        build, lib = _kernels()
        B, cin, H, W = x.shape
        err = lib.lp_conv3x3_bn_act(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                    None if residual is None else residual.data_ptr(),
                                    out.data_ptr(), B, H, W, cin, shape[1],
                                    dc.ACTS.index(act), _stream(x))
        build.check(err, "conv3x3_bn_act")
        count_launch(dc.conv3x3_bn_act)
    return out


def _conv3x3_bn_act_twin(x: Tensor, w: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    from .dense_conv import contract, conv3x3_bn_act_ref

    contract(x, w, bias, residual, act)
    return conv3x3_bn_act_ref(x, w, bias, residual, act)


def _conv3x3_bn_act_fake(x: Tensor, w: Tensor, bias: Tensor, residual, act: str) -> Tensor:
    from .dense_conv import contract

    return torch.empty(contract(x, w, bias, residual, act), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


_register("conv3x3_bn_act", conv3x3_bn_act_cuda, _conv3x3_bn_act_twin, _conv3x3_bn_act_fake)


# -- the squeeze-excitation of an MBConv block: mean, gate, scale --------------


@functools.lru_cache(maxsize=None)
def _squeeze_excite():
    """``ops.squeeze_excite`` (the contract, the wrapper and its counter),
    imported once."""
    from . import squeeze_excite

    return squeeze_excite


_SE_ARRIVED = {}  # (device, stream) -> the gate kernel's per-image counters, left at 0


def _se_counters(y: Tensor) -> Tensor:
    """At least B zero counters for launches on ``y``'s current stream: a
    launch leaves them at 0, and launches on one stream run in turn."""
    key = (y.get_device(), _stream(y))
    arrived = _SE_ARRIVED.get(key)
    if arrived is None or arrived.numel() < y.shape[0]:
        arrived = torch.zeros(max(y.shape[0], 64), dtype=torch.int32, device=y.device)
        _SE_ARRIVED[key] = arrived
    return arrived


def _squeeze_excite_cuda(y: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                         into_y: bool) -> Tensor:
    """y (B, C, H, W) bf16 NCHW, w1 (R, C), b1 (R), w2 (C, R), b2 (C) bf16 ->
    y scaled by its gate, bf16, in two launches (the gate, the scale);
    written into y itself where ``into_y``, else into a new tensor."""
    se = _squeeze_excite()
    se.contract(y, w1, b1, w2, b2)
    _contiguous("y, w1, b1, w2 and b2", y, w1, b1, w2, b2)
    if y.dtype != torch.bfloat16:
        raise TypeError(f"the squeeze-excitation kernels take bf16, got {y.dtype}")
    B, C, H, W = y.shape
    if y.numel() >= 2**31 or B > 65535 or C + w1.shape[0] > 12288:
        raise ValueError(f"the squeeze-excitation kernels take fewer than 2^31 elements, at "
                         f"most 65535 images and C + R at most 12288, got {tuple(y.shape)} "
                         f"and R {w1.shape[0]}")
    out = y if into_y else torch.empty_like(y)
    if y.numel():
        build, lib = _kernels()
        scratch = torch.empty(2 * B * C, dtype=torch.float32, device=y.device)
        err = lib.lp_squeeze_excite(y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                    b2.data_ptr(), scratch.data_ptr(),
                                    scratch.data_ptr() + 4 * B * C, _se_counters(y).data_ptr(),
                                    out.data_ptr(), B, C, H, W, w1.shape[0], _stream(y))
        build.check(err, "squeeze_excite")
        count_launch(se.squeeze_excite)
        count_launch(se.squeeze_excite)
    return out


@_on_its_device
def squeeze_excite_cuda(y: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """The squeeze-excitation through the dispatcher: a new tensor out."""
    return _squeeze_excite_cuda(y, w1, b1, w2, b2, False)


@_on_its_device
def squeeze_excite_into_y(y: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """The squeeze-excitation as ``call`` runs it on an eager card tensor:
    written into y itself (the wrapper's caller gives y up)."""
    return _squeeze_excite_cuda(y, w1, b1, w2, b2, True)


def _squeeze_excite_twin(y: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    from .squeeze_excite import contract, squeeze_excite_ref

    contract(y, w1, b1, w2, b2)
    return squeeze_excite_ref(y, w1, b1, w2, b2)


def _squeeze_excite_fake(y: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    from .squeeze_excite import contract

    contract(y, w1, b1, w2, b2)
    return torch.empty_like(y)


_register("squeeze_excite", squeeze_excite_cuda, _squeeze_excite_twin, _squeeze_excite_fake,
          eager=squeeze_excite_into_y)
