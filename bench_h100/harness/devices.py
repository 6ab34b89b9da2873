"""The card's published peaks and the kernel families of a CUPTI trace.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
fp32 outside them, 3.35 TB/s of HBM3.

``KERNEL_FAMILIES`` is a frozen copy of the table of
``litepose_tpu_torch/tools/timing.py`` with an ``nccl`` family in front:
the port's kernels (K1-K5, K1') are families of their own, each held to
the launch count its wrapper keeps (``PORT_COUNTERS``).
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}

KERNEL_FAMILIES = (
    ("nccl", ("nccl",)),
    ("K1 nms_topk", ("nms_topk_band_kernel", "nms_topk_merge_kernel")),
    ("K1' nms_topk_loop", ("nms_topk_loop_kernel",)),
    ("K2 group_greedy", ("group_greedy_kernel",)),
    ("K3 group_hungarian", ("group_hungarian_kernel",)),
    ("K4 refine_argmax", ("refine_argmax_tile_kernel", "refine_finalize_kernel")),
    ("K5 heatmap_nms", ("heatmap_nms_ring_kernel", "heatmap_nms_kernel")),
    ("depthwise conv", ("depthwise",)),
    ("cuDNN / GEMM", ("cudnn", "xmma", "gemm", "cutlass", "implicit_convolve", "winograd",
                      "fft", "sm90_", "sm80_", "nvjet")),
    ("resize (bilinear)", ("upsample",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("reductions (BN statistics, losses)", ("reduce", "norm", "welford")),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
    ("memcpy / memset", ("memcpy", "memset")),
)
OTHER = "other"
PORT_FAMILIES = ("K1 nms_topk", "K1' nms_topk_loop", "K2 group_greedy", "K3 group_hungarian",
                 "K4 refine_argmax", "K5 heatmap_nms")
# family -> (module of the port, wrapper, counter attribute)
PORT_COUNTERS = {
    "K1 nms_topk": ("litepose_tpu_torch.ops.topk", "nms_topk", "launches"),
    "K1' nms_topk_loop": ("litepose_tpu_torch.ops.topk", "nms_topk", "loop_launches"),
    "K2 group_greedy": ("litepose_tpu_torch.ops.group", "group_greedy", "launches"),
    "K3 group_hungarian": ("litepose_tpu_torch.ops.group", "group_hungarian", "launches"),
    "K4 refine_argmax": ("litepose_tpu_torch.ops.refine", "refine_argmax", "launches"),
    "K5 heatmap_nms": ("litepose_tpu_torch.ops.nms", "nms_suppress", "launches"),
}


def family_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)), OTHER)


def is_copy(kernel_name: str) -> bool:
    return kernel_name.lower().startswith(("memcpy", "memset"))
