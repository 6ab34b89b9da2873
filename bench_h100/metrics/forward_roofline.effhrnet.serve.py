"""The EfficientHRNet forward's least time, worked out from the
configuration alone (``harness/effhrnet_macs.py``: for each conv the larger
of its operations over 989 TFLOP/s and its bf16 bytes over 3.35 TB/s, and
the squeeze-excitations' gating bytes over 3.35 TB/s), over
``forward_ms.serve`` of the same window, in %; moves ``img_per_s``."""

from harness import devices, effhrnet_macs
from harness.layers import forward_ms


def read(record):
    cfg = record["config"]
    ms = forward_ms(record)
    if ms is None:
        return None
    dtype = cfg["compute_dtype"]
    least = effhrnet_macs.least_seconds(cfg, devices.ITEMSIZE[dtype], devices.PEAK_FLOPS[dtype],
                                        devices.PEAK_BYTES_PER_S)
    return 100.0 * least * record["images"] / record["calls"] / (ms / 1e3)
