"""The squeeze-excitations' least time a call, one read and one write of
each gated tensor of every image and each gate's weights read once, in
bf16 over 3.35 TB/s (``harness/effhrnet_macs.py:se_bytes``), over the
device time of what runs inside the ``litepose.effhrnet.se`` spans
(``se_ms.effhrnet.serve``), in %: the same work whatever implements the
squeeze-excitation; moves ``img_per_s``.  None where the program opens no
such span."""

from harness import devices, effhrnet_macs
from harness.program import per_call


def read(record):
    cfg = record["config"]
    ms = per_call(record, "litepose.effhrnet.se", "device_s")
    if ms is None or ms <= 0:
        return None
    images = round(record["images"] / record["calls"])
    least = effhrnet_macs.se_bytes(cfg, images, devices.ITEMSIZE[cfg["compute_dtype"]])
    return 100.0 * least / devices.PEAK_BYTES_PER_S / (ms / 1e3)
