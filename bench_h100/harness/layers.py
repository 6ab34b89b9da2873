"""What the per-layer readers (``metrics/<name>.py``) take from a traced
window's record: device ms a call by the port's kernel families, by the
host-device copies and by every other kernel; the idle share; the shares
of the peak and of the roofline that the configuration's convolutions
(``harness/macs.py``) give.  Each returns None where the window has
nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from . import devices, macs


def host_device_copy(name: str, family: str = "") -> bool:
    low = name.lower()
    return low.startswith("memcpy") and ("htod" in low or "dtoh" in low)


def port_kernel(name: str, family: str) -> bool:
    return family in devices.PORT_FAMILIES


def other_kernel(name: str, family: str) -> bool:
    return family not in devices.PORT_FAMILIES and not devices.is_copy(name)


def nccl_kernel(name: str, family: str) -> bool:
    return family == "nccl"


def per_call_ms(record: Dict, keep) -> Optional[float]:
    """Device ms a call (a step) of the operations ``keep(name, family)``
    selects."""
    total = sum(op["seconds"] for name, op in record["ops"].items() if keep(name, op["family"]))
    if not record.get("calls") or total <= 0:
        return None
    return total * 1e3 / record["calls"]


def copy_ms(record: Dict) -> Optional[float]:
    return per_call_ms(record, host_device_copy)


def forward_ms(record: Dict) -> Optional[float]:
    return per_call_ms(record, other_kernel)


def decode_ms(record: Dict) -> Optional[float]:
    return per_call_ms(record, port_kernel)


def comm_ms(record: Dict) -> Optional[float]:
    return per_call_ms(record, nccl_kernel)


def idle_share(record: Dict) -> Optional[float]:
    """% of the window with no kernel or copy running on the card."""
    if record["window_s"] <= 0 or record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def _conv_flops(cfg: Dict) -> int:
    return 2 * macs.macs(cfg["arch"], num_joints=cfg["num_joints"], with_ae=cfg["with_ae"])


def mfu(record: Dict, passes: int = 1) -> Optional[float]:
    """% of the cards' peak in the compute dtype: ``passes`` x the conv
    FLOPs of an image (1 serving, 3 a training step: forward and a
    backward of twice its work) for every image of the window, over the
    window's seconds."""
    cfg = record["config"]
    if record["window_s"] <= 0 or not record.get("images") or not record["ops"]:
        return None
    rate = passes * _conv_flops(cfg) * record["images"] / record["window_s"]
    return 100.0 * rate / (record["chips"] * devices.PEAK_FLOPS[cfg["compute_dtype"]])


def forward_roofline(record: Dict) -> Optional[float]:
    """% of ``forward_ms`` that the forward's least time takes: for each
    conv the larger of its operations over the peak rate and its bytes over
    the bandwidth, for the images of a call."""
    cfg = record["config"]
    ms = forward_ms(record)
    if ms is None:
        return None
    dtype = cfg["compute_dtype"]
    least = macs.least_seconds(cfg["arch"], devices.ITEMSIZE[dtype], devices.PEAK_FLOPS[dtype],
                               devices.PEAK_BYTES_PER_S, num_joints=cfg["num_joints"],
                               with_ae=cfg["with_ae"])
    return 100.0 * least * record["images"] / record["calls"] / (ms / 1e3)
