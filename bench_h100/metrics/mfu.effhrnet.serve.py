"""The served EfficientHRNet forward's share of the card's peak: 2 x the
multiply-adds of the configuration's convolutions and linears
(``harness/effhrnet_macs.py``) for every image of the traced window, over
its seconds and the peak of the compute dtype (989 TFLOP/s bf16), in %;
moves ``img_per_s``."""

from harness import devices, effhrnet_macs


def read(record):
    cfg = record["config"]
    if record["window_s"] <= 0 or not record.get("images") or not record["ops"]:
        return None
    rate = 2 * effhrnet_macs.macs(cfg) * record["images"] / record["window_s"]
    return 100.0 * rate / (record["chips"] * devices.PEAK_FLOPS[cfg["compute_dtype"]])
