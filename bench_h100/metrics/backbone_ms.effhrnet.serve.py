"""Device ms a batch call of the kernels and copies launched inside
``litepose.effhrnet.backbone`` spans (EfficientHRNet's stem and MBConv
stack), its nested ``litepose.effhrnet.se`` spans included, by the CUPTI
correlation of each row with its launch; moves ``img_per_s``.  None where
the program opens no such span."""

from harness.program import per_call


def read(record):
    backbone = per_call(record, "litepose.effhrnet.backbone", "device_s")
    if backbone is None:
        return None
    return backbone + (per_call(record, "litepose.effhrnet.se", "device_s") or 0.0)
