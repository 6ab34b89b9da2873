"""Device ms a batch call of the kernels and copies launched inside
``litepose.effhrnet.se`` spans (each MBConv block's squeeze-excitation), by
the CUPTI correlation of each row with its launch; moves ``img_per_s``.
None where the program opens no such span."""

from harness.program import per_call


def read(record):
    return per_call(record, "litepose.effhrnet.se", "device_s")
