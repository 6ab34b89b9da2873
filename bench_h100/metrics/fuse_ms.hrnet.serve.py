"""Device ms a batch call of the kernels and copies launched inside
``litepose.hrnet.fuse`` spans (each module's exchange between branches),
by the CUPTI correlation of each row with its launch; moves ``img_per_s``.
None where the program opens no such span."""

from harness.program import per_call


def read(record):
    return per_call(record, "litepose.hrnet.fuse", "device_s")
