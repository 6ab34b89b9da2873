"""Device ms a batch call of the kernels and copies launched inside
``litepose.hrnet.branches`` spans (each module's parallel BasicBlocks), by
the CUPTI correlation of each row with its launch; moves ``img_per_s``.
None where the program opens no such span."""

from harness.program import per_call


def read(record):
    return per_call(record, "litepose.hrnet.branches", "device_s")
