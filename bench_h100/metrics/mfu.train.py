"""The training step's share of the cards' peak: 3 x the conv FLOPs of an
image (forward, and a backward of twice its work) x the global images of
rank 0's traced window, over its seconds and the cards' count x the peak of
the compute dtype (989 TFLOP/s bf16), in %; moves ``train_img_per_s``."""

from harness.layers import mfu


def read(record):
    return mfu(record, passes=3)
