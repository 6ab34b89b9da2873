"""The served forward's share of the card's peak: 2 x the multiply-adds of the
configuration's convolutions for every image of the traced window, over its
seconds and the peak of the compute dtype (989 TFLOP/s bf16), in %; moves
``img_per_s``."""

from harness.layers import mfu as read  # noqa: F401
