"""The forward's least time, worked out from the architecture alone, over
``forward_ms`` of the same cell, in %; moves ``img_per_s``."""

from harness.layers import forward_roofline as read  # noqa: F401
