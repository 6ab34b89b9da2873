"""Device ms a batch call of the port's kernel families (K1 NMS +
top-M, K2 greedy grouping), each family's CUPTI rows held to its wrapper's
launch count by the traced run; moves ``img_per_s``."""

from harness.layers import decode_ms as read  # noqa: F401
