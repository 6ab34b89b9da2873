"""Device ms a batch call of every kernel that is neither one of the
port's kernel families (K1-K5, K1') nor a copy: normalization, the LitePose
forward, the stage aggregation and the decode's glue; moves ``img_per_s``."""

from harness.layers import forward_ms as read  # noqa: F401
