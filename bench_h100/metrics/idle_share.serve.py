"""% of the traced window in which no kernel or copy ran on the card; moves
``img_per_s``."""

from harness.layers import idle_share as read  # noqa: F401
