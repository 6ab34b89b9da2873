"""% of rank 0's traced window in which no kernel or copy ran on its card;
moves ``train_img_per_s``."""

from harness.layers import idle_share as read  # noqa: F401
