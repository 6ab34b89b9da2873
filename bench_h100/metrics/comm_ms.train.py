"""Device ms a step of the NCCL kernels on rank 0 (CUPTI rows whose name holds
``nccl``): the BN statistics' all-reduces and the gradient all-reduce, with
the time they spin waiting for the other ranks; moves ``train_img_per_s``."""

from harness.layers import comm_ms as read  # noqa: F401
