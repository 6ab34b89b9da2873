"""Device ms a batch call of the host-device copies (CUPTI memcpy rows,
HtoD and DtoH): the upload of the uint8 frames and the download of the
people; moves ``img_per_s``."""

from harness.layers import copy_ms as read  # noqa: F401
