"""Named ranges on ``torch.profiler``'s own clock, for the serving engine
and the sections of a HigherHRNet or EfficientHRNet forward.

``span(name, args)`` is ``torch.profiler.record_function(name, args)``
while a profiler is recording, and one shared no-op context otherwise:
with no profiler on, a span costs the check of one module flag and makes
no ``RecordFunction``.  The ranges are the profiler's, so they sit on the
clock of its host ops and CUPTI rows, nest as the calls nest, and are
written out with the rest of the trace (``export_chrome_trace``); nothing
here keeps or exports them.

``SPANS`` names every span the port opens: ``ENGINE_SPANS``
(``core/engine.py``), ``HRNET_SPANS`` (``models/higher_hrnet.py``) and
``EFFHRNET_SPANS`` (``models/efficient_hrnet.py``).

- ``litepose.engine.call``: one engine call, the root; ``args`` holds the
  engine's call number and the batch size;
- ``litepose.engine.upload``: the images' checks and their copy to the
  device;
- ``litepose.engine.forward``: normalization, the model, the stage
  aggregation and the projection;
- ``litepose.engine.decode``: ``parse_batch``;
- ``litepose.engine.readback``: the people, scores and counts copied to
  the host, which first waits for the device's work;
- ``litepose.engine.shard``: one shard of a mesh call on its thread;
  ``args`` holds the call number and the shard index;
- ``litepose.hrnet.stem``: the two stride-2 conv-BN-ReLUs and ``layer1``;
- ``litepose.hrnet.transition``: one transition (three a forward);
- ``litepose.hrnet.branches``: one module's parallel branches;
- ``litepose.hrnet.fuse``: one module's exchange (the 1x1 conv-BNs with
  their nearest upsampling, the strided 3x3 chains, the sums and ReLUs);
- ``litepose.hrnet.head``: the final layers and the deconv stage;
- ``litepose.effhrnet.backbone``: EfficientHRNet's stem and MBConv stack,
  its squeeze-excitations included;
- ``litepose.effhrnet.se``: one MBConv block's squeeze-excitation, inside
  the backbone span.

EfficientHRNet's stages are HigherHRNet's modules, so its forward opens
``branches`` and ``fuse`` too, and it opens ``transition`` and ``head``
with the same meanings.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

ENGINE_SPANS = ("litepose.engine.call", "litepose.engine.upload", "litepose.engine.forward",
                "litepose.engine.decode", "litepose.engine.readback", "litepose.engine.shard")
HRNET_SPANS = ("litepose.hrnet.stem", "litepose.hrnet.transition", "litepose.hrnet.branches",
               "litepose.hrnet.fuse", "litepose.hrnet.head")
EFFHRNET_SPANS = ("litepose.effhrnet.backbone", "litepose.effhrnet.se")
SPANS = ENGINE_SPANS + HRNET_SPANS + EFFHRNET_SPANS

NOOP = contextlib.nullcontext()


def span(name: str, args: str = ""):
    """A profiler range ``name`` (with ``args``) while a profiler records,
    else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return record_function(name, args or None)
