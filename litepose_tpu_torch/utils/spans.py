"""Named ranges on ``torch.profiler``'s own clock, for the serving engine.

``span(name, args)`` is ``torch.profiler.record_function(name, args)``
while a profiler is recording, and one shared no-op context otherwise:
with no profiler on, a span costs the check of one module flag and makes
no ``RecordFunction``.  The ranges are the profiler's, so they sit on the
clock of its host ops and CUPTI rows, nest as the calls nest, and are
written out with the rest of the trace (``export_chrome_trace``); nothing
here keeps or exports them.

``SPANS`` names every span the port opens (``core/engine.py``):

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
  ``args`` holds the call number and the shard index.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

SPANS = ("litepose.engine.call", "litepose.engine.upload", "litepose.engine.forward",
         "litepose.engine.decode", "litepose.engine.readback", "litepose.engine.shard")

NOOP = contextlib.nullcontext()


def span(name: str, args: str = ""):
    """A profiler range ``name`` (with ``args``) while a profiler records,
    else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return record_function(name, args or None)
