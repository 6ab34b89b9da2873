"""Kernel launches a batch call under ``litepose.engine.forward``: those
whose innermost span is the forward and those inside the model's
``litepose.hrnet.*`` and ``litepose.effhrnet.*`` spans, which nest in it;
moves ``img_per_s``.  None where the program opens no forward span."""

from harness.program import per_call

MODEL = ("litepose.hrnet.", "litepose.effhrnet.")


def read(record):
    forward = per_call(record, "litepose.engine.forward", "launches", scale=1)
    if forward is None:
        return None
    inside = [name for name in record["program"]["spans"] if name.startswith(MODEL)]
    return forward + sum(per_call(record, name, "launches", scale=1) for name in inside)
