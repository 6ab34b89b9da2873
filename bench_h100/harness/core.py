"""What a cell's run gets and returns, the import guard, and the last line.

A cell's ``drivers/<name>.py`` has ``run(ctx)``: a ``Context`` in, an
``Outcome`` out, which ``run.py`` turns into the result line.  The per-layer metrics
of a traced run are read from ``Outcome.record`` by the cell's readers.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Dict, List, Optional, Tuple

# top-level module names that may not be loaded in a run: JAX, and the JAX
# package the port was made from (compared whole: litepose_tpu_torch passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "litepose_tpu")


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    seed: int
    seconds: float
    trace: bool
    root: str  # the checkout
    t_start: float  # time.perf_counter() at process start
    device: str = "cuda"  # "cpu" only in the CPU tests, which skip the look for a card


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``, with its limit: correct while
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]  # end-to-end metrics taken by the harness
    attempted: int
    failed: int
    checks: List[Check]
    device: Dict[str, Any]
    record: Optional[Dict[str, Any]] = None  # the traced window, with --trace 1
    notes: List[str] = dataclasses.field(default_factory=list)  # stderr lines

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names that ``modules`` (``sys.modules``)
    holds."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def result_line(outcome: Outcome, metrics: Dict[str, Tuple[float, str]],
                breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and the
    numbers compared with their limits last."""
    line: Dict[str, Any] = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": outcome.device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return json.dumps(line)


def check_lines(outcome: Outcome) -> List[str]:
    """The numbers compared, each beside its limit, for standard error."""
    return [f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
            for c in outcome.checks] + [
        f"correct {str(outcome.correct).lower()}: {outcome.failed} of {outcome.attempted} "
        f"failed"]
