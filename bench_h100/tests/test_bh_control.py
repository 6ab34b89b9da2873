"""``correct`` comes out false where it should, on the CPU at a size a test
run holds: for the control (the reference in fp8 with a bf16 decode, put
in the program's place) and for a run whose timed path is broken
underneath (half of each batch left out; an answer altered where the
decode produces it).  On the card the control's readings at the cells' own
sizes come from ``tools/calibrate.py``."""

import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from harness import core, msgpack, scenes, spec
from reference.check import control_outputs, numbers
from reference.litepose import Reference


@pytest.mark.parametrize("name, n", [("auto_xs256", 2), ("auto_s448", 1)])
def test_control_fails_the_limits(name, n):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    weights = msgpack.load_params(os.path.join(ROOT, cfg["weights"]), cfg["weights_sha256"])
    images, _ = scenes.scene_batch(n, cfg["input_size"], seed=2**31 + 21)
    ref = Reference(*weights, cfg["arch"], cfg["num_joints"], "cpu")
    control = Reference(*weights, cfg["arch"], cfg["num_joints"], "cpu", precision="fp8")
    got = numbers(ref, cfg, images, *control_outputs(control, cfg, images))
    failed = [k for k, limit in cfg["limits"].items() if got[k] > limit]
    assert failed, got
    assert got["det_rel_rms"] > cfg["limits"]["det_rel_rms"]


TINY = {"driver": "serve_closed_loop", "why": "a CPU-sized mix", "batch": 2, "pool_batches": 2,
        "warmup_calls": 1, "trace_calls": 2, "scene": {"people": [2, 4], "person_size": [40, 80]}}


def _run(seed):
    bench = spec.load(ROOT)
    cell = spec.Cell(bench, ROOT, "serve-xs256-b128")
    ctx = core.Context(cell=cell.name, config=cell.config, traffic=TINY, chips=1, seed=seed,
                       seconds=0.3, trace=False, root=ROOT, t_start=time.perf_counter(),
                       device="cpu")
    return cell.driver.run(ctx)


def test_sound_run_is_correct():
    out = _run(2**31 + 31)
    assert out.correct, core.check_lines(out)
    assert out.attempted > 0 and out.failed == 0


def test_half_of_each_batch_left_out_is_not_correct(monkeypatch):
    from litepose_tpu_torch.core.engine import PoseEngine

    whole = PoseEngine.run_batch

    def half(self, images_u8):
        x = np.asarray(images_u8)
        outs = whole(self, x[:len(x) // 2])
        return tuple(torch.cat([t, torch.zeros_like(t)]) for t in outs)

    monkeypatch.setattr(PoseEngine, "run_batch", half)
    out = _run(2**31 + 32)
    assert not out.correct
    assert {c.name for c in out.checks if not c.ok} >= {"det_rel_rms"}


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import litepose_tpu_torch.core.engine as engine

    decode = engine.parse_batch

    def altered(*args, **kw):
        people, scores, counts = decode(*args, **kw)
        people = people.clone()
        people[-1, 0, 0, 0] += 1.0
        return people, scores, counts

    monkeypatch.setattr(engine, "parse_batch", altered)
    out = _run(2**31 + 33)
    assert not out.correct
    assert [c.name for c in out.checks if not c.ok] == ["decode_mismatch"]
