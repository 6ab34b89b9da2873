"""A/B of the eval protocol between two checkouts of this repo on one card.

    python3 litepose_tpu_torch/tools/ab_eval.py --a PARENT_ROOT --b . [--pairs 10]

Starts one worker process per checkout, each importing that checkout's
``litepose_tpu_torch``, and builds in each the eval-protocol engine of
``chip_smoke.py`` phase 9: LitePose-Auto-S@448 from
``assets/bench_ckpt.msgpack``, bf16 compute and fp32 maps, flip test,
projection, exact top-M, Hungarian grouping, adjust and refine, batch 32.
Each turn of a worker times, on the host clock after a synchronize,
``PoseEngine.process_many`` on the 48 seeded scenes of phase 9 (32 squares,
8 each padded to 448x600 and 600x448) and then the mean of 5
``process_batch_square`` calls on the 32 squares.  The workers take turns,
so only one runs at a time, and the pairs alternate which checkout goes
first.  Each worker also reads once its eval batch's own peak device memory
(``process_batch_square`` at batch 32: the most it allocates above what the
process holds before it).  Prints one JSON object: the card, and per
checkout the times, their quartiles and the peak.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SIZE, BATCH, SEED = 448, 32, 7


def worker(root: str) -> None:
    """Serve turns on stdin ("run" or "quit"), one JSON line on stdout each."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.data.flip import flip_index_for
    from litepose_tpu_torch.data.synthetic import bench_scene_batch
    from litepose_tpu_torch.models.convert import litepose_from_jax
    from litepose_tpu_torch.models.litepose import ModelSpec, get_arch
    from litepose_tpu_torch.ops.group import GroupParams
    from litepose_tpu_torch.train.checkpoint import load_params

    dev = torch.device("cuda:0")
    params, state = load_params(os.path.join(root, "assets", "bench_ckpt.msgpack"))
    model = litepose_from_jax(params, state, ModelSpec(num_joints=14), get_arch("auto-S")).to(dev)
    flags = InferenceFlags(num_joints=14, with_heatmaps_loss=(True, True),
                           with_ae_loss=(True, False), test_with_heatmaps=(True, True),
                           test_with_ae=(True, False), flip_test=True,
                           flip_index=tuple(flip_index_for("crowd_pose")))
    engine = PoseEngine(model, flags, GroupParams(num_joints=14, detection_threshold=0.1),
                        EngineConfig(input_size=SIZE), device=dev)
    images = bench_scene_batch(64, SIZE, seed=SEED)
    wide = [np.pad(im, ((0, 0), (0, 152), (0, 0))) for im in images[32:40]]  # 448x600
    tall = [np.pad(im, ((0, 152), (0, 0), (0, 0))) for im in images[40:48]]  # 600x448
    sources = list(images[:32]) + wide + tall
    squares = images[:BATCH]
    engine.process_many(sources, batch_size=BATCH)  # warm-up
    engine.process_batch_square(squares)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.process_batch_square(squares)
    peak = torch.cuda.max_memory_allocated() - held
    print(json.dumps({"ready": True, "eval_peak_bytes": peak}), flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.process_many(sources, batch_size=BATCH)
        many_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(5):
            engine.process_batch_square(squares)
        batch_s = (time.perf_counter() - t0) / 5
        print(json.dumps({"process_many_s": many_s, "eval_batch_s": batch_s}), flush=True)


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"q1": q1, "median": q2, "q3": q3}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", help="root of the first checkout (the parent)")
    ap.add_argument("--b", help="root of the second checkout (the change)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    procs = {}
    try:
        for key in ("a", "b"):
            procs[key] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", getattr(args, key)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        ready = {key: json.loads(p.stdout.readline()) for key, p in procs.items()}
        runs = {"a": [], "b": []}
        for i in range(args.pairs):
            for key in (("a", "b") if i % 2 == 0 else ("b", "a")):
                procs[key].stdin.write("run\n")
                procs[key].stdin.flush()
                runs[key].append(json.loads(procs[key].stdout.readline()))
    finally:
        for p in procs.values():
            try:
                p.stdin.write("quit\n")
                p.stdin.close()
            except OSError:  # the worker has died
                pass
        for p in procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
    out = {"card": card, "pairs": args.pairs}
    for key in ("a", "b"):
        many = [r["process_many_s"] for r in runs[key]]
        batch = [r["eval_batch_s"] for r in runs[key]]
        out[key] = {"root": getattr(args, key),
                    "eval_peak_bytes": ready[key]["eval_peak_bytes"],
                    "process_many_s": many, "process_many_quartiles": quartiles(many),
                    "eval_batch_s": batch, "eval_batch_quartiles": quartiles(batch)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
