"""The readings a cell's limits are set from, in one process on the card:
the program's numbers over many seeds (a short window each at the cell's
own load, checked as a run checks it) and, over a few, the control's (the
reference put in the program's place in the precision below the
configuration's: fp8 convs, and for serving a bf16 decode) and, for a
training cell, the faults' (half of each global batch left out; the
exchange between ranks left out, so rank 0 steps on its own shard with its
own BN statistics).  A state left unchanged reads 1 for ``change_gap``
and needs no run.

    python3 bench_h100/tools/calibrate.py --workload serve-s448-b64 \
        --seeds 11,12,... --control-seeds 11,12,13 [--seconds 3] [--out FILE]

Prints one JSON object: each number's readings by seed, for the program and
the control.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="the program's seeds; may be empty")
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import core, msgpack, scenes, spec
    from reference.check import control_outputs, numbers
    from reference.litepose import Reference

    bench = spec.load(ROOT)
    cell = spec.Cell(bench, ROOT, args.workload)
    cfg = dict(cell.config, limits={k: math.inf for k in cell.config["limits"]})
    if "train" in cfg:
        cfg["train"] = dict(cfg["train"],
                            limits={k: math.inf for k in cfg["train"]["limits"]})
    tr = cell.traffic
    out = {"workload": args.workload, "program": {}, "control": {}}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    chips = cell.workload["chips"]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        ctx = core.Context(cell=args.workload, config=cfg, traffic=tr, chips=chips, seed=seed,
                           seconds=args.seconds, trace=False, root=ROOT,
                           t_start=time.perf_counter(), device=args.device)
        got = cell.driver.run(ctx)
        out["program"][seed] = {c.name: c.value for c in got.checks}
        out["program"][seed]["failed"] = got.failed
        print(f"program seed {seed}: {out['program'][seed]}", file=sys.stderr, flush=True)
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    if tr["driver"] == "train_ddp" and args.seeds:
        # a process joins the NCCL group of a second run badly: take the
        # program's readings from the runs of run.py, one process each
        raise SystemExit("calibrate: a training cell takes --seeds \"\" (its runs give the "
                         "program's readings)")
    if tr["driver"] == "train_ddp":
        out.update(_train_faults(cell, cfg, control_seeds, args.device))
    else:
        weights = msgpack.load_params(os.path.join(ROOT, cfg["weights"]), cfg["weights_sha256"])
        ref = Reference(*weights, cfg["arch"], cfg["num_joints"], args.device)
        control = Reference(*weights, cfg["arch"], cfg["num_joints"], args.device,
                            precision="fp8")
        for seed in control_seeds:
            images, _ = scenes.scene_batch(tr["batch"] * tr["pool_batches"], cfg["input_size"],
                                           seed, cfg["num_joints"], tr["scene"]["people"],
                                           tr["scene"]["person_size"])
            out["control"][seed] = numbers(ref, cfg, images,
                                           *control_outputs(control, cfg, images))
            print(f"control seed {seed}: {out['control'][seed]}", file=sys.stderr, flush=True)
    for side in [k for k in ("program", "control", "half_batch", "no_exchange") if k in out]:
        if not out[side]:
            continue
        names = sorted({k for r in out[side].values() for k in r})
        out[side + "_range"] = {k: [min(r[k] for r in out[side].values()),
                                    max(r[k] for r in out[side].values())] for k in names}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


def _train_faults(cell, cfg, seeds, device):
    """The control and the faults of a training cell, each put in the
    program's place and read against the fp32 reference."""
    from harness import weights
    from reference.train import follow, train_numbers

    driver = cell.driver
    tr, world = cell.traffic, cell.workload["chips"]
    ipr = tr["images_per_rank"]
    out = {"control": {}, "half_batch": {}, "no_exchange": {}}
    for seed in seeds:
        batches = driver._pool(cfg, tr, seed, world)[:tr["checked_steps"]]
        tree = weights.seeded(cfg["arch"], cfg["num_joints"], cfg["with_ae"], seed, device)
        ref = follow(*tree, cfg, batches, device)
        runs = {"control": follow(*tree, cfg, batches, device, precision="fp8"),
                "half_batch": follow(*tree, cfg, [driver._shard(b, 0, ipr * world // 2)
                                                  for b in batches], device),
                "no_exchange": follow(*tree, cfg, [driver._shard(b, 0, ipr) for b in batches],
                                      device)}
        for name, got in runs.items():
            out[name][seed] = train_numbers(got, ref)
            print(f"{name} seed {seed}: {out[name][seed]}", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
