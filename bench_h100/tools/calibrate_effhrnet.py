"""The readings the limits of an EfficientHRNet serving cell are set from, in
one process on the card, as ``tools/calibrate_hrnet.py`` takes them for a
HigherHRNet cell: the program's numbers over many seeds (a short window each
at the cell's own load, checked as a run checks it) and, over a few, the
control's (the reference in the program's place in fp8 convs, its decode in
bf16).  The weights are the cell's seeded ones (``weights`` of
``drivers/serve_effhrnet_closed_loop.py``).  With ``--shift`` it first
computes the heatmap biases from the fp32 reference (``heatmap_bias_shift``
of the driver), prints them and takes the readings with them in place of the
configuration's: the values to commit in the configuration.

    python3 bench_h100/tools/calibrate_effhrnet.py --workload serve-effh1-480-b64 \
        --seeds 11,12,... --control-seeds 11,12,13 [--seconds 3] [--shift] [--out FILE]

Prints one JSON object: each number's readings by seed, for the program and
the control, and their ranges.  The benchmark's own runs never run the
control.
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
    ap.add_argument("--shift", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import core, scenes, spec
    from reference.check import control_outputs, numbers

    cell = spec.Cell(spec.load(ROOT), ROOT, args.workload)
    driver = cell.driver
    cfg = dict(cell.config, limits={k: math.inf for k in cell.config["limits"]})
    tr = cell.traffic
    out = {"workload": args.workload, "program": {}, "control": {}}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    if args.shift:
        cfg["heatmap_bias_shift"] = driver.heatmap_bias_shift(cfg, args.device)
        out["heatmap_bias_shift"] = cfg["heatmap_bias_shift"]
        print(f"heatmap_bias_shift: {cfg['heatmap_bias_shift']}", file=sys.stderr, flush=True)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        ctx = core.Context(cell=args.workload, config=cfg, traffic=tr,
                           chips=cell.workload["chips"], seed=seed, seconds=args.seconds,
                           trace=False, root=ROOT, t_start=time.perf_counter(),
                           device=args.device)
        got = driver.run(ctx)
        out["program"][seed] = {c.name: c.value for c in got.checks}
        out["program"][seed]["failed"] = got.failed
        out["program"][seed]["img_per_s"] = got.metrics.get("img_per_s")
        print(f"program seed {seed}: {out['program'][seed]}", file=sys.stderr, flush=True)
    sd = driver.weights(cfg)
    ref = driver.reference(sd, cfg, args.device)
    control = driver.reference(sd, cfg, args.device, precision="fp8")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        images, _ = scenes.scene_batch(tr["batch"] * tr["pool_batches"], cfg["input_size"], seed,
                                       cfg["num_joints"], tr["scene"]["people"],
                                       tr["scene"]["person_size"])
        out["control"][seed] = numbers(ref, cfg, images, *control_outputs(control, cfg, images))
        print(f"control seed {seed}: {out['control'][seed]}", file=sys.stderr, flush=True)
    for side in ("program", "control"):
        if out[side]:
            names = sorted({k for r in out[side].values() for k in r
                            if isinstance(r[k], (int, float))})
            out[side + "_range"] = {k: [min(r[k] for r in out[side].values()),
                                        max(r[k] for r in out[side].values())] for k in names}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
