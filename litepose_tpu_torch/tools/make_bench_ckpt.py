"""Train LitePose on synthetic stick-figure scenes and save a checkpoint
that both packages load (counterpart of ``tools/make_bench_ckpt.py``).

    python -m litepose_tpu_torch.tools.make_bench_ckpt [--steps 8000] [--batch 16]
        [--device cuda] [--out output/bench_ckpt.msgpack]

Auto-S@448 with outputs at 112 and 224, 14 joints, rotation 10 and scale
0.9-1.1 augmentation, batch 16, Adam 1e-3 with one 10x decay at 70% of
``--steps``, bf16 compute, from the port's seeded init (seed 0).  The run caches
``CACHE_EPOCHS`` epochs of host batches on the device first (the numpy
augmentation of one 448 sample costs more than a train step's share of it)
and cycles through them.  ``save_params`` writes the weights; the JAX
package's ``load_params`` and the port's both read them.

The JAX tool passes ``steps_per_epoch=100`` to its schedule, which puts
its decay at 70 times ``--steps``: its runs never decay.  This one decays
at 70% of ``--steps``, as the JAX tool's comment intends.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple

import torch

from ..core.losses import LossConfig
from ..data.dataset import PipelineConfig, TrainPipeline, make_batch_iterator
from ..data.synthetic import SyntheticSource
from ..models.litepose import ModelSpec, get_arch, init_litepose
from ..train import optim
from ..train.checkpoint import TrainState, init_train_state, save_params
from ..train.trainer import StepFns

NUM_JOINTS = 14
SEED = 0  # of the model init
CACHE_EPOCHS = 4
WORKERS = min(8, os.cpu_count() or 1)  # host augmentation threads
PRINT_FREQ = 25


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="auto-S")
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--images", type=int, default=160,
                    help="synthetic set size (about 100 or more generalize to unseen scenes)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("output", "bench_ckpt.msgpack"))
    return ap


class Run(NamedTuple):
    ts: TrainState
    step_fns: StepFns
    pipeline: TrainPipeline
    cached: List[dict]  # host batches, on the device
    losses: List[float]  # total loss of every step
    cache_s: float  # host pipeline time of the cached batches


def pipeline_config(img_size: int) -> PipelineConfig:
    return PipelineConfig(input_size=img_size, output_sizes=(img_size // 4, img_size // 2),
                          num_joints=NUM_JOINTS, dataset="crowd_pose_kpt", max_rotation=10,
                          min_scale=0.9, max_scale=1.1)


def train(args: argparse.Namespace, log=print) -> Run:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("make_bench_ckpt: --device cuda, but torch.cuda.is_available() is False")
    arch = get_arch(args.arch)
    spec = ModelSpec(num_joints=NUM_JOINTS)
    cfg = pipeline_config(arch.img_size)
    # make_fixture's statistics as tools/make_bench_ckpt.py sets them
    source = SyntheticSource(n_images=args.images, h=512, w=512, num_joints=NUM_JOINTS,
                             seed=11, n_people_range=(2, 6), size_range=(30, 100))
    pipe = TrainPipeline(source, cfg, seed=0)

    t0 = time.perf_counter()
    cached = []
    for epoch in range(CACHE_EPOCHS):
        for b in make_batch_iterator(pipe, args.batch, epoch, num_workers=WORKERS):
            cached.append({k: ([torch.from_numpy(x).to(device) for x in v] if isinstance(v, list)
                               else torch.from_numpy(v).to(device)) for k, v in b.items()})
    cache_s = time.perf_counter() - t0
    log(f"cached {len(cached)} host batches in {cache_s:.1f} s")

    model = init_litepose(spec, arch, torch.Generator().manual_seed(SEED),
                          compute_dtype=torch.bfloat16).to(device)
    sched = optim.multistep_lr(1e-3, [max(1, int(args.steps * 0.7))], 0.1, 1)
    opt, lr_sched = optim.make_optimizer("adam", model.parameters(), sched)
    sfns = StepFns(LossConfig(num_joints=NUM_JOINTS), arch.img_size, cfg.output_sizes, device)
    ts = init_train_state(model, opt, lr_sched)

    fn = sfns.get()
    totals = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts, metrics = fn(ts, cached[i % len(cached)])
        totals.append(metrics["total"])
        if i % PRINT_FREQ == 0 or i == args.steps - 1:
            log(f"step {i}: loss {float(metrics['total']):.4f} ({time.perf_counter() - t0:.0f}s)")
    losses = [float(t) for t in totals]

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        save_params(args.out, ts.model)
        log(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return Run(ts, sfns, pipe, cached, losses, cache_s)


def main(argv=None) -> None:
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
