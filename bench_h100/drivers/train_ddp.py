"""Data-parallel training: one process a card over NCCL (gloo on the host),
each rank stepping on its shard of every global batch through the port's
``train.trainer.StepFns`` under ``parallel.mesh``'s process group (synced
BN statistics, one gradient all-reduce a step), as ``torchrun`` of the
train CLI runs it.

Traffic parameters (``traffic/<name>.json``): ``images_per_rank``;
``pool_steps``, the distinct global batches made in set-up from the seed
(images, keypoints and their targets) and cycled through; ``checked_steps``,
the first steps, which the reference follows; ``timing_steps``, the steps
that size the window; ``trace_steps``; ``scene``.  The configuration's
``train`` section holds the output sizes, sigma, the loss factors, Adam's
settings and the limits of ``correct``.

Rank 0 runs in the process that prints the result and starts the other
ranks as processes of this file; the rendezvous is a file in a fresh
directory under ``TMPDIR``.  Weights come from the seed
(``harness/weights.py``).  Set-up drives the step object through the
checked steps, on global batches that all differ, reads each step's loss,
the first gradient from Adam's state after one step and the change of every
parameter and BN statistic after the last, then times ``timing_steps``
steps; rank 0 fixes the window's step count from them, so every rank runs
the same steps.  ``train_img_per_s`` is the global images of the window's
steps over its seconds on rank 0's host clock, the device drained at both
ends.  After the window the program's state is freed and rank 0's card runs
the reference over the checked global batches.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shard(batch, rank: int, n: int):
    lo, hi = rank * n, (rank + 1) * n
    return {k: ([x[lo:hi] for x in v] if isinstance(v, list) else v[lo:hi])
            for k, v in batch.items()}


def _pool(cfg, tr, seed: int, world: int, ranks=None):
    """The global batches; targets only for the rows of ``ranks`` (all when
    None), the rest of a batch's targets left out."""
    from harness import scenes, targets

    t, g = cfg["train"], tr["images_per_rank"] * world
    images, people = scenes.scene_batch(g * tr["pool_steps"], cfg["input_size"], seed,
                                        cfg["num_joints"], tr["scene"]["people"],
                                        tr["scene"]["person_size"])
    pool = []
    for i in range(tr["pool_steps"]):
        rows = range(g) if ranks is None else [r * tr["images_per_rank"] + j for r in ranks
                                               for j in range(tr["images_per_rank"])]
        rows = [i * g + r for r in rows]
        pool.append(targets.batch(images[rows], [people[r] for r in rows], t["output_sizes"],
                                  cfg["num_joints"], t["sigma"], cfg["max_people"]))
    return pool


def _rank(rank: int, spec: dict) -> dict:
    """One rank's set-up, checked steps, window (or traced sub-window);
    rank 0 returns what the outcome needs."""
    import torch
    import torch.distributed as dist

    from harness import trace, weights
    from litepose_tpu_torch.arch import ArchConfig
    from litepose_tpu_torch.core.losses import LossConfig
    from litepose_tpu_torch.models.convert import state_dict_from_jax
    from litepose_tpu_torch.models.litepose import LitePose, ModelSpec
    from litepose_tpu_torch.parallel.mesh import destroy_distributed, init_distributed
    from litepose_tpu_torch.train.checkpoint import init_train_state
    from litepose_tpu_torch.train.optim import make_optimizer, multistep_lr
    from litepose_tpu_torch.train.trainer import StepFns

    cfg, tr, world = spec["config"], spec["traffic"], spec["world"]
    t = cfg["train"]
    torch.set_num_threads(spec["threads"])
    dev = init_distributed(spec["device"], coordinator=spec["init"], num_processes=world,
                           process_id=rank)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    J, ipr = cfg["num_joints"], tr["images_per_rank"]
    arch = ArchConfig.from_dict(cfg["arch"])
    mspec = ModelSpec(num_joints=J, tag_per_joint=cfg["tag_per_joint"],
                      with_heatmaps_loss=tuple(cfg["with_heatmaps"]),
                      with_ae_loss=tuple(cfg["with_ae"]),
                      deconv_kernels=(cfg["deconv_kernel"],) * 3)
    params, state = weights.seeded(cfg["arch"], J, cfg["with_ae"], spec["seed"], dev)
    model = LitePose(mspec, arch, compute_dtype=getattr(torch, cfg["compute_dtype"]))
    model.load_state_dict(state_dict_from_jax(params, state, mspec, arch), strict=True)
    model = model.to(dev).train()
    # the port's Adam: betas (0.9, 0.999), eps 1e-8, as the configuration states
    opt, sched = make_optimizer("adam", model.parameters(),
                                multistep_lr(t["lr"], [], 0.1, 1))
    loss_cfg = LossConfig(num_joints=J, num_stages=len(cfg["with_heatmaps"]),
                          with_heatmaps=tuple(cfg["with_heatmaps"]),
                          heatmaps_factor=tuple(t["heatmaps_factor"]),
                          with_ae=tuple(cfg["with_ae"]), ae_type=t["ae_type"],
                          push_factor=tuple(t["push_factor"]), pull_factor=tuple(t["pull_factor"]))
    step = StepFns(loss_cfg, cfg["input_size"], t["output_sizes"], dev).get()
    ts = init_train_state(model, opt, sched)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pool = _pool(cfg, tr, spec["seed"], world, [rank])
    n_pool = len(pool)

    # the checked steps, through the window's own call and feed
    losses, grad = [], {}
    b1 = t["betas"][0]
    for i in range(tr["checked_steps"]):
        ts, metrics = step(ts, pool[i % n_pool])
        losses.append(float(metrics["total"]))
        if i == 0:
            # a parameter the step left without Adam state reads NaN
            grad = {weights.path_of(n): float((opt.state[p]["exp_avg"] / (1 - b1)).norm())
                    if "exp_avg" in opt.state.get(p, {}) else float("nan")
                    for n, p in model.named_parameters()}
    change = {weights.path_of(k): float((v.float() - start[k].float()).norm())
              for k, v in model.state_dict().items() if weights.path_of(k) is not None}
    done = tr["checked_steps"]

    def one():
        nonlocal ts, done
        ts, _ = step(ts, pool[done % n_pool])
        done += 1

    sync()
    t0 = time.perf_counter()
    for _ in range(tr["timing_steps"]):
        one()
    sync()
    n_steps = torch.tensor([max(1, math.ceil(spec["seconds"] * tr["timing_steps"]
                                             / (time.perf_counter() - t0)))], device=dev)
    dist.broadcast(n_steps, 0)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    out = {"losses": losses, "grad": grad, "change": change, "record": None}
    t_first = time.perf_counter()
    out["setup_s"] = t_first - spec["t_start"]
    if spec["trace"]:
        for _ in range(trace.TRACE_TRIES):
            record = trace.traced(one, tr["trace_steps"], sync)
            bad = torch.tensor([float(bool(trace.check(record)))], device=dev)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX)
            if not bad.item():
                break
        else:
            raise RuntimeError("traced run refused: " + "; ".join(trace.check(record)))
        record.update(calls=tr["trace_steps"], images=tr["trace_steps"] * ipr * world)
        both = torch.tensor([record["busy_s"], record["window_s"]], device=dev,
                            dtype=torch.float64)
        dist.all_reduce(both)
        out["record"] = record
        out["busy_s"], out["window_s"] = (both / world).tolist()
        out["steps"] = tr["trace_steps"]
    else:
        for _ in range(int(n_steps.item())):
            one()
        sync()
        out["window"] = time.perf_counter() - t_first
        out["steps"] = int(n_steps.item())
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0],
                        device=dev, dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    out["memory_peak_bytes"] = int(peak.item())
    out["kind"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
    dist.barrier()
    destroy_distributed()
    return out


def _watch(procs) -> None:
    """A rank that dies leaves the others waiting in a collective: end the
    run, and every rank process, as soon as one fails."""
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            print("bench_h100: a rank process failed", file=sys.stderr, flush=True)
            os._exit(3)
        time.sleep(0.5)


def run(ctx):
    import torch

    from harness import weights
    from harness.core import Check, Outcome
    from reference.train import follow, train_numbers

    cfg, tr, world = ctx.config, ctx.traffic, ctx.chips
    tmp = tempfile.mkdtemp(prefix="bench_h100_ddp_")
    spec = {"config": cfg, "traffic": tr, "world": world, "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": ctx.trace, "device": ctx.device,
            "init": "file://" + os.path.join(tmp, "rendezvous"), "t_start": ctx.t_start,
            "threads": torch.get_num_threads()}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec_path, str(r)],
                              stdout=subprocess.DEVNULL) for r in range(1, world)]
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        got = _rank(0, spec)
        for p in procs:
            if p.wait(timeout=300) != 0:
                raise RuntimeError(f"rank process exited with {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    g = tr["images_per_rank"] * world
    notes = [f"set-up {got['setup_s']:.3f} s; {got['steps']} steps of {g} images"]
    metrics = {}
    if not ctx.trace:
        metrics = {"train_img_per_s": got["steps"] * g / got["window"],
                   "setup_s": got["setup_s"]}
        notes.append(f"window {got['window']:.3f} s, {got['window'] / got['steps'] * 1e3:.3f} "
                     f"ms a step")
    device = {"platform": "gpu" if ctx.device == "cuda" else "cpu", "kind": got["kind"],
              "count": world, "memory_peak_bytes": got["memory_peak_bytes"]}
    if got["record"] is not None:
        device.update(busy_s=got["busy_s"], window_s=got["window_s"])
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batches = _pool(cfg, tr, ctx.seed, world)[:tr["checked_steps"]]
    params, state = weights.seeded(cfg["arch"], cfg["num_joints"], cfg["with_ae"], ctx.seed,
                                   ctx.device)
    ref = follow(params, state, cfg, batches, ctx.device)
    got_numbers = train_numbers(got, ref)
    notes.append(f"reference: {len(batches)} steps of {g} images in "
                 f"{time.perf_counter() - t0:.3f} s; losses program {got['losses']} reference "
                 f"{ref['losses']}")
    notes.append(f"readings {got_numbers}")
    checks = [Check(k, got_numbers[k], float(v)) for k, v in cfg["train"]["limits"].items()]
    return Outcome(metrics=metrics, attempted=got["steps"] * g, failed=0, checks=checks,
                   device=device, record=got["record"], notes=notes)


if __name__ == "__main__":
    for p in (os.path.dirname(BENCH), BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    with open(sys.argv[1]) as f:
        _rank(int(sys.argv[2]), json.load(f))
