"""Optimizers and LR schedules (counterpart of ``litepose_tpu/train/optim.py``).

``multistep_lr`` gives the optax schedule's value at each step, in float32
as optax computes it; ``make_optimizer`` wraps it in a ``LambdaLR`` whose
factor reproduces it, stepped once per optimizer step.  Two properties of
the optax form carry over:

* with warmup, ``optax.join_schedules`` starts the multistep schedule at
  step ``warmup_steps``, so every milestone moves later by ``warmup_steps``;
* the warmup is ``linear_schedule(0, base_lr)``, so step 0 runs at LR 0.

``adam`` is ``torch.optim.Adam`` (no weight decay, eps 1e-8, as
``optax.adam``); ``sgd`` adds ``weight_decay * param`` to the gradient
before the momentum trace (``optax.add_decayed_weights`` then
``optax.sgd``), which is ``torch.optim.SGD``'s own order.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def multistep_lr(base_lr: float, milestones_epochs: Sequence[int], gamma: float,
                 steps_per_epoch: int, warmup_steps: int = 0) -> Schedule:
    """MultiStepLR (gamma decay at epoch milestones) with optional linear
    warmup: ``schedule(step)`` is the LR of optimizer step ``step``."""
    f32 = np.float32
    boundaries = sorted((int(e) * steps_per_epoch, gamma) for e in milestones_epochs)

    def piecewise(count: int) -> np.float32:
        # optax.piecewise_constant_schedule: v * ind + (1 - ind) * scale * v
        v = f32(base_lr)
        for threshold, scale in boundaries:
            if count >= threshold:
                v = f32(f32(scale) * v)
        return v

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            # optax.linear_schedule(0, base_lr, warmup_steps)
            frac = f32(1) - f32(step) / f32(warmup_steps)
            return float(f32(f32(-base_lr) * frac) + f32(base_lr))
        return float(piecewise(step - warmup_steps if warmup_steps > 0 else step))

    return schedule


def make_optimizer(optimizer: str, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   nesterov: bool = False
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler): 'adam' (no weight decay, as the reference
    factory) or 'sgd' (momentum + weight decay + nesterov).  Call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    base_lr = schedule(0) or 1.0  # LambdaLR multiplies a base; 0 under warmup
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr, momentum=momentum,
                              weight_decay=weight_decay, nesterov=nesterov)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: schedule(step) / base_lr)
    return opt, sched


def set_schedule_step(sched: torch.optim.lr_scheduler.LambdaLR, step: int) -> None:
    """Move a ``LambdaLR`` to ``step`` (a resumed run), setting each group's LR."""
    sched.last_epoch = step
    lrs = [base * fn(step) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(sched.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def from_config(cfg, params: Iterable[torch.nn.Parameter], steps_per_epoch: int):
    sched = multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.LR_STEP, cfg.TRAIN.LR_FACTOR, steps_per_epoch)
    return make_optimizer(cfg.TRAIN.OPTIMIZER, params, sched, momentum=cfg.TRAIN.MOMENTUM,
                          weight_decay=cfg.TRAIN.WD, nesterov=cfg.TRAIN.NESTEROV)
