"""The train step and the epoch loop (counterpart of
``litepose_tpu/train/trainer.py``).

A step takes a host batch (uint8 NHWC images, per-stage heatmaps, masks
and joint indices), normalizes the images on the device, optionally
resizes everything to an elastic input size, runs an optional frozen
teacher, then the forward, the loss, the backward, the optimizer step and
the LR schedule.  The model's parameters, its BN statistics and the
optimizer state are updated in place; ``TrainState.step`` counts.

Two behaviours of the JAX step need care in PyTorch:

* ``jax.image.resize(method="nearest")`` samples source pixel
  ``floor((i + 0.5) * in / out)``: ``F.interpolate``'s ``nearest-exact``,
  not its ``nearest`` (``floor(i * in / out)``);
* ``torch.utils.checkpoint`` runs the forward again in the backward, and a
  BN in training mode would update its running statistics a second time;
  the remat step puts them back after the recomputation, so they equal
  the plain step's, as JAX's functional state does.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.inference import normalize_images
from ..core.losses import LossConfig, distill_loss, multi_loss
from .checkpoint import TrainState


def nearest_resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of the last two axes of a
    (B, C, H, W) or (B, H, W) tensor."""
    if x.dim() == 3:
        return F.interpolate(x[:, None], size=hw, mode="nearest-exact")[:, 0]
    return F.interpolate(x, size=hw, mode="nearest-exact")


def remap_joint_indices(joints: torch.Tensor, src_res: int, dst_res: int) -> torch.Tensor:
    """Rescale flat joint indices (j*r^2 + y*r + x) from src_res to dst_res."""
    flat = joints[..., 0].long()
    vis = joints[..., 1]
    j = flat // (src_res * src_res)
    rem = flat % (src_res * src_res)
    y = rem // src_res
    x = rem % src_res
    x2 = (x * dst_res) // src_res
    y2 = (y * dst_res) // src_res
    new_flat = j * dst_res * dst_res + y2 * dst_res + x2
    return torch.stack([new_flat.to(joints.dtype), vis], dim=-1)


class _KeepBNStats:
    """Snapshot every BN's running statistics on entry and put them back on
    exit: wraps the recomputation of a checkpointed forward."""

    def __init__(self, model: nn.Module):
        self.bufs = [b for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
                     for b in (m.running_mean, m.running_var, m.num_batches_tracked)
                     if b is not None]

    def __enter__(self):
        self.saved = [b.clone() for b in self.bufs]

    def __exit__(self, *exc):
        with torch.no_grad():
            for b, s in zip(self.bufs, self.saved):
                b.copy_(s)
        return False


class StepFns:
    """Train steps, one per elastic input size, with a shared signature
    ``step(ts, batch) -> (ts, metrics)``.

    teacher_fn: a frozen teacher, ``(x) -> [stage outputs]`` on normalized
    images at ``teacher_size`` (an eval-mode ``LitePose``, whose BNs are
    folded); it runs under ``no_grad``.  remat: recompute the forward in
    the backward instead of keeping its activations."""

    def __init__(self, loss_cfg: LossConfig, base_input_size: int,
                 base_output_sizes: Sequence[int], device: torch.device,
                 teacher_fn: Optional[Callable] = None, teacher_size: int = 448,
                 remat: bool = False):
        self.loss_cfg = loss_cfg
        self.base_input_size = base_input_size
        self.base_output_sizes = list(base_output_sizes)
        self.device = torch.device(device)
        self.teacher_fn = teacher_fn
        self.teacher_size = teacher_size
        self.remat = remat
        self._cache: Dict[Optional[int], Callable] = {}

    def get(self, img_size: Optional[int] = None) -> Callable:
        """The step for a given elastic input size (None = native)."""
        if img_size not in self._cache:
            self._cache[img_size] = self._build(img_size)
        return self._cache[img_size]

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _forward(self, model: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
        if not self.remat:
            return model(x)
        outs = checkpoint(lambda t: tuple(model(t)), x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), _KeepBNStats(model)))
        return list(outs)

    def _build(self, img_size: Optional[int]) -> Callable:
        cfg = self.loss_cfg

        def step(ts: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            images = normalize_images(self._put(batch["images"]))
            heatmaps = [self._put(h) for h in batch["heatmaps"]]
            masks = [self._put(m) for m in batch["masks"]]
            joints = [self._put(j) for j in batch["joints"]]

            if img_size is not None and img_size != self.base_input_size:
                images = nearest_resize(images, (img_size, img_size))
                out_size = img_size // 4
                for i in range(len(heatmaps)):
                    heatmaps[i] = nearest_resize(heatmaps[i], (out_size, out_size))
                    masks[i] = nearest_resize(masks[i], (out_size, out_size))
                    joints[i] = remap_joint_indices(joints[i], self.base_output_sizes[i], out_size)
                    out_size *= 2

            t_heatmaps = None
            if self.teacher_fn is not None:
                with torch.no_grad():
                    t_outs = self.teacher_fn(nearest_resize(
                        images, (self.teacher_size, self.teacher_size)))
                    t_heatmaps = [nearest_resize(t_outs[i][:, :cfg.num_joints], h.shape[2:4])
                                  for i, h in enumerate(heatmaps)]

            model, opt = ts.model, ts.optimizer
            if not model.training:
                model.train()
            opt.zero_grad(set_to_none=True)
            outs = self._forward(model, images)
            loss, metrics = multi_loss(outs, heatmaps, masks, joints, cfg)
            if t_heatmaps is not None:
                t_loss = distill_loss(outs, t_heatmaps, masks, cfg)
                loss = loss + t_loss
                metrics["distill"] = t_loss
                metrics["total"] = loss
            loss.backward()
            opt.step()
            ts.scheduler.step()
            return ts._replace(step=ts.step + 1), {k: v.detach() for k, v in metrics.items()}

        return step


class AverageMeter:
    """Running average (reference ``lib/utils/utils.py:169-184``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0


def train_epoch(step_fns: StepFns, ts: TrainState, batches, epoch: int, logger=None,
                print_freq: int = 20, elastic_sizes: Optional[Sequence[int]] = None,
                seed: int = 0, writer=None):
    """One epoch over an iterator of host batches.

    elastic_sizes: when set, a random input size is drawn per step from
    ``np.random.default_rng((seed, epoch))``, the JAX loop's draws."""
    meters: Dict[str, AverageMeter] = {}
    rng = np.random.default_rng((seed, epoch))
    t0 = time.time()
    data_meter, batch_meter = AverageMeter(), AverageMeter()
    for i, batch in enumerate(batches):
        data_meter.update(time.time() - t0)
        img_size = None
        if elastic_sizes is not None:
            img_size = int(rng.choice(np.asarray(elastic_sizes)))
        ts, metrics = step_fns.get(img_size)(ts, batch)
        if i % print_freq == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter()).update(v, len(batch["images"]))
            batch_meter.update(time.time() - t0)
            if logger:
                msg = " ".join(f"{k}: {m.val:.3e} ({m.avg:.3e})" for k, m in meters.items())
                speed = len(batch["images"]) / max(batch_meter.val, 1e-9)
                logger.info(f"Epoch [{epoch}][{i}] time {batch_meter.val:.3f}s "
                            f"speed {speed:.1f} img/s data {data_meter.val:.3f}s {msg}")
            if writer is not None:
                for k, v in metrics.items():
                    writer.add_scalar(f"train_{k}", v, int(ts.step))
        t0 = time.time()
    return ts, {k: m.avg for k, m in meters.items()}
