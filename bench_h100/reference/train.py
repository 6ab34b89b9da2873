"""The plain reference of the data-parallel training step: the whole global
batch on one device, fp32, TF32 off.

One step: the forward in training mode (every BN on the global batch's
statistics), the loss, the gradients by autograd and Adam.  The loss, as
LitePose trains (mit-han-lab/litepose ``lib/core/loss.py``):

- per stage with heatmaps, the masked squared error ``(pred - target)^2 *
  mask`` averaged over images, joints and pixels, times its factor;
- on the stage with tags, the associative-embedding loss (``exp``): pull,
  each person's variance of its joints' tags around their mean, averaged
  over the image's people; push, ``0.5 * (sum over pairs of people, each
  pair twice and each person with itself, of exp(-(m_a - m_b)^2) - n) /
  ((n - 1) n)``, 0 for fewer than two people; each averaged over images and
  times its factor.

Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr *
(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.

``train_numbers`` compares two runs of three steps the way ``correct``
is decided for the training cell.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from harness.weights import leaves
from .litepose import Reference, fp32_exact

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is below this share of the median leaf's


def ae_loss(tags: torch.Tensor, joints: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tags (B, J, H, W); joints (B, P, J, 2) int: (flat index j*H*W + y*W + x,
    visible) -> (push, pull), each averaged over images."""
    B = tags.shape[0]
    idx = joints[..., 0].long().reshape(B, -1)
    vis = joints[..., 1].to(tags.dtype)  # (B, P, J)
    t = torch.gather(tags.reshape(B, -1), 1, idx).reshape(vis.shape) * vis
    count = vis.sum(-1)  # (B, P)
    people = count > 0
    mean = t.sum(-1) / count.clamp(min=1)  # (B, P)
    var = (vis * (t - mean[..., None]) ** 2).sum(-1) / count.clamp(min=1)
    n = people.sum(-1).to(tags.dtype)  # (B,)
    pull = (var * people).sum(-1) / n.clamp(min=1)
    pair = people[:, :, None] & people[:, None, :]
    d = mean[:, :, None] - mean[:, None, :]
    close = (torch.exp(-d * d) * pair).sum((1, 2))
    push = torch.where(n >= 2, 0.5 * (close - n) / ((n - 1) * n).clamp(min=1), 0.0)
    return push.mean(), pull.mean()


def loss(outs: Sequence[torch.Tensor], batch: Dict, cfg: Dict) -> torch.Tensor:
    J, tr = cfg["num_joints"], cfg["train"]
    total = 0.0
    for i, out in enumerate(outs):
        if cfg["with_heatmaps"][i]:
            err = (out[:, :J] - batch["heatmaps"][i]) ** 2 * batch["masks"][i][:, None]
            total = total + err.mean() * tr["heatmaps_factor"][i]
        if cfg["with_ae"][i]:
            offset = J if cfg["with_heatmaps"][i] else 0
            push, pull = ae_loss(out[:, offset:offset + J], batch["joints"][i])
            total = total + push * tr["push_factor"][i] + pull * tr["pull_factor"][i]
    return total


class TrainReference:
    """Three (or more) training steps of the reference on whole global
    batches, from the seeded (params, state) trees."""

    def __init__(self, params, state, cfg: Dict, device, precision: str = "fp32",
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.net = Reference(params, state, cfg["arch"], cfg["num_joints"], device, precision,
                             dtype)
        self.net.training = True
        self.params = [(path, t.requires_grad_(True)) for path, t in leaves(self.net.p)]
        self.m = [torch.zeros_like(t) for _, t in self.params]
        self.v = [torch.zeros_like(t) for _, t in self.params]
        self.t = 0

    def step(self, batch: Dict) -> Tuple[float, Dict[tuple, torch.Tensor]]:
        """One step on a host batch: (loss, gradient of each parameter)."""
        dev, dt = self.net.device, self.net.dtype
        on = {"heatmaps": [torch.as_tensor(h, device=dev, dtype=dt) for h in batch["heatmaps"]],
              "masks": [torch.as_tensor(m, device=dev, dtype=dt) for m in batch["masks"]],
              "joints": [torch.as_tensor(j, device=dev) for j in batch["joints"]]}
        tr = self.cfg["train"]
        b1, b2 = tr["betas"]
        with fp32_exact():
            outs = self.net.stages(self.net.normalize(torch.as_tensor(batch["images"])))
            total = loss(outs, on, self.cfg)
            grads = torch.autograd.grad(total, [t for _, t in self.params])
        total = float(total.detach())
        self.t += 1
        with torch.no_grad():
            for (_, p), g, m, v in zip(self.params, grads, self.m, self.v):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p -= tr["lr"] * (m / (1 - b1 ** self.t)) / (
                    torch.sqrt(v / (1 - b2 ** self.t)) + tr["eps"])
        return total, {path: g for (path, _), g in zip(self.params, grads)}

    def tensors(self) -> Dict[tuple, torch.Tensor]:
        """Every parameter and BN statistic by ("params" | "state", path)."""
        out = {("params",) + path: t.detach() for path, t in leaves(self.net.p)}
        out.update({("state",) + path: t for path, t in leaves(self.net.s)})
        return out


def follow(params, state, cfg: Dict, batches: Sequence[Dict], device,
           precision: str = "fp32") -> Dict:
    """The reference's readings over ``batches`` (one step each): each step's
    loss, the first step's gradient norm of each parameter, and the norm of
    each parameter's and BN statistic's change over all the steps."""
    ref = TrainReference(params, state, cfg, device, precision)
    start = {k: t.clone() for k, t in ref.tensors().items()}
    losses, grad = [], {}
    for i, b in enumerate(batches):
        value, grads = ref.step(b)
        losses.append(value)
        if i == 0:
            grad = {("params",) + path: float(g.norm()) for path, g in grads.items()}
    change = {k: float((t - start[k]).norm()) for k, t in ref.tensors().items()}
    return {"losses": losses, "grad": grad, "change": change}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss.
    ``grad_gap`` and ``change_gap``: by the worst leaf, the gap between the
    program's norm and the reference's, over the reference's norm of that
    leaf or of the median leaf, whichever is larger.  The change leaves out
    parameters whose reference gradient is under ``GRAD_FLOOR`` of the
    median leaf's (they move by round-off alone under Adam)."""
    loss_gap = float(np.max([abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]))
    med_g = float(np.median(list(ref["grad"].values())))
    grad = [abs(prog["grad"][k] - g) / max(g, med_g) for k, g in ref["grad"].items()]
    kept = [k for k in ref["change"]
            if k[0] == "state" or ref["grad"][k] >= GRAD_FLOOR * med_g]
    med_c = float(np.median([ref["change"][k] for k in kept]))
    change = [abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
              for k in kept]
    return {"loss_gap": loss_gap,
            "loss_gap_1": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": float(np.max(grad)), "grad_gap_median": float(np.median(grad)),
            "change_gap": float(np.max(change)), "change_gap_median": float(np.median(change))}

