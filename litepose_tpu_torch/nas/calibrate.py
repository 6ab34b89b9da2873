"""BatchNorm re-calibration for sub-networks of the supernet (counterpart of
``litepose_tpu/nas/calibrate.py``).

A weight-sharing supernet's BN running statistics match no single
sub-network, so before a candidate is scored its statistics are recomputed
by forwarding calibration batches in training mode.  The state is a dict
{state-dict name: running mean or var} (``bn_state``), the JAX BN state;
``apply_train_fn(state, images) -> new state`` runs one batch from
``state`` (``module_train_fn`` builds it for a module).

* ``momentum``: the reference's behaviour, the EMA (momentum 0.1) chained
  over the batches;
* ``average`` (default): each batch starts from the same state; its batch
  moments are recovered as ``(new - 0.9 old) / 0.1`` and averaged, the JAX
  arithmetic in fp32 (not PyTorch's cumulative ``momentum=None``, which
  rounds differently).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
import torch.nn as nn

State = Dict[str, torch.Tensor]


def bn_state(model: nn.Module) -> State:
    """Every BN's running mean and var, cloned."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def load_bn_state(model: nn.Module, state: State) -> None:
    """Copy ``state`` into the model's BN buffers (a folded ``LitePose``
    must be refolded after: ``train()`` then ``eval()``)."""
    own = model.state_dict()
    with torch.no_grad():
        for k, v in state.items():
            own[k].copy_(v)


def module_train_fn(model: nn.Module, forward: Callable[[torch.Tensor], object]
                    ) -> Callable[[State, torch.Tensor], State]:
    """``apply_train_fn`` of a module: load the state, run ``forward(images)``
    in training mode without gradients, return the new statistics."""

    def apply(state: State, images: torch.Tensor) -> State:
        load_bn_state(model, state)
        model.train()
        with torch.no_grad():
            forward(images)
        return bn_state(model)

    return apply


def calibrate_bn(apply_train_fn: Callable[[State, torch.Tensor], State], state: State,
                 batches: Iterable, mode: str = "average") -> State:
    """Recompute BN statistics from calibration batches; returns the new
    state (``state`` itself when there is no batch)."""
    if mode == "momentum":
        for images in batches:
            state = apply_train_fn(state, images)
        return state
    if mode != "average":
        raise ValueError(f"calibrate_bn mode {mode!r}: expected 'average' or 'momentum'")
    acc, count = None, 0
    for images in batches:
        new = apply_train_fn(state, images)
        # a tensor divisor: CUDA turns a division by a Python scalar into a
        # product with its reciprocal, which rounds otherwise
        tenth = torch.full((), 0.1, dtype=torch.float32)
        batch = {k: (new[k] - 0.9 * state[k]) / tenth.to(new[k].device) for k in new}
        acc = batch if acc is None else {k: acc[k] + batch[k] for k in acc}
        count += 1
    if acc is None:
        return state
    return {k: v / torch.full((), float(count), device=v.device) for k, v in acc.items()}
