"""Devices, process groups and the collectives of data parallelism
(counterpart of ``litepose_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a ``Mesh('data')``: the gradient all-reduce
is implicit in the sharded jit, and ``jnp.mean`` over a batch sharded on
the mesh is already the global mean, so every training BN is a SyncBN.
PyTorch runs one process per card (``torchrun``, the reference's
``dist_train.py``), so both become explicit here:

* ``init_distributed`` / ``world``: the process group, NCCL between cards
  and gloo on the host, from torchrun's environment or an explicit
  rendezvous;
* ``sync_batch_stats``: the global per-channel mean and biased variance of
  a training BN's input, in two passes as ``jnp.mean`` then ``jnp.var``,
  through differentiable all-reduces (the layers' training BNs and the
  supernet's ``masked_bn`` call it);
* ``all_reduce_mean_``: gradients and metrics averaged over the ranks, one
  flat all-reduce a dtype;
* ``make_mesh`` / ``shard_batch`` / ``gather`` / ``replicate``: the devices
  one process serves on, the batch split over them and put back together,
  and a model copied to each (``PoseEngine(mesh=)``).

``torch.nn.SyncBatchNorm`` is not used: it refuses CPU tensors, so gloo
ranks on the host could not run it, and it takes its statistics in one pass
(``batch_norm_stats`` / ``gather_stats_with_counts``), not JAX's two.
"""

from __future__ import annotations

import copy
import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class World(NamedTuple):
    """This process's place in the process group: rank 0 of 1 without one."""

    rank: int
    size: int
    backend: Optional[str]


def world() -> World:
    if not (dist.is_available() and dist.is_initialized()):
        return World(0, 1, None)
    return World(dist.get_rank(), dist.get_world_size(), dist.get_backend())


def init_distributed(device_type: str = "cuda", coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group and return the device this rank runs on.

    Without ``coordinator`` the rendezvous is torchrun's (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with it,
    ``coordinator`` is ``host:port`` (TCP) or an init-method URL
    (``tcp://...``, ``file://...``) and ``num_processes`` / ``process_id``
    give the world size and the rank.  A CUDA rank runs on
    ``cuda:LOCAL_RANK`` (torchrun's; else the rank modulo the cards
    visible), and becomes the current device.  ``backend`` defaults to
    NCCL for CUDA and gloo for the CPU; gloo ranks may share one card,
    which NCCL refuses."""
    if coordinator is None:
        missing = [k for k in _TORCHRUN_VARS if k not in os.environ]
        if missing:
            raise ValueError(f"a multi-process run needs a rendezvous: torchrun's "
                             f"{', '.join(missing)} are not set, and no --coordinator "
                             f"(with --num-processes and --process-id) was given")
        init_method = "env://"
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        rank, size = int(process_id), int(num_processes)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train on the host (gloo)")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"device type {device_type!r}: expected cuda or cpu")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            **extra)
    return device


def destroy_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(device: Optional[torch.device] = None) -> None:
    """Wait for every rank (a no-op without a group)."""
    if world().size > 1:
        if device is not None and device.type == "cuda" and world().backend == "nccl":
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()


def sync_batch_stats(x32: torch.Tensor, dims: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(mean, biased var, count) of ``x32`` over ``dims`` and over every
    rank's batch: the statistics JAX's ``jnp.mean`` / ``jnp.var`` take of a
    batch sharded on the mesh.  Two passes: the all-reduced sum gives the
    mean, then the all-reduced sum of squared deviations from it gives the
    variance.  The all-reduces are ``torch.distributed.nn.functional``'s,
    whose backward all-reduces the gradient, so every rank's input gets the
    gradient of the global statistics.  ``count`` (the global number of
    values a channel, for the unbiased running variance) assumes equal
    shards, which ``make_batch_iterator``'s ``drop_last`` gives.

    Without a process group, or in one of size 1, this is the local
    ``x32.mean(dims)``, ``x32.var(dims, unbiased=False)``."""
    dims = tuple(dims)
    n = math.prod(x32.shape[d] for d in dims)
    size = world().size
    if size == 1:
        return x32.mean(dim=dims), x32.var(dim=dims, unbiased=False), n
    from torch.distributed.nn.functional import all_reduce

    count = n * size
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal
    denom = torch.full((), count, dtype=x32.dtype, device=x32.device)
    mean = all_reduce(x32.sum(dim=dims)) / denom
    keep = [1 if d in dims else s for d, s in enumerate(x32.shape)]
    var = all_reduce(((x32 - mean.view(keep)) ** 2).sum(dim=dims)) / denom
    return mean, var, count


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor, in place, by its mean over the ranks: one flat
    all-reduce a dtype (a no-op at world size 1).  The train step averages
    its gradients and metrics with it."""
    size = world().size
    if size == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(size)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_mesh(n_devices: int = -1, device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """The first ``n_devices`` cards (-1: all) as a tuple of devices; raises
    without a card or when asked for more than are visible.  On the CPU,
    ``n_devices`` replicas of the host (one when -1)."""
    if device_type == "cpu":
        return (torch.device("cpu"),) * max(n_devices, 1)
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type=\"cpu\" to run "
                           "on the host")
    count = torch.cuda.device_count()
    n = count if n_devices <= 0 else n_devices
    if n > count:
        raise ValueError(f"a mesh of {n} cards: only {count} visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_batch(batch, n: int) -> List:
    """A numpy array or tensor split along its leading axis into ``n``
    equal shards (views); raises when the batch does not divide."""
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by the {n}-device mesh")
    step = b // n
    return [batch[i * step:(i + 1) * step] for i in range(n)]


def gather(parts: Sequence):
    """Shards put back together along the leading axis: numpy arrays on the
    host, tensors on the first shard's device."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return torch.cat([p.to(parts[0].device) for p in parts])


def replicate(model: torch.nn.Module, devices: Sequence[torch.device]) -> List[torch.nn.Module]:
    """A copy of ``model`` on each device.  A model whose BNs are folded
    (``LitePose.fold_bn_``) carries the folded weights into every copy
    unchanged, so each replica serves exactly the source's weights."""
    return [copy.deepcopy(model).to(torch.device(d)) for d in devices]
