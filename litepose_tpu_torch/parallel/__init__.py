"""Data parallelism across devices and processes (counterpart of
``litepose_tpu/parallel``)."""

from .mesh import (
    World,
    all_reduce_mean_,
    barrier,
    destroy_distributed,
    gather,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    sync_batch_stats,
    world,
)

__all__ = [
    "World",
    "all_reduce_mean_",
    "barrier",
    "destroy_distributed",
    "gather",
    "init_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
    "sync_batch_stats",
    "world",
]
