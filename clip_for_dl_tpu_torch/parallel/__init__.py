"""Data parallelism over ``torch.distributed`` (counterpart of
``clip_for_dl_tpu.parallel``, its data-parallel half; tensor, sequence,
pipeline and expert parallelism are ROADMAP A7b)."""

from .dp import (
    all_reduce_grads_,
    check_devices,
    data_parallel_step,
    global_mean,
    replicate_state,
    shard_batch,
    shard_rows,
)

__all__ = [
    "all_reduce_grads_",
    "check_devices",
    "data_parallel_step",
    "global_mean",
    "replicate_state",
    "shard_batch",
    "shard_rows",
]
