"""Data, tensor, sequence and expert parallelism over ``torch.distributed``
(counterpart of ``clip_for_dl_tpu.parallel``; pipeline parallelism is
ROADMAP A7b)."""

from .common import MODEL_AXIS, create_2d_mesh
from .dp import (
    all_reduce_grads_,
    check_devices,
    data_parallel_step,
    global_mean,
    replicate_state,
    shard_batch,
    shard_rows,
)
from .ep import (
    EXPERT_AXIS,
    WholeCheckpoints,
    create_dp_ep_mesh,
    ep_spec,
    expert_parallel_step,
    shard_state_ep,
    validate_ep,
)
from .sp import sequence_sharded_fn
from .tp import (
    create_dp_tp_mesh,
    shard_state_tp,
    step_groups,
    tensor_parallel_,
    tensor_parallel_step,
    tp_spec,
    validate_tp,
)

__all__ = [
    "EXPERT_AXIS",
    "WholeCheckpoints",
    "create_dp_ep_mesh",
    "ep_spec",
    "expert_parallel_step",
    "shard_state_ep",
    "validate_ep",
    "all_reduce_grads_",
    "check_devices",
    "data_parallel_step",
    "global_mean",
    "replicate_state",
    "shard_batch",
    "shard_rows",
    "MODEL_AXIS",
    "create_2d_mesh",
    "create_dp_tp_mesh",
    "sequence_sharded_fn",
    "shard_state_tp",
    "step_groups",
    "tensor_parallel_",
    "tensor_parallel_step",
    "tp_spec",
    "validate_tp",
]
