from .checkpoint import CheckpointManager, import_reference_checkpoint
from .loop import History, fit, resume_or_init, run_epoch, run_eval
from .optim import (
    DEFAULT_GROUP,
    CosineSchedule,
    EarlyStopping,
    ReduceLROnPlateau,
    clip_by_global_norm_,
    cosine_annealing_lr,
    make_label_fn,
    make_optimizer,
    set_group_lrs,
    warmup_scale,
)
from .preemption import PreemptionGuard
from .state import TrainState
from .steps import (
    make_adapter_eval_step,
    make_adapter_train_step,
    make_clip_eval_step,
    make_clip_pretrain_step,
    make_shared_adapter_eval_step,
    make_shared_adapter_train_step,
)

__all__ = [
    "CheckpointManager",
    "import_reference_checkpoint",
    "History",
    "fit",
    "resume_or_init",
    "run_epoch",
    "run_eval",
    "PreemptionGuard",
    "DEFAULT_GROUP",
    "CosineSchedule",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "TrainState",
    "clip_by_global_norm_",
    "cosine_annealing_lr",
    "make_adapter_eval_step",
    "make_adapter_train_step",
    "make_clip_eval_step",
    "make_clip_pretrain_step",
    "make_label_fn",
    "make_optimizer",
    "make_shared_adapter_eval_step",
    "make_shared_adapter_train_step",
    "set_group_lrs",
    "warmup_scale",
]
