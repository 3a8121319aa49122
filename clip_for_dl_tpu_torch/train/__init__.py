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
from .state import TrainState
from .steps import make_clip_eval_step, make_clip_pretrain_step

__all__ = [
    "DEFAULT_GROUP",
    "CosineSchedule",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "TrainState",
    "clip_by_global_norm_",
    "cosine_annealing_lr",
    "make_clip_eval_step",
    "make_clip_pretrain_step",
    "make_label_fn",
    "make_optimizer",
    "set_group_lrs",
    "warmup_scale",
]
