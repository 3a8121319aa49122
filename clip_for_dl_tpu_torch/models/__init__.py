from .clip import CXRClip, init_weights
from .convert import fold_clip_image_tower, lora_from_jax, state_dict_from_jax
from .lora import (
    DEFAULT_TARGETS,
    LoRA,
    fold_lora,
    init_lora,
    lora_param_count,
    lora_paths,
    make_lora_eval_step,
    make_lora_pretrain_step,
    merge_lora,
)

__all__ = ["CXRClip", "DEFAULT_TARGETS", "LoRA", "fold_clip_image_tower", "fold_lora",
           "init_lora", "init_weights", "lora_from_jax", "lora_param_count", "lora_paths",
           "make_lora_eval_step", "make_lora_pretrain_step", "merge_lora", "state_dict_from_jax"]
