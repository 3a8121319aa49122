from .driver import run_dynamic_threshold_eval, run_zero_shot_eval
from .engine import ZeroShotEngine, encode_prompt_bank
from .predict import (
    adjust_predictions_by_cooccurrence,
    frequency_thresholds,
    sigmoid_predictions,
    softmax_topk_predictions,
    unique_problem_labels,
)
from .prompts import prompts_for_family
from .thresholds import search_thresholds

__all__ = [
    "ZeroShotEngine",
    "encode_prompt_bank",
    "run_dynamic_threshold_eval",
    "run_zero_shot_eval",
    "search_thresholds",
    "adjust_predictions_by_cooccurrence",
    "frequency_thresholds",
    "sigmoid_predictions",
    "softmax_topk_predictions",
    "unique_problem_labels",
    "prompts_for_family",
]
