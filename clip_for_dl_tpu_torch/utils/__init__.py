from .debug import (
    FaultInjector,
    assert_finite,
    count_params,
    debug_mode,
    deterministic_run,
    validate_batch,
)
from .profiling import (
    FencedTimer,
    StepTimer,
    annotate,
    device_memory_stats,
    fence,
    throughput,
    trace,
)
from .visualization import save_predictions_csv

__all__ = [
    "FaultInjector",
    "assert_finite",
    "count_params",
    "debug_mode",
    "deterministic_run",
    "validate_batch",
    "FencedTimer",
    "StepTimer",
    "annotate",
    "device_memory_stats",
    "fence",
    "throughput",
    "trace",
    "save_predictions_csv",
]
