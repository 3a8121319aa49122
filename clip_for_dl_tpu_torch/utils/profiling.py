"""Tracing and timing (counterpart of ``clip_for_dl_tpu.utils.profiling``):

- ``trace`` / ``annotate``: a torch.profiler trace (CPU, and the card's
  kernels where there is one) written under ``log_dir`` in TensorBoard's
  layout, and named regions that show on its timeline;
- ``fence``: wait for the devices of every tensor in a tree (CUDA work is
  queued, so a host clock without it measures the enqueue);
- ``FencedTimer``, ``throughput``, ``StepTimer``: fenced wall-clock timing,
  rates, and the training loop's rolling step time;
- ``device_memory_stats``: each card's allocator statistics, under the JAX
  key names where one maps.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from .debug import _with_paths

# torch.cuda.memory_stats key -> the JAX (PJRT) memory_stats name
_JAX_MEMORY_KEYS = {
    "allocated_bytes.all.current": "bytes_in_use",
    "allocated_bytes.all.peak": "peak_bytes_in_use",
    "reserved_bytes.all.current": "bytes_reserved",
    "reserved_bytes.all.peak": "peak_bytes_reserved",
    "allocation.all.allocated": "num_allocs",
}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a profiler trace of the enclosed region into ``log_dir``
    (``<worker>.<time>.pt.trace.json``, which TensorBoard reads)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def annotate(name: str):
    """Named region on the profiler's timeline (use as context manager)."""
    return torch.profiler.record_function(name)


def fence(tree: Any) -> Any:
    """Wait until the work producing every tensor of the tree (dicts, lists,
    tuples) is done on its device; returns the tree."""
    devices = {x.device for _, x in _with_paths(tree)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class FencedTimer:
    """with FencedTimer() as t: ... ; t.seconds — fenced on the result's
    devices."""

    def __init__(self, result: Any = None):
        self._result = result
        self.seconds: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set_result(self, result: Any) -> None:
        self._result = result

    def __exit__(self, *exc):
        if self._result is not None:
            fence(self._result)
        self.seconds = time.perf_counter() - self._t0
        return False


def throughput(n_items: int, seconds: float) -> float:
    return n_items / max(seconds, 1e-12)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card allocator statistics (``cuda:<i>`` → name → int), under the
    JAX names where one maps (bytes_in_use, peak_bytes_in_use, ...), with
    ``bytes_limit`` the card's memory; empty without a card, as JAX's CPU
    devices report none."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = {_JAX_MEMORY_KEYS.get(k, k): int(v)
                 for k, v in torch.cuda.memory_stats(i).items()
                 if isinstance(v, (int, np.integer))}
        stats["bytes_limit"] = int(torch.cuda.get_device_properties(i).total_memory)
        out[f"cuda:{i}"] = stats
    return out


class StepTimer:
    """Rolling steps/sec + items/sec for the training loop (the batch_time /
    data_time AverageMeter pair; fence the step before ``tick``)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def items_per_sec(self, batch_size: int) -> float:
        s = self.mean_step_seconds
        return batch_size / s if s and np.isfinite(s) else float("nan")
