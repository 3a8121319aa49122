"""Structured metric logging (copy of ``clip_for_dl_tpu.evals.writer``).

Metrics flow through one writer with three sinks: stdlib logging, an
append-only JSONL stream (machine-readable, crash-safe) and, when
``torch.utils.tensorboard`` imports, a TensorBoard writer. The module is
framework-neutral, so it is copied unchanged but for its logger's name;
``tests/test_torch_phase_b.py`` holds the copy equal by source text.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Mapping

logger = logging.getLogger("clip_for_dl_tpu_torch.metrics")


class MetricWriter:
    def __init__(self, log_dir: str, run_name: str = "run"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{run_name}_metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a", buffering=1)
        self._tb = self._try_tensorboard(log_dir, run_name)

    @staticmethod
    def _try_tensorboard(log_dir: str, run_name: str):
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            return SummaryWriter(os.path.join(log_dir, "tb", run_name))
        except Exception:
            return None

    def write(self, step: int, metrics: Mapping[str, Any],
              prefix: str = "") -> None:
        flat: Dict[str, float] = {}
        for k, v in metrics.items():
            try:
                flat[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        record = {"step": int(step), "time": time.time(), **flat}
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)
        logger.info(
            "step %d %s", step,
            " ".join(f"{k}={v:.5g}" for k, v in flat.items()),
        )

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def read_jsonl(path: str) -> list[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
