"""Model-FLOPs utilization for benchmarks (counterpart of
``clip_for_dl_tpu.utils.mfu``).

The FLOP count is PyTorch's own: ``torch.utils.flop_counter.FlopCounterMode``
over one call of the callable (matrix products and convolutions, 2·M·N·K
for a product, as XLA's ``cost_analysis`` counts a dot). The peak is
NVIDIA's published dense bf16 rate of the card, from the table below; a
card missing from it gives no utilization.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# dense bf16 peak TFLOP/s by torch.cuda.get_device_name (NVIDIA's data
# sheets; sparsity excluded); the H100 SXM's at its 700 W limit
_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_tflops(device: Optional[int] = None) -> Optional[float]:
    """Published bf16 peak of the card, or None (no card, or one missing
    from the table)."""
    if not torch.cuda.is_available():
        return None
    return _PEAK_TFLOPS.get(torch.cuda.get_device_name(device))


def compiled_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)`` (the call runs), or None
    when it counts none."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def mfu_fields(flops: Optional[float], items_per_call: int, calls_per_sec: float) -> dict:
    """JSON-ready dict from one call's FLOPs (``compiled_flops``):
    gflops_per_item, tflops_per_sec and mfu_pct, the JAX keys (empty when
    there is no count, no mfu_pct without a published peak)."""
    out: dict = {}
    if flops is None:
        return out
    out["gflops_per_item"] = round(flops / items_per_call / 1e9, 2)
    achieved = flops * calls_per_sec / 1e12
    out["tflops_per_sec"] = round(achieved, 1)
    peak = peak_tflops()
    if peak:
        out["mfu_pct"] = round(100.0 * achieved / peak, 1)
    return out
