"""Train state (counterpart of ``clip_for_dl_tpu.train.state.TrainState``).

The JAX state is one immutable pytree (params, batch stats, optimizer
moments, step). Here the model holds its parameters and BatchNorm
statistics and the optimizer its moments, both updated in place by a step,
so the state is the pair of them and the step counter.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
