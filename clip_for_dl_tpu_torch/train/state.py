"""Train state (counterpart of ``clip_for_dl_tpu.train.state.TrainState``).

The JAX state is one immutable pytree (params, batch stats, optimizer
moments, step, the optional EMA of the params). Here the model holds its
parameters and BatchNorm statistics and the optimizer its moments, both
updated in place by a step, so the state is the pair of them, the step
counter and the optional EMA: fp32 copies of the parameters, keyed by
``model.named_parameters()`` names, taken when the state is created
(:meth:`TrainState.create`) and moved by the pretrain step's
``ema_decay``. The EMA covers parameters only; the BatchNorm statistics
stay live, as in the JAX ``to_variables``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               ema: bool = False) -> "TrainState":
        ema_params = None
        if ema:
            ema_params = {n: p.detach().to(torch.float32, copy=True)
                          for n, p in model.named_parameters()}
        return cls(model, optimizer, 0, ema_params)

    def to_variables(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The parameters to run the model with, by ``named_parameters``
        name: the EMA's with ``use_ema``, else the live ones (for
        ``torch.func.functional_call``, which leaves the buffers live)."""
        if not use_ema:
            return dict(self.model.named_parameters())
        if self.ema_params is None:
            raise ValueError("state has no EMA params (train with ema)")
        return self.ema_params
