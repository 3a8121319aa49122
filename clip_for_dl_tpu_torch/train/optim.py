"""Optimizer and schedules (counterpart of ``clip_for_dl_tpu.train.optim``).

The host-side pieces (``make_label_fn``, the per-epoch schedules and
``EarlyStopping``) are framework-neutral and copied unchanged from the JAX
module; ``tests/test_torch_train.py`` holds each copy equal to its original.

The update is ``torch.optim.AdamW`` with one parameter group per label, the
torch form of the JAX chain clip → Adam moments → decoupled weight decay →
per-group learning rate:

- :func:`make_optimizer` builds the groups from ``make_label_fn``; decay
  applies to every parameter with ``ndim > 0`` (the JAX mask, which spares
  0-dim calibration scalars);
- :func:`clip_by_global_norm_` is optax's ``clip_by_global_norm``:
  ``t / max(norm, max_norm) · max_norm`` with no epsilon (torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``);
- :func:`set_group_lrs` writes a host ``{group: lr}`` dict into the groups
  before a step, as the JAX step scales each update by its group's rate;
- ``moment_dtype=torch.bfloat16`` (the JAX ``base_transform``'s
  ``moment_dtype``, the CLI's ``--bf16-moments``) gives
  :class:`AdamWBf16FirstMoment`, optax's ``scale_by_adam(mu_dtype=bf16)``:
  torch's AdamW keeps ``exp_avg`` in the parameter's dtype;
- :func:`freeze_mask` is the JAX mask of trainable top-level modules.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

DEFAULT_GROUP = "default"


def make_label_fn(
    group_names: Sequence[str],
) -> Callable[[Tuple], str]:
    """Maps a param path to its group by top-level module name; unknown
    modules fall into DEFAULT_GROUP."""
    names = set(group_names)

    def label(path: Tuple) -> str:
        if path:
            key = getattr(path[0], "key", str(path[0]))
            if key in names:
                return key
        return DEFAULT_GROUP

    return label


class AdamWBf16FirstMoment(torch.optim.AdamW):
    """AdamW with the first moment ``exp_avg`` stored in bf16 and the second
    in fp32, as optax's ``scale_by_adam(mu_dtype=jnp.bfloat16)`` updates:

    - mu = (1 − b1)·g + b1·mu in fp32, where b1·mu is a bf16 product (JAX
      multiplies the stored bf16 moment by b1 rounded to bf16);
    - the step's update is mu / (1 − b1ᵗ) / (sqrt(nu / (1 − b2ᵗ)) + eps),
      from that fp32 mu;
    - mu is stored rounded to bf16 (to nearest even).

    Decoupled decay and the group's learning rate apply as in AdamW. The
    first moment takes half the bytes of AdamW's; a state dict loads back
    with it in bf16 (``Optimizer.load_state_dict`` casts it to the
    parameter's dtype, exactly, and it is rounded back, exactly)."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closure is not supported")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
            counts = [int(self.state[p]["step"]) for p in params]
            grads = [p.grad for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1_bf16))
            # nu = (1 - b2) g² + b2 nu
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            update = torch._foreach_div(mu, [1.0 - b1 ** t for t in counts])
            denom = torch._foreach_sqrt(torch._foreach_div(nus, [1.0 - b2 ** t for t in counts]))
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_mul_(params, 1.0 - group["lr"] * group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"])
            for m, m32 in zip(mus, mu):
                m.copy_(m32)
        return None

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)


def make_optimizer(
    model: nn.Module,
    label_fn: Callable[[Tuple], str],
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    moment_dtype: Optional[torch.dtype] = None,
) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters, one group per (label, decays): each
    group carries its ``label`` (``label_fn`` of the parameter's dotted name,
    split into a path); the learning rates come from :func:`set_group_lrs`.
    ``moment_dtype=torch.bfloat16`` stores the first moment in bf16
    (:class:`AdamWBf16FirstMoment`); None keeps ``torch.optim.AdamW``."""
    if moment_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"moment_dtype {moment_dtype} is not supported (bf16 or None)")
    groups: Dict[Tuple[str, bool], List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        key = (label_fn(tuple(name.split("."))), p.ndim > 0)
        groups.setdefault(key, []).append(p)
    kind = AdamWBf16FirstMoment if moment_dtype == torch.bfloat16 else torch.optim.AdamW
    return kind(
        [{"params": ps, "label": label, "weight_decay": weight_decay if decays else 0.0}
         for (label, decays), ps in groups.items()],
        lr=0.0, betas=(b1, b2), eps=eps,
    )


def freeze_mask(model: nn.Module, trainable: Sequence[str]) -> Dict[str, bool]:
    """Parameter name → True where its top-level module is in ``trainable``
    (the JAX ``freeze_mask``; the adapter phase trains only ``adapter``)."""
    allowed = set(trainable)
    return {name: name.split(".")[0] in allowed for name, _ in model.named_parameters()}


def set_group_lrs(optimizer: torch.optim.Optimizer, lrs: Mapping[str, float]) -> None:
    """group lr ← lrs[group label] (a missing label raises KeyError, as the
    JAX ``apply_group_lrs`` does)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lrs[group["label"]])


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                         model_group=None) -> torch.Tensor:
    """Scale the gradients of ``params`` in place as optax's
    ``clip_by_global_norm`` does; returns the global norm (a device tensor,
    so no host sync). Every parameter must have a gradient. With
    ``model_group`` (tensor parallelism) the squares of the sharded
    parameters' gradients (those ``parallel.tp`` marked with ``tp_spec``)
    are summed over the group, each replicated one counted once."""
    params = list(params)
    grads = [p.grad for p in params]
    if model_group is not None:
        norms = torch._foreach_norm(grads)
        sharded = [n for p, n in zip(params, norms) if getattr(p, "tp_spec", None)]
        rest = [n for p, n in zip(params, norms) if not getattr(p, "tp_spec", None)]
        sq = grads[0].new_zeros((), dtype=torch.float32)
        if sharded:
            sq = torch.stack(sharded).float().square().sum()
        torch.distributed.all_reduce(sq, group=model_group)
        if rest:
            sq = sq + torch.stack(rest).float().square().sum()
        norm = sq.sqrt()
    else:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_div_(grads, torch.clamp_min(norm, max_norm))
    torch._foreach_mul_(grads, max_norm)
    return norm


# ---------------------------------------------------------------------------
# host-side per-epoch schedules
# ---------------------------------------------------------------------------


def cosine_annealing_lr(
    epoch: int, base_lr: float, t_max: int, eta_min: float = 0.0
) -> float:
    """torch CosineAnnealingLR closed form (stepped per epoch)."""
    return eta_min + (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * epoch / t_max)
    ) / 2.0


def warmup_scale(step: int, warmup_steps: int) -> float:
    """Linear warmup multiplier over the first `warmup_steps` steps."""
    if warmup_steps <= 0:
        return 1.0
    return min(1.0, (step + 1) / warmup_steps)


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau (mode=min) over a {group: lr} dict."""

    def __init__(
        self,
        lrs: Dict[str, float],
        factor: float = 0.8,
        patience: int = 1,
        min_lr: float = 0.0,
    ):
        self.lrs = dict(lrs)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> Dict[str, float]:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lrs = {
                    k: max(v * self.factor, self.min_lr)
                    for k, v in self.lrs.items()
                }
                self.num_bad = 0
        return dict(self.lrs)


class CosineSchedule:
    """Per-epoch cosine over a {group: lr} dict (CosineAnnealingLR)."""

    def __init__(self, lrs: Dict[str, float], t_max: int, eta_min: float = 0.0):
        self.base = dict(lrs)
        self.t_max = t_max
        self.eta_min = eta_min

    def at_epoch(self, epoch: int) -> Dict[str, float]:
        return {
            k: cosine_annealing_lr(epoch, v, self.t_max, self.eta_min)
            for k, v in self.base.items()
        }


class EarlyStopping:
    """Patience-based early stop on a min-metric (0425/train.py:700-720)."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.num_bad = 0
        self.should_stop = False

    def step(self, metric: float) -> bool:
        if metric < self.best - self.min_delta:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad >= self.patience:
                self.should_stop = True
        return self.should_stop
