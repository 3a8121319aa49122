"""Expert parallelism of the MoE text tower over the ``expert`` axis of a
2-D layout (counterpart of ``clip_for_dl_tpu.parallel.ep``).

The rule is the JAX package's, keyed on the port's state-dict names: the
stacked expert weights ``wi/bi/wo/bo`` of a ``moe_mlp`` (``models/moe.py``)
shard along their leading [E, ...] dim; everything else, the router
included, stays replicated. The layout is ``parallel/common.py``'s
``(data, expert)`` grid with the expert axis innermost, as the JAX mesh
puts it: rank r is at data index r // ep and expert index r % ep.

- the batch shards over the data axis only: the ep ranks of a data slice
  hold the same rows (:func:`expert_parallel_step`, the CLI's feed), and
  the MoE layers route over the data group (``moe.routing``), so that
  every rank routes as the single-device layer routes the global batch;
- rank r holds experts (r % ep)·E/ep … and runs them on the tokens routed
  to them; the partial outputs are summed over the expert group before the
  gate (``models/moe.py``), which gives every rank the router's whole
  gradient and each expert its whole gradient on its data slice;
- the gradients are averaged over the data group only (the step built
  with :func:`~clip_for_dl_tpu_torch.parallel.tp.step_groups`: ``group``
  the data group), and the clip by global norm sums the expert shards'
  squares over the expert group (``train/optim.py``; the shards are marked
  with ``tp_spec`` as tensor parallelism marks its own);
- a checkpoint is written whole, in the unsharded layout
  (:class:`WholeCheckpoints`): every rank gathers its expert group's
  shards of the parameters, the AdamW moments and the EMA, and rank 0
  writes them.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .common import DATA_AXIS, Mesh2D, create_2d_mesh
from .dp import shard_batch
from .tp import REPLICATED, Spec, shard_tensor

EXPERT_AXIS = "expert"

_EXPERT = re.compile(r"(?:^|\.)moe_mlp\.(?:parametrizations\.)?(wi|bi|wo|bo)(?:\.original)?$")
_LEADING = Spec(0)


def create_dp_ep_mesh(ep: int, num_devices: Optional[int] = None) -> Mesh2D:
    """The 2-D ``(data, expert)`` layout, ``expert`` innermost."""
    return create_2d_mesh(ep, (DATA_AXIS, EXPERT_AXIS), num_devices)


def validate_ep(num_experts: int, ep: int) -> None:
    if ep < 1 or num_experts % ep:
        raise ValueError(f"ep={ep} must divide the expert count ({num_experts})")


def ep_spec(name: str) -> Spec:
    """Split along the leading [E, ...] dim for a MoE layer's stacked
    expert weight (by its state-dict name, a forward-cast parameter's
    ``...parametrizations.wi.original`` too); replicated elsewhere."""
    return _LEADING if _EXPERT.search(name) else REPLICATED


def _moe_layers(model) -> list:
    from ..models.moe import SwitchMoEMLP

    return [m for m in model.modules() if isinstance(m, SwitchMoEMLP)]


def shard_experts_(model, shard):
    """Every MoE layer of ``model`` cut to ``shard``'s experts in place (its
    expert weights marked with their ``tp_spec``, for the clip) and given
    ``shard``, a ``models.moe.ExpertShard`` (with no group: a rank's share
    to run alone, ``moe.moe_shares``); returns ``model``."""
    with torch.no_grad():
        for layer in _moe_layers(model):
            validate_ep(layer.num_experts, shard.size)
            for name, p in layer.named_parameters():
                if ep_spec("moe_mlp." + name).dim is not None:
                    p.data = shard_tensor(p.data, _LEADING, shard.rank, shard.size)
                    p.tp_spec = _LEADING
            layer.ep = shard
    return model


def _sharded(state):
    """[(parameter name, parameter)] of the expert shards of ``state``."""
    return [(n, p) for n, p in state.model.named_parameters() if ep_spec(n).dim is not None]


def _moments(state, p) -> dict:
    if state.optimizer is None:
        return {}
    return {k: v for k, v in state.optimizer.state.get(p, {}).items()
            if torch.is_tensor(v) and v.shape == p.shape}


def shard_state_ep(state, mesh: Mesh2D):
    """A ``TrainState`` sharded for this rank of the mesh's expert axis:
    its experts' parameters (:func:`shard_experts_` on the model, over the
    expert group), the AdamW moments and the EMA; returns ``state``."""
    from ..models.moe import ExpertShard

    ep, rank = mesh.model_size, mesh.model_index
    with torch.no_grad():
        for name, p in _sharded(state):
            for k, v in _moments(state, p).items():
                state.optimizer.state[p][k] = shard_tensor(v, _LEADING, rank, ep)
            if state.ema_params is not None:
                state.ema_params[name] = shard_tensor(state.ema_params[name], _LEADING, rank, ep)
    shard_experts_(state.model, ExpertShard(rank, ep, mesh.model_group))
    return state


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


@contextlib.contextmanager
def whole_state(state, mesh: Mesh2D):
    """Inside: every expert shard of ``state`` (parameters, AdamW moments,
    EMA) replaced by the whole tensor gathered over the expert group, on
    every rank of it (a collective); after: the shards back."""
    group = mesh.model_group
    if group is None or mesh.model_size == 1:
        yield state
        return
    kept = []
    with torch.no_grad():
        for name, p in _sharded(state):
            moments = _moments(state, p)
            ema = state.ema_params[name] if state.ema_params is not None else None
            kept.append((name, p, p.data, moments, ema))
            for k, v in moments.items():
                state.optimizer.state[p][k] = _gather(v, group)
            if ema is not None:
                state.ema_params[name] = _gather(ema, group)
            p.data = _gather(p.data, group)
    try:
        yield state
    finally:
        for name, p, data, moments, ema in kept:
            p.data = data
            for k, v in moments.items():
                state.optimizer.state[p][k] = v
            if ema is not None:
                state.ema_params[name] = ema


class WholeCheckpoints:
    """A ``CheckpointManager`` whose saves write the whole state of a
    sharded run (``whole``: :func:`whole_state` of expert parallelism, or
    ``pp.whole_state``), the layout an unsharded run writes and every
    command reads; every other call goes to the manager."""

    def __init__(self, manager, mesh: Mesh2D, whole: Callable = whole_state):
        self.manager, self.mesh, self.whole = manager, mesh, whole

    def save(self, epoch, state, *args, **kwargs):
        with self.whole(state, self.mesh):
            self.manager.save(epoch, state, *args, **kwargs)

    def save_preempt(self, epoch, state, *args, **kwargs):
        with self.whole(state, self.mesh):
            self.manager.save_preempt(epoch, state, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.manager, name)


def expert_parallel_step(step_fn: Callable, mesh: Mesh2D) -> Callable:
    """``step(state, batch, ...)`` on this rank's data slice of ``batch``
    (the JAX ``expert_parallel_step``: the batch sharded on ``data``,
    replicated over ``expert``). ``step_fn`` is built with
    ``tp.step_groups(mesh)`` over a state sharded by
    :func:`shard_state_ep`; its generator must be in lockstep on the ranks
    of a data slice (``Mesh2D.generator``)."""

    def wrapped(state, batch, *rest):
        if mesh.data_group is not None:
            batch = shard_batch(batch, mesh.data_group)
        return step_fn(state, batch, *rest)

    return wrapped
