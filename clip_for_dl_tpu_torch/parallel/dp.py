"""Data parallelism over a process group (counterpart of
``clip_for_dl_tpu.parallel.dp`` and ``core.mesh.create_mesh``).

The JAX package jits one step over a batch-sharded mesh, so an N-device step
*is* the single-device step on the global batch. Here each rank runs the
step on its slice, and every batch-level reduction is made global by hand:

- the state is replicated: :func:`replicate_state` broadcasts rank 0's
  parameters, buffers and EMA once;
- the batch is sharded: :func:`shard_batch` gives rank r the contiguous rows
  r·b … (r + 1)·b of the global batch, as the mesh shards it (with
  ``microbatches=A``, rank r's share of each of the A global microbatches);
- the steps (``train/steps.py``, ``train/accum.py``, built with ``group``)
  take BatchNorm statistics and the contrastive losses over the global
  batch, and average the gradients with :func:`all_reduce_grads_` between
  the backward and the clip, so that the clip sees the global gradient;
- :func:`data_parallel_step` shards the batch argument and calls the step.

:func:`check_devices` is ``create_mesh``'s refusal of a mesh larger than
the devices in sight, with its message.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .collectives import _group


def check_devices(num_devices: int, visible: int) -> None:
    if visible < num_devices:
        raise ValueError(f"requested a {num_devices}-device mesh but only "
                         f"{visible} devices are visible")


def _buckets(tensors: Iterable[torch.Tensor]):
    """Tensors grouped by (device, dtype), each group in its given order."""
    out = {}
    for t in tensors:
        out.setdefault((t.device, t.dtype), []).append(t)
    return out.values()


@torch.no_grad()
def _broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        dist.broadcast(flat, dist.get_global_rank(group, src), group=group)
        for t, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(v)


def replicate_state(state, group=None):
    """Rank 0's parameters, buffers (BatchNorm statistics), EMA and step on
    every rank; returns ``state``. Optimizer moments are not sent: they are
    empty before the first step, and a restore reads the same file on every
    rank."""
    group = _group(group)
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    if state.ema_params is not None:
        tensors += list(state.ema_params.values())
    _broadcast_([t.data for t in tensors], group)
    step = [state.step]
    dist.broadcast_object_list(step, dist.get_global_rank(group, 0), group=group)
    state.step = step[0]
    return state


@torch.no_grad()
def all_reduce_grads_(params: Sequence[torch.Tensor], group=None) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, one
    all-reduce per (device, dtype) of the flattened gradients."""
    group = _group(group)
    n = dist.get_world_size(group)
    for bucket in _buckets([p.grad for p in params]):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for g, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(v)


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """A rank's mean over its equal share of the rows → the mean over every
    rank's rows (without gradient: metrics)."""
    group = _group(group)
    x = x.detach().float().clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def shard_rows(x, rank: int, world: int, microbatches: int = 1):
    """Rank ``rank``'s rows of ``x`` (an array or a tensor; None stays None):
    contiguous, or with ``microbatches=A`` its contiguous share of each
    global microbatch."""
    if x is None or world == 1 and microbatches == 1:
        return x
    n = len(x)
    if n % (world * microbatches):
        raise ValueError(f"a batch of {n} rows does not divide over {world} ranks"
                         + (f" x {microbatches} microbatches" if microbatches > 1 else ""))
    m = n // (world * microbatches)
    if microbatches == 1:
        return x[rank * m:(rank + 1) * m]
    rest = tuple(x.shape[1:])
    return x.reshape((microbatches, world, m) + rest)[:, rank].reshape((microbatches * m,) + rest)


def rows_over_group(fn: Callable, rows: torch.Tensor, group) -> torch.Tensor:
    """``fn`` on this rank's contiguous slice of ``rows`` (zero rows appended
    up to a multiple of the ranks), every rank's output gathered in rank
    order, the padding's included: an inference engine's batch over a
    group."""
    from .collectives import all_gather_rows

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    pad = -rows.shape[0] % world
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, *rows.shape[1:]))])
    with torch.inference_mode():
        return all_gather_rows(fn(shard_rows(rows, rank, world)), group)


def shard_batch(batch: Mapping, group=None, microbatches: int = 1) -> dict:
    """This rank's slice of every entry of ``batch``."""
    group = _group(group)
    r, n = dist.get_rank(group), dist.get_world_size(group)
    return {k: shard_rows(v, r, n, microbatches) for k, v in batch.items()}


def data_parallel_step(step_fn: Callable, group=None, microbatches: int = 1) -> Callable:
    """``step(state, batch, ...)`` on this rank's slice of ``batch``: the
    JAX ``data_parallel_step``. ``step_fn`` is a step built with ``group``
    (global statistics, losses and gradients); ``microbatches`` is an
    accumulating step's ``accum_steps``."""

    def wrapped(state, batch, *rest):
        return step_fn(state, shard_batch(batch, group, microbatches), *rest)

    return wrapped

