"""Collectives with gradients, over a ``torch.distributed`` process group.

The JAX package gets these from its mesh: ``lax.all_gather`` transposes to
a reduce-scatter, ``lax.psum`` to a psum, ``lax.ppermute`` to the reverse
permutation. Here each is an ``autograd.Function`` written out:

- :func:`all_gather_rows` concatenates every rank's rows in rank order; its
  backward sums the incoming gradients over the ranks and keeps this rank's
  rows (a reduce-scatter, written as an all-reduce and a slice so that gloo,
  which has no reduce-scatter, runs it too);
- :func:`all_reduce_sum` sums over the ranks, and so does its backward;
- :func:`ring_shift` sends a block to the next rank and receives the
  previous rank's; its backward sends each gradient back the way the block
  came;
- the Megatron pair of tensor parallelism: :func:`copy_to_model` is the
  identity forward and an all-reduce backward (at a column-parallel input:
  each rank's branch hands back a partial input gradient);
  :func:`reduce_from_model` is an all-reduce forward and the identity
  backward (after a row-parallel output: the partial products summed);
- :func:`all_gather_dim` concatenates every rank's block along a dim, the
  sequence's under sequence parallelism (its backward: the sum, then this
  rank's block).

On a group of one rank every collective here is the identity.

Gradient scale: a loss that every rank computes identically from gathered
features hands each rank N times the gradient of its own rows (the sum of N
identical contributions); the data-parallel step's average of the gradients
(``dp.all_reduce_grads_``) brings that back to the loss's gradient. A
gradient that reaches a parameter directly (a learnable temperature) is the
same on every rank, and the average keeps it. The two meet in one average,
as they do in the JAX package's single program over the mesh.

``group=None`` is the default group (``dist.group.WORLD``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(world(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = g.shape[0] // world(ctx.group)
        r = rank(ctx.group)
        return g[r * n:(r + 1) * n], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """x sent to rank r + step, the block of rank r − step received."""
    n, r = world(group), rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _group(group):
    return dist.group.WORLD if group is None else group


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[b, ...] on each rank → [N·b, ...], rank-major (``lax.all_gather``
    with ``tiled=True``)."""
    return _GatherRows.apply(x, _group(group))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks (``lax.psum``)."""
    return _AllReduceSum.apply(x, _group(group))


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks (``lax.pmean``)."""
    return all_reduce_sum(x, group) / world(_group(group))


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's block to rank r + 1 (``lax.ppermute`` one step round the
    ring); identity on one rank."""
    group = _group(group)
    if world(group) == 1:
        return x
    return _RingShift.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient all-reduced over ``group`` (Megatron's f)."""
    if group is None or world(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` forward, identity backward (Megatron's g)."""
    if group is None or world(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated along ``dim`` in rank order
    (contiguous, as the kernels take their operands)."""
    if group is None or world(group) == 1:
        return x
    return all_gather_rows(x.movedim(dim, 0), group).movedim(0, dim).contiguous()
