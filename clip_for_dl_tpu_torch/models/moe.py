"""Switch-Transformer mixture-of-experts MLP (counterpart of
``clip_for_dl_tpu.models.moe.SwitchMoEMLP``).

Top-1 routing with a fixed capacity per expert. The router (a Dense in
fp32, then a softmax) gives each token its expert e = argmax p (ties to the
first index) and its gate max p. A real token takes position k in e's
queue, k counting the real tokens routed to e before it in row order, and
is dropped when k ≥ C = ceil(f · T / E), with T counting every token of the
batch, pads included. A dropped token gets a zero update, so only the
block's residual passes it. Pads (mask 0, read off the attention bias by
the BERT layer) take no slot, get a zero update and stay out of the
load-balancing loss E · Σ_e density_e · proxy_e (Switch eq. 4).

The JAX layer writes this as dense einsums over one-hot dispatch and
combine tensors [T, E, C]. Each of their sums has exactly one nonzero term,
so indexing gives the same values without those tensors (at B = 128 reports
of 200 tokens and E = 8, each would hold 819 M entries):

- ``slot`` = e·C + k for a kept token, E·C (a spill row) for a dropped or
  padding token;
- dispatch: each token's row added at its slot into [E·C + 1, D] (one
  token a slot, so the sum is the row);
- the experts' FFN as one batched product over the [E, C, D] slots,
  gelu(x W_i + b_i) W_o + b_o: the products take compute-dtype operands
  and give fp32 outputs (the JAX ``preferred_element_type``), the biases
  and the exact GELU run in fp32, and the hidden is cast to the compute
  dtype between the products; their backward rounds the fp32 cotangent to
  the compute dtype and keeps fp32 outputs (on the CPU and in fp32, plain
  fp32 products). Each expert's slice of a batched product, and of the
  biases' gradients, is computed alike however many experts the batch
  holds, so the ep shares below keep the unsharded layer's bits;
- combine: gate · y[slot] in fp32 (the spill row is zero), cast to the
  compute dtype.

State-dict names below a layer's ``moe_mlp``, the port's own:
``router.weight`` [E, D] and ``router.bias`` [E] (the JAX router's kernel
transposed, its bias), and ``wi`` [E, D, F], ``bi`` [E, F], ``wo`` [E, F, D],
``bo`` [E, D] in the JAX layout. The router and the biases stay fp32 in every
mode (``fp32_params``); ``wi`` and ``wo`` run in the compute dtype
(``compute_dtype_params``, ``core/device.py``).

**Routing over the global batch.** The JAX steps jit over a mesh, so a MoE
layer there routes over the global batch. Inside :func:`routing` with a
process group, each rank's layer routes its rows as the single-device layer
routes the group's global batch (the ranks' rows in rank order): C comes
from T · ranks, rank r's queue positions for expert e start after the
Σ_{r' < r} count_{r'}[e] real tokens that earlier ranks routed to e (the
per-expert counts are all-gathered), and the density and proxy sums are
``parallel/collectives.py all_reduce_sum``s. The aux loss is then the same
on every rank, and its gradient follows the convention of
``losses/global_batch.py``: each rank gets N times its own rows' share, and
the step's average over the ranks brings it back. No activation crosses
ranks.

**The aux loss** is handed to the caller, not sown: :func:`routing` yields a
list to which every MoE layer called inside appends its aux loss (a 0-dim
fp32 tensor), in call order. The pretrain and multi-view steps add
``moe_aux_weight`` × their sum to the loss, as the JAX steps add the sown
``losses`` collection. Outside :func:`routing` a layer routes its own batch
and its aux loss is dropped.

**Expert parallelism** (``parallel/ep.py``): a layer whose ``ep`` is an
:class:`ExpertShard` of size ep holds experts rank·E/ep … of the E (its
``wi/bi/wo/bo`` sliced along the first dim). Every rank of an expert group
holds the same rows and routes them identically (the router is
replicated); a rank runs only its experts, on the tokens routed to them,
and the partial outputs (zero rows elsewhere) are summed over the expert
group before the gate multiplies them. The gate after the sum gives every
rank the router's whole gradient; the input enters the experts through
``copy_to_model``, whose backward sums the partial input gradients.
:func:`moe_shares` runs every rank's share in one process, summing the
partial outputs there: each token has one contributor, so the sum is the
unsharded layer's bits.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum, copy_to_model, reduce_from_model
from .remat import recomputing


def capacity(tokens: int, experts: int, factor: float) -> int:
    """C = ceil(f · T / E), in float64 as the JAX layer computes it."""
    return int(math.ceil(factor * tokens / experts))


@dataclass(frozen=True)
class ExpertShard:
    """A MoE layer's place on the ``expert`` axis: it holds experts
    rank·E/size … of the E, and its partial outputs are summed over
    ``group`` (no group: a share run alone, :func:`moe_shares` sums)."""

    rank: int = 0
    size: int = 1
    group: Optional[object] = None


ALL_EXPERTS = ExpertShard()

# (the group the layers route over or None, the list collecting aux losses
# or None) of the innermost ``routing`` block
_ROUTING = contextvars.ContextVar("moe_routing", default=(None, None))


@contextlib.contextmanager
def routing(group=None):
    """The MoE layers called inside route over ``group``'s global batch (a
    group of one rank, or None: this process's batch) and append their aux
    losses to the list this yields."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    aux: List[torch.Tensor] = []
    token = _ROUTING.set((group, aux))
    try:
        yield aux
    finally:
        _ROUTING.reset(token)


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the leading (expert) dim with an fp32 output: on the card
    16-bit operands go to the tensor cores as they are; elsewhere the
    operands are widened."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _ExpertMatmul(torch.autograd.Function):
    """a @ b of compute-dtype operands [E, M, K] and [E, K, N], fp32 out (the
    JAX einsum's ``preferred_element_type``); the backward's products round
    the fp32 cotangent to the operands' dtype and cast their fp32 outputs
    back."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _bmm32(g.to(b.dtype), b.transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _bmm32(a.transpose(1, 2), g.to(a.dtype)).to(b.dtype)
        return ga, gb


class _ExpertBias(torch.autograd.Function):
    """y + b per expert, y [E, C, N] fp32, b [E, N] fp32; b's gradient is
    summed expert by expert over its [C, N] block, so its bits do not
    depend on how many experts the layer holds (one reduction over [E, C,
    N] lays its sums out by E)."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b[:, None]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return g, torch.stack([ge.sum(0) for ge in g])


class SwitchMoEMLP(nn.Module):
    """Top-1-routed expert FFN in place of a BERT layer's dense MLP:
    ``forward(x [B, L, D], mask [B, L] or None) -> [B, L, D]``."""

    compute_dtype_params = ("wi", "wo")
    fp32_params = ("router.weight", "router.bias")
    ep = ALL_EXPERTS  # its ExpertShard (parallel/ep.py)

    def __init__(self, hidden: int, intermediate: int, num_experts: int,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.router = nn.Linear(hidden, num_experts)
        self.wi = nn.Parameter(torch.empty(num_experts, hidden, intermediate))
        self.bi = nn.Parameter(torch.zeros(num_experts, intermediate))
        self.wo = nn.Parameter(torch.empty(num_experts, intermediate, hidden))
        self.bo = nn.Parameter(torch.zeros(num_experts, hidden))
        nn.init.normal_(self.wi, std=0.02)
        nn.init.normal_(self.wo, std=0.02)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return moe_shares([self], x, mask)

    def experts(self, xf: torch.Tensor, slot: torch.Tensor, cap: int) -> torch.Tensor:
        """This layer's experts on the tokens routed to them: [T, D] fp32
        before the gate, zero rows for the other tokens; summed over the
        expert group when the layer has one."""
        e_loc, d = self.wi.shape[0], xf.shape[1]
        local = slot - self.ep.rank * e_loc * cap
        local = torch.where((local >= 0) & (local < e_loc * cap), local, e_loc * cap)
        xin = copy_to_model(xf, self.ep.group)
        xe = xin.new_zeros(e_loc * cap + 1, d).index_add(0, local, xin)
        xe = xe[:-1].view(e_loc, cap, d)
        h = _ExpertBias.apply(_ExpertMatmul.apply(xe, self.wi.to(xf.dtype)), self.bi.float())
        h = F.gelu(h).to(xf.dtype)
        y = _ExpertBias.apply(_ExpertMatmul.apply(h, self.wo.to(xf.dtype)), self.bo.float())
        y = torch.cat([y.view(e_loc * cap, d), y.new_zeros(1, d)])
        return reduce_from_model(y[local], self.ep.group)


class Routing(NamedTuple):
    """One batch's routing: each token's expert, gate and slot (e·C + k,
    or E·C where it is dropped or a pad), the capacity C, the aux loss."""

    expert: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    capacity: int
    aux: torch.Tensor


def route(layer: SwitchMoEMLP, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
          group=None) -> Routing:
    """``layer``'s routing of ``x`` [B, L, D] (``mask`` [B, L], 1 for a real
    token), over ``group``'s global batch when one is given."""
    b, l, d = x.shape
    t, e = b * l, layer.num_experts
    world = 1 if group is None else dist.get_world_size(group)
    cap = capacity(t * world, e, layer.capacity_factor)
    real = (torch.ones(t, dtype=torch.bool, device=x.device) if mask is None
            else mask.reshape(t) > 0)
    probs = torch.softmax(layer.router(x.reshape(t, d).float()), dim=-1)  # [T, E] fp32
    chosen = probs.argmax(-1)
    onehot = F.one_hot(chosen, e) * real[:, None]  # int64; pad rows all zero
    counts = onehot.sum(0)
    m = real.float()
    stats = torch.cat([counts.float(), (probs * m[:, None]).sum(0), m.sum()[None]])
    offset = torch.zeros_like(counts)
    if group is not None:
        stats = all_reduce_sum(stats, group)
        every = [torch.empty_like(counts) for _ in range(world)]
        dist.all_gather(every, counts, group=group)
        r = dist.get_rank(group)
        if r:
            offset = torch.stack(every[:r]).sum(0)
    denom = stats[2 * e].clamp_min(1.0)
    aux = e * torch.sum((stats[:e] / denom) * (stats[e:2 * e] / denom))
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1 + offset[chosen]
    slot = torch.where(real & (pos < cap), chosen * cap + pos, e * cap)
    return Routing(chosen, probs.amax(-1), slot, cap, aux)


def moe_shares(shares: Sequence[SwitchMoEMLP], x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoE layer over ``shares``: [the layer] (over its expert group
    under expert parallelism), or every rank's share (each sharded with no
    group) in one process, their partial outputs summed here. Routes over
    the group of the enclosing :func:`routing`, and appends the aux loss to
    its list."""
    group, aux_list = _ROUTING.get()
    b, l, d = x.shape
    r = route(shares[0], x, mask, group)
    # a remat'd layer's recompute routes as its forward did and adds no aux loss
    if aux_list is not None and not recomputing():
        aux_list.append(r.aux)
    xf = x.reshape(b * l, d)
    parts = [s.experts(xf, r.slot, r.capacity) for s in shares]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return (total * r.gate[:, None]).to(x.dtype).view(b, l, d)
