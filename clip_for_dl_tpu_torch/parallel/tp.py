"""Tensor parallelism (Megatron) of the transformer towers over the
``model`` axis of a 2-D layout (counterpart of ``clip_for_dl_tpu.parallel.tp``).

The rules are the JAX package's, keyed on the port's state-dict names:
only the leaves of a transformer layer (BERT ``encoder.layer.<i>``, ViT
``encoder.layers.encoder_layer_<i>``) are sharded; the ResNet, the
embeddings, the norms and every head stay replicated.

- **column-parallel** (the JAX ``P(None, model)`` kernel and ``P(model)``
  bias): BERT ``attention.self.{query,key,value}`` and
  ``intermediate.dense``, ViT ``mlp.0`` and the packed
  ``self_attention.in_proj_{weight,bias}``. ``nn.Linear`` keeps its weight
  as [out, in], so the JAX kernel's sharded output columns are the torch
  weight's rows. The ViT's packed projection holds q | k | v stacked: rank
  r takes its rows of *each third* (:class:`Spec` ``parts=3``), so that its
  local projection is again q | k | v over its heads;
- **row-parallel** (the JAX ``P(model, None)`` kernel): BERT
  ``attention.output.dense`` and ``output.dense``, ViT
  ``self_attention.out_proj`` and ``mlp.3``: the torch weight's columns.
  Their biases are replicated and added once, after the all-reduce.

:func:`tensor_parallel_` shards a model in place for this rank and gives
each transformer layer its :class:`TPContext`: rank r runs heads
r·H/tp … of the attention (the kernels B3 and B6 at ``heads/tp`` with
``head_offset``, so that the dropout masks are the unsharded layer's) and
its slice of the MLP hidden (B4 and B8 at ``F/tp``, b2 added after the
all-reduce), the partial products summed by the context's
:meth:`TPContext.reduce`. :func:`shard_state_tp` does the same to a
:class:`~clip_for_dl_tpu_torch.train.TrainState`: the AdamW moments and
the EMA shard like their parameters. :func:`tensor_parallel_step` runs a
step built with the mesh's groups (:meth:`step_groups`) on this rank's
data slice. Everything is elementwise in the optimizer but the clip by
global norm, which sums each sharded leaf's squares over the model group
(``train/optim.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch

from .collectives import copy_to_model, reduce_from_model
from .common import DATA_AXIS, MODEL_AXIS, Mesh2D, create_2d_mesh
from .dp import shard_batch

# BERT and ViT layer prefixes, then the leaf's name inside the layer
_LAYER = re.compile(r"(?:^|\.)(?:encoder\.layer\.\d+|encoder\.layers\.encoder_layer_\d+)\.(.+)$")
_COLUMN = frozenset({
    "attention.self.query", "attention.self.key", "attention.self.value",
    "intermediate.dense", "mlp.0",
})
_ROW = frozenset({"attention.output.dense", "output.dense", "self_attention.out_proj",
                  "mlp.3"})


class Spec(NamedTuple):
    """How a tensor is split over the model axis: along ``dim`` (None:
    replicated), in ``parts`` equal blocks along it that are each split."""

    dim: Optional[int] = None
    parts: int = 1


REPLICATED = Spec()


_CAST = re.compile(r"\.parametrizations\.(\w+)\.original$")


def tp_spec(name: str, value: torch.Tensor) -> Spec:
    """The Megatron rule for one state-dict entry of the port's model (a
    parameter cast in the forward, ``...parametrizations.weight.original``,
    by its own name)."""
    m = _LAYER.search(_CAST.sub(r".\1", name))
    if m is None:
        return REPLICATED
    return layer_spec(m.group(1), value)


def layer_spec(inner: str, value: torch.Tensor) -> Spec:
    """The rule for a parameter by its name inside a transformer layer."""
    inner = _CAST.sub(r".\1", inner)
    module, _, leaf = inner.rpartition(".")
    if inner in ("self_attention.in_proj_weight", "self_attention.in_proj_bias"):
        return Spec(0, 3)
    if module in _COLUMN and leaf in ("weight", "bias"):
        return Spec(0) if value.dim() in (1, 2) else REPLICATED
    if module in _ROW and leaf == "weight" and value.dim() == 2:
        return Spec(1)
    return REPLICATED


def validate_tp(heads: int, intermediate: int, tp: int) -> None:
    """TP degree must divide the attention heads and the MLP hidden."""
    if heads % tp or intermediate % tp:
        raise ValueError(
            f"tp={tp} must divide attention heads ({heads}) and MLP "
            f"intermediate ({intermediate})"
        )


def create_dp_tp_mesh(tp: int, num_devices: Optional[int] = None) -> Mesh2D:
    """The 2-D ``(data, model)`` layout, ``model`` innermost."""
    return create_2d_mesh(tp, (DATA_AXIS, MODEL_AXIS), num_devices)


def shard_tensor(t: torch.Tensor, spec: Spec, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` under ``spec`` (a contiguous copy)."""
    if spec.dim is None or tp == 1:
        return t
    parts = t.chunk(spec.parts, spec.dim)
    return torch.cat([p.chunk(tp, spec.dim)[rank] for p in parts], spec.dim).contiguous()


def gather_tensor(shards: Sequence[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The whole tensor from every rank's block, in rank order."""
    if spec.dim is None or len(shards) == 1:
        return shards[0]
    blocks = [s.chunk(spec.parts, spec.dim) for s in shards]
    return torch.cat([torch.cat([b[k] for b in blocks], spec.dim)
                      for k in range(spec.parts)], spec.dim)


def shard_state_dict_tp(sd: Mapping[str, torch.Tensor], rank: int, tp: int) -> Dict[str, torch.Tensor]:
    """A rank's shard of a state dict (from ``state_dict_from_jax`` or a
    checkpoint): the sharded entries sliced, the rest as they are."""
    return {k: shard_tensor(v, tp_spec(k, v), rank, tp) for k, v in sd.items()}


def gather_state_dict_tp(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's shard, in rank order
    (the replicated entries from rank 0)."""
    out = {}
    for k, v in shards[0].items():
        out[k] = gather_tensor([s[k] for s in shards], tp_spec(k, v))
    return out


@dataclass(frozen=True)
class TPContext:
    """A transformer layer's place in the model axis: its rank among
    ``size``, and the two collectives over ``group`` (identities without
    one, for a rank's share run alone). The default, :data:`UNSHARDED`, is
    the plain layer's: every head, the whole MLP, the biases in their
    products."""

    rank: int = 0
    size: int = 1
    group: Optional[object] = None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """At a column-parallel input: the input gradient summed."""
        return copy_to_model(x, self.group)

    def reduce(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """After a row-parallel output: the ranks' partial products summed
        (this rank's one part; several when every share runs here)."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return reduce_from_model(total, self.group)

    def row_output(self, parts: List[torch.Tensor], bias: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        """A row-parallel layer's output: the partial products summed in
        fp32, the bias added once; at tp = 1 the one product, which holds
        its bias (the plain layer's bits)."""
        if self.size == 1:
            return parts[0]
        return (self.reduce([p.float() for p in parts]) + bias.float()).to(dtype)

    def heads(self, heads: int) -> tuple:
        """(this rank's head count, the global index of its first head)."""
        local = heads // self.size
        return local, self.rank * local

    def attend(self, fn: Callable, *qkv: torch.Tensor) -> torch.Tensor:
        """``fn`` (the attention over this rank's heads) on the projected
        q/k/v as they are; ``parallel/sp.py`` gathers them along the
        sequence here."""
        return fn(*qkv)

    def replicated(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """``fn`` (a module no rank shards: a MoE layer's MLP) once, on the
        layer's tokens as they are; ``parallel/sp.py`` runs it on the
        gathered sequence."""
        return fn(x)


UNSHARDED = TPContext()


def _tp_layers(model) -> list:
    from ..models.bert import BertLayer
    from ..models.vit import ViTEncoderLayer

    return [m for m in model.modules() if isinstance(m, (BertLayer, ViTEncoderLayer))]


def check_model_tp(model, tp: int) -> None:
    """``validate_tp`` on every transformer layer of ``model``, and the
    JAX CLI's refusal of the ViT's B9 (``--fused-mlp``) under tp > 1."""
    from ..models.bert import BertLayer

    for layer in _tp_layers(model):
        if isinstance(layer, BertLayer):
            validate_tp(layer.attention.self.heads, layer.intermediate_dim, tp)
        else:
            validate_tp(layer.self_attention.heads, layer.mlp_dim, tp)
            if layer.fused_mlp and tp > 1:
                raise ValueError("--fused-mlp composes with data parallelism only "
                                 "(not --tp/--pp/--ep)")


def tensor_parallel_(model, mesh: Mesh2D, share: Optional[int] = None):
    """Shard ``model``'s transformer layers in place for this rank of the
    mesh's model axis (or, with ``share``, for that rank with no group: a
    rank's share to run alone) and set each layer's :class:`TPContext`;
    returns ``model``. At tp = 1 nothing is sliced and the layers run as
    without a context."""
    tp = mesh.model_size
    rank = mesh.model_index if share is None else share
    check_model_tp(model, tp)
    return shard_layers_(model, TPContext(rank, tp, mesh.model_group if share is None else None))


def shard_layers_(model, ctx: TPContext):
    """Every transformer layer of ``model`` cut to ``ctx``'s shard in place
    (its sharded parameters marked with their ``tp_spec``) and given
    ``ctx``; returns ``model``."""
    with torch.no_grad():
        for layer in _tp_layers(model):
            for name, p in layer.named_parameters():
                spec = layer_spec(name, p)
                if spec.dim is not None:
                    p.data = shard_tensor(p.data, spec, ctx.rank, ctx.size)
                    p.tp_spec = spec
            layer.tp = ctx
    return model


def shard_state_tp(state, mesh: Mesh2D):
    """A ``TrainState`` sharded for this rank: the model in place
    (:func:`tensor_parallel_`), the optimizer's moments and the EMA like
    their parameters; returns ``state``."""
    tp, rank = mesh.model_size, mesh.model_index
    names = dict(state.model.named_parameters())
    with torch.no_grad():
        for name, p in names.items():
            spec = tp_spec(name, p)
            if spec.dim is None:
                continue
            for k, v in state.optimizer.state.get(p, {}).items() if state.optimizer else ():
                if torch.is_tensor(v) and v.shape == p.shape:
                    state.optimizer.state[p][k] = shard_tensor(v, spec, rank, tp)
            if state.ema_params is not None:
                state.ema_params[name] = shard_tensor(state.ema_params[name], spec, rank, tp)
    tensor_parallel_(state.model, mesh)
    return state


def step_groups(mesh: Mesh2D) -> dict:
    """The step factories' keywords for ``mesh``: the data group for the
    global BatchNorm, the losses and the gradient average; the model group
    for the clip by global norm (none at tp = 1: the plain clip)."""
    return {"group": mesh.data_group,
            "model_group": mesh.model_group if mesh.model_size > 1 else None}


def tensor_parallel_step(step_fn: Callable, mesh: Mesh2D) -> Callable:
    """``step(state, batch, ...)`` on this rank's data slice of ``batch``
    (the JAX ``tensor_parallel_step``). ``step_fn`` is built with
    :func:`step_groups` over a state sharded by :func:`shard_state_tp`;
    its generator must be in lockstep on the ranks of a data slice
    (:meth:`Mesh2D.generator`)."""

    def wrapped(state, batch, *rest):
        if mesh.data_group is not None:
            batch = shard_batch(batch, mesh.data_group)
        return step_fn(state, batch, *rest)

    return wrapped
