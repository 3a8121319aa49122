"""Pipeline parallelism (GPipe) of the BERT text tower over the ``stage``
axis of a 2-D layout (counterpart of ``clip_for_dl_tpu.parallel.pp``).

The tower's L homogeneous layers split into S contiguous stages of L/S.
The layout is ``parallel/common.py``'s ``(data, stage)`` grid with the stage
axis innermost, as the JAX mesh puts it: rank r is at data index r // S and
stage r % S. Each data slice runs its own pipeline over its stage group.

- **Placement.** A rank holds its stage's layers as modules under their
  global state-dict names (``text_tower.encoder.layer.{i}.…``), with their
  AdamW moments and EMA slots (:func:`shard_state_pp`). Every other stage's
  layer stays a module whose tensors hold no element, take no gradient and
  have no moments, so that the state's names and the optimizer's order stay
  the unsharded model's. :func:`whole_state` gathers them over the stage
  group for a checkpoint, which is written whole, in the unsharded layout
  (``ep.WholeCheckpoints``); :func:`gather_tower_` gathers the parameters
  for the eval pass and :func:`shard_stage_` frees them again. JAX's
  stacked layout (``pipeline_stack``, leaves ``[S, L/S, …]``) is
  :func:`stack_bert_layers` / :func:`pp_params` on state dicts.
- **The loop** (:func:`_gpipe_loop`, JAX's) runs M + S − 1 ticks. At tick t
  stage 0 takes microbatch t through a select that keeps the carry it
  received in the graph; a stage holding microbatch t − s applies its
  layers to it with that microbatch's attention bias (the bias is
  replicated, so the stage indexes it where JAX hops it with the carry),
  and a stage holding none passes its carry on; then the carry hops one
  stage round the ring (``collectives.ring_shift``). Every stage's outputs
  stay in the graph, all but the last stage's masked to zero, and are
  summed over the stage group with an identity backward
  (``collectives.reduce_from_model``): each stage computes the loss on its
  identical copy and hands its own cotangent back once. So every hop's
  backward runs on every rank, in the same order. The embeddings run
  replicated and without dropout; their output goes through
  ``collectives.copy_to_model``, whose backward sums its gradient over the
  stage group (JAX's transpose of a replicated input): only stage 0 takes
  it in. The layers run deterministic on the plain attention and MLP
  routes whatever ``flash`` and ``fused_mlp`` the model carries, as JAX
  builds the pipelined layer (pp.py:260-263).
- **The one-process form** (:func:`pipelined_bert_shares`,
  :func:`pipelined_vit_shares`): every stage's share of the tower, each a
  copy cut by :func:`shard_stage_`, run one after another in one process,
  the hop handed over in memory and the stage group's two sums taken there
  (:class:`StageContext` without a group), as ``models/bert.py
  layer_shares`` runs the shares of tensor parallelism.
- **The step** (:func:`make_pp_clip_pretrain_step`): the phase-A step of
  ``train/steps.py`` with its text tower pipelined. The image tower, the
  BatchNorm statistics, the contrastive loss and the gradient average run
  over the data group (the ranks of a stage group compute them identically);
  the text projector's dropout stays active, drawn alike on the ranks of a
  data slice (``Mesh2D.generator``); the clip by global norm sums the stage
  layers' squares over the stage group (they are marked with
  :func:`pp_spec`, as ``parallel/tp.py`` marks its shards).
  :func:`pipeline_parallel_step` feeds a rank its data slice.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .collectives import copy_to_model, reduce_from_model, ring_shift
from .common import DATA_AXIS, Mesh2D, create_2d_mesh
from .tp import REPLICATED, Spec, step_groups, tensor_parallel_step

STAGE_AXIS = "stage"
# the state-dict component holding JAX's [S, layers_per_stage, ...] stack
STACK_KEY = "pipeline_stack"

_LEADING = Spec(0)
_STAGE_NAME = re.compile(rf"(?:^|\.)(?:{STACK_KEY}|encoder\.layer\.\d+)\.")
# the modules' switches of the attention and MLP kernels and of the bf16
# probabilities (BERT and ViT): JAX builds the pipelined layers without them
_ROUTES = ("flash", "fused_mlp", "fused_mlp_train", "bf16_probs")


def create_dp_pp_mesh(pp: int, num_devices: Optional[int] = None) -> Mesh2D:
    """The 2-D ``(data, stage)`` layout, ``stage`` innermost."""
    return create_2d_mesh(pp, (DATA_AXIS, STAGE_AXIS), num_devices)


def validate_pp(num_layers: int, pp: int, num_microbatches: int, batch_size: int) -> None:
    if pp < 1 or num_layers % pp:
        raise ValueError(f"pp={pp} must divide the layer count {num_layers}")
    if num_microbatches < 1 or batch_size % num_microbatches:
        raise ValueError(f"microbatches={num_microbatches} must divide batch {batch_size}")


# ---------------------------------------------------------------------------
# JAX's stacked layout on state dicts: encoder.layer.{i}.X <-> pipeline_stack.X
# ---------------------------------------------------------------------------


def _stack(state_dict: Mapping[str, torch.Tensor], num_stages: int,
           prefix: str) -> Dict[str, torch.Tensor]:
    pattern = re.compile(rf"^{re.escape(prefix)}encoder\.layer\.(\d+)\.(.+)$")
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    out = {}
    for name, t in state_dict.items():
        m = pattern.match(name)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
        else:
            out[name] = t
    if not layers:
        raise ValueError("text tower params contain no layer_<i> entries")
    if len(layers) % num_stages:
        raise ValueError(f"{len(layers)} layers do not split into {num_stages} stages")
    lps = len(layers) // num_stages
    for inner, t in layers[0].items():
        out[f"{prefix}{STACK_KEY}.{inner}"] = torch.stack(
            [layers[i][inner] for i in range(len(layers))]).reshape(num_stages, lps, *t.shape)
    return out


def _unstack(state_dict: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    head = f"{prefix}{STACK_KEY}."
    out = {}
    for name, t in state_dict.items():
        if not name.startswith(head):
            out[name] = t
            continue
        inner = name[len(head):]
        for s in range(t.shape[0]):
            for j in range(t.shape[1]):
                out[f"{prefix}encoder.layer.{s * t.shape[1] + j}.{inner}"] = t[s, j]
    return out


def stack_bert_layers(state_dict: Mapping[str, torch.Tensor],
                      num_stages: int) -> Dict[str, torch.Tensor]:
    """A ``BertEncoder`` state dict ``{embeddings.…, encoder.layer.{i}.…}``
    → ``{embeddings.…, pipeline_stack.…}`` with leaves ``[num_stages,
    L/num_stages, …]``, stage-major, in layer order (JAX's layout, its
    messages)."""
    return _stack(state_dict, num_stages, "")


def unstack_bert_layers(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_bert_layers` (exact: views of the stack)."""
    return _unstack(state_dict, "")


def pp_params(state_dict: Mapping[str, torch.Tensor], num_stages: int) -> Dict[str, torch.Tensor]:
    """A whole model's state dict with its text tower stacked."""
    return _stack(state_dict, num_stages, "text_tower.")


def unpp_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _unstack(state_dict, "text_tower.")


def pp_spec(name: str) -> Spec:
    """The stage axis splits the leading dim of a ``pipeline_stack`` leaf;
    a BERT layer's tensor (``encoder.layer.{i}.…``, a stage's share) is
    marked with the same spec; every other tensor is replicated."""
    return _LEADING if _STAGE_NAME.search(name) else REPLICATED


# ---------------------------------------------------------------------------
# a rank's stage of the tower
# ---------------------------------------------------------------------------


def _layers(tower) -> list:
    """A tower's transformer layers in order: BERT's ``encoder.layer``, the
    ViT's ``encoder.layers``."""
    enc = tower.encoder
    return list(enc.layer if hasattr(enc, "layer") else enc.layers)


def _per_stage(tower, num_stages: int) -> int:
    """The layers a stage holds; raises unless the tower's layers split
    into ``num_stages`` homogeneous stages."""
    layers = _layers(tower)
    if len(layers) % num_stages:
        raise ValueError(f"{len(layers)} layers do not split into {num_stages} stages")
    shapes = {tuple((n, tuple(p.shape)) for n, p in layer.named_parameters())
              for layer in layers if all(p.numel() for p in layer.parameters())}
    if len(shapes) > 1:
        raise ValueError("pipeline parallelism does not support a MoE text tower: the stage "
                         "stack requires homogeneous (dense) blocks")
    return len(layers) // num_stages


def _stage_layers(tower, stage: int, num_stages: int) -> list:
    lps = len(_layers(tower)) // num_stages
    return _layers(tower)[stage * lps:(stage + 1) * lps]


def shard_stage_(tower, stage: int, num_stages: int):
    """``tower`` (a ``BertEncoder`` or ``ViT``) cut to stage ``stage`` in
    place: every other stage's layer keeps its modules, its tensors emptied
    (no element, no gradient); the stage's own are marked with the stage
    spec, for the clip by global norm. Returns ``tower``."""
    lps = _per_stage(tower, num_stages)
    with torch.no_grad():
        for i, layer in enumerate(_layers(tower)):
            for p in layer.parameters():
                if i // lps == stage:
                    p.tp_spec = _LEADING
                else:
                    p.data = p.data.new_empty(0)
                    p.requires_grad_(False)
    return tower


def _all_stages(own: List[torch.Tensor], group) -> List[List[torch.Tensor]]:
    """Every stage's counterparts of ``own`` (this rank's stage's tensors),
    in stage order: one all-gather over the stage group for each dtype."""
    out = [[None] * len(own) for _ in range(dist.get_world_size(group))]
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(own):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        ts = [own[i].contiguous() for i in idx]
        flat = _flatten_dense_tensors(ts)
        parts = [torch.empty_like(flat) for _ in out]
        dist.all_gather(parts, flat, group=group)
        for stage, part in zip(out, parts):
            for i, t in zip(idx, _unflatten_dense_tensors(part, ts)):
                stage[i] = t
    return out


def _gathered(own_layers, get, mesh: Mesh2D) -> Dict[int, list]:
    """layer index → the tensors ``get(layer)`` of every layer outside this
    rank's stage, gathered from its stage (the layers are homogeneous)."""
    lps, s = len(own_layers), mesh.model_index
    per_layer = [get(layer) for layer in own_layers]
    n = len(per_layer[0])
    stages = _all_stages([t for ts in per_layer for t in ts], mesh.model_group)
    return {k * lps + j: stages[k][j * n:(j + 1) * n]
            for k in range(mesh.model_size) if k != s for j in range(lps)}


def gather_tower_(tower, mesh: Mesh2D):
    """Every layer of ``tower`` (sharded by :func:`shard_stage_`) filled in
    place with its parameters gathered from its stage (a collective over the
    stage group): the whole tower, for the eval pass; :func:`shard_stage_`
    frees the other stages' again. Returns ``tower``."""
    if mesh.model_size == 1:
        return tower
    layers = _layers(tower)
    own = _stage_layers(tower, mesh.model_index, mesh.model_size)
    with torch.no_grad():
        for i, ts in _gathered(own, lambda m: [p.data for p in m.parameters()], mesh).items():
            for p, t in zip(layers[i].parameters(), ts):
                p.data = t
    return tower


def _moments(optimizer, p) -> Dict[str, torch.Tensor]:
    """``p``'s optimizer state entries shaped like ``p`` (AdamW's moments)."""
    if optimizer is None:
        return {}
    return {k: v for k, v in optimizer.state.get(p, {}).items()
            if torch.is_tensor(v) and v.shape == p.shape}


def shard_state_pp(state, mesh: Mesh2D):
    """A ``TrainState`` cut to this rank's stage of the mesh: the text
    tower's other layers freed from the device (:func:`shard_stage_`), with
    their AdamW moments and EMA slots; returns ``state``."""
    if mesh.model_size == 1:
        return state
    tower = state.model.text_tower
    lps = _per_stage(tower, mesh.model_size)
    names = {id(p): n for n, p in state.model.named_parameters()}
    for i, layer in enumerate(_layers(tower)):
        if i // lps == mesh.model_index:
            continue
        for p in layer.parameters():
            if state.optimizer is not None:
                state.optimizer.state.pop(p, None)
            if state.ema_params is not None:
                name = names[id(p)]
                state.ema_params[name] = state.ema_params[name].new_empty(0)
    shard_stage_(tower, mesh.model_index, mesh.model_size)
    return state


@contextlib.contextmanager
def whole_state(state, mesh: Mesh2D):
    """Inside: every text layer of ``state`` whole on every rank of the stage
    group (a collective): its parameters, AdamW moments and EMA slot
    gathered from its stage; after: the rank's tensors as they were."""
    if mesh.model_size == 1:
        yield state
        return
    model, opt, ema = state.model, state.optimizer, state.ema_params
    own = _stage_layers(model.text_tower, mesh.model_index, mesh.model_size)
    names = {id(p): n for n, p in model.named_parameters()}
    first = next(own[0].parameters())
    moments = sorted(_moments(opt, first))
    gets = {"param": lambda m: [p.data for p in m.parameters()]}
    for k in moments:
        gets[k] = lambda m, k=k: [opt.state[p][k] for p in m.parameters()]
    if ema is not None:
        gets["ema"] = lambda m: [ema[names[id(p)]] for p in m.parameters()]
    with torch.no_grad():
        got = {kind: _gathered(own, get, mesh) for kind, get in gets.items()}
    layers, kept = _layers(model.text_tower), []
    for i, params in got["param"].items():
        for j, p in enumerate(layers[i].parameters()):
            name = names[id(p)]
            kept.append((p, p.data, None if ema is None else ema[name]))
            p.data = params[j]
            if moments:
                opt.state[p] = {"step": opt.state[first]["step"].clone(),
                                **{k: got[k][i][j] for k in moments}}
            if ema is not None:
                ema[name] = got["ema"][i][j]
    try:
        yield state
    finally:
        for p, data, slot in kept:
            p.data = data
            if opt is not None:
                opt.state.pop(p, None)
            if ema is not None:
                ema[names[id(p)]] = slot


# ---------------------------------------------------------------------------
# the pipelined forwards
# ---------------------------------------------------------------------------


class _StageSum(torch.autograd.Function):
    """Each stage's copy of a replicated input, in one process: every
    copy's gradient the sum over the copies (``copy_to_model``'s backward
    over the stage group)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        total = gs[0]
        for g in gs[1:]:
            total = total + g
        return tuple(total for _ in gs)


@dataclass(frozen=True)
class StageContext:
    """The stages this process runs and the stage group's three exchanges:
    one stage (``stages = (s,)``) over ``group``, or every stage in one
    process (``group`` None: the sums taken in memory). Each method takes
    and gives a list over the local stages."""

    stages: Tuple[int, ...]
    size: int
    group: Optional[object] = None

    def enter(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The replicated input, each stage's copy; its gradient summed over
        the stages."""
        if self.group is not None:
            return [copy_to_model(xs[0], self.group)]
        return list(_StageSum.apply(*xs)) if len(xs) > 1 else xs

    def hop(self, carries: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each stage's carry to the next stage round the ring."""
        if self.group is not None:
            return [ring_shift(carries[0], self.group)]
        return carries[-1:] + carries[:-1]

    def broadcast(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The stages' masked outputs summed, on every stage; each part's
        gradient the output's (the identity backward)."""
        if self.group is not None:
            return reduce_from_model(parts[0], self.group)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


def stage_context(mesh: Mesh2D) -> StageContext:
    """This rank's stage of ``mesh`` over its stage group."""
    return StageContext((mesh.model_index,), mesh.model_size, mesh.model_group)


@contextlib.contextmanager
def _deterministic_plain(modules):
    """Every module (and submodule) in eval mode, its attention and MLP on
    the plain routes (``flash``, ``fused_mlp``, ``fused_mlp_train`` and
    ``bf16_probs`` off)
    while inside; as it was after."""
    subs = {id(sub): sub for m in modules for sub in m.modules()}  # a shared cast once
    saved = []
    for sub in subs.values():
        flags = {k: getattr(sub, k) for k in _ROUTES if isinstance(getattr(sub, k, None), bool)}
        saved.append((sub, sub.training, flags))
        sub.training = False
        for k in flags:
            setattr(sub, k, False)
    try:
        yield
    finally:
        for sub, training, flags in saved:
            sub.training = training
            for k, v in flags.items():
                setattr(sub, k, v)


def _gpipe_loop(applies: Sequence[Callable], ctx: StageContext, num_microbatches: int,
                xs: List[torch.Tensor], bias_mb: Optional[torch.Tensor]) -> torch.Tensor:
    """The GPipe schedule over the local stages ``ctx.stages`` (``applies``
    their layers, ``fn(x, bias)``): ``xs`` each stage's copy of the
    microbatched input [M, mb, …], ``bias_mb`` [M, mb, …] or None. Returns
    the last stage's outputs [M, mb, …] on every stage."""
    m_count, size = num_microbatches, ctx.size
    xs = ctx.enter(xs)
    zeros = torch.zeros_like(xs[0][0])
    carries = [zeros] * len(applies)
    outs: List[List[torch.Tensor]] = [[] for _ in applies]
    firsts = [torch.tensor(s == 0, device=zeros.device) for s in ctx.stages]
    for t in range(m_count + size - 1):
        for k, s in enumerate(ctx.stages):
            # stage 0 takes microbatch t; the select keeps the carry it
            # received in the graph, so that its hop's backward runs
            carries[k] = torch.where(firsts[k], xs[k][t] if t < m_count else zeros, carries[k])
            if 0 <= t - s < m_count:  # the stage holds microbatch t - s
                carries[k] = applies[k](carries[k], None if bias_mb is None else bias_mb[t - s])
            if t >= size - 1:
                outs[k].append(carries[k])
        if t < m_count + size - 2 and size > 1:
            carries = ctx.hop(carries)
    none = torch.zeros((), dtype=zeros.dtype, device=zeros.device)
    return ctx.broadcast([torch.where(torch.tensor(s == size - 1, device=none.device),
                                      torch.stack(o), none)
                          for s, o in zip(ctx.stages, outs)])


def _run_layers(layers) -> Callable:
    def apply(x, bias):
        for layer in layers:
            x = layer(x, bias) if bias is not None else layer(x)
        return x

    return apply


def _check_batch(num_layers: int, size: int, num_microbatches: int, rows: int, dp: int,
                 what: str) -> None:
    """JAX's checks on the global batch (``rows`` a data slice's of ``dp``)."""
    b = rows * dp
    validate_pp(num_layers, size, num_microbatches, b)
    if (b // num_microbatches) % dp:
        raise ValueError(f"microbatch size {b // num_microbatches}{what} must divide over the "
                         f"data axis ({dp})")


def _pipeline(towers, ctx: StageContext, embed: Callable, bias: Optional[torch.Tensor],
              num_microbatches: int) -> torch.Tensor:
    """The towers' stage layers (``towers[k]`` holds stage ``ctx.stages[k]``)
    over the GPipe loop, deterministic on the plain routes: ``embed(tower)``
    each stage's copy of the input [b, …], ``bias`` [b, …] or None; the last
    stage's outputs [b, …]."""
    with _deterministic_plain(towers):
        xs = [embed(t) for t in towers]
        if torch.is_grad_enabled() and not xs[0].requires_grad:
            # every hop must have a backward on every rank
            xs = [x.requires_grad_() for x in xs]
        m = xs[0].shape[0] // num_microbatches

        def split(t):
            return t.reshape(num_microbatches, m, *t.shape[1:])

        out = _gpipe_loop([_run_layers(_stage_layers(t, s, ctx.size))
                           for t, s in zip(towers, ctx.stages)], ctx, num_microbatches,
                          [split(x) for x in xs], None if bias is None else split(bias))
    return out.reshape(-1, *out.shape[2:])


def _bert_pipeline(encoders, ctx: StageContext, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor], num_microbatches: int,
                   dp: int = 1) -> torch.Tensor:
    b, n = input_ids.shape
    _check_batch(len(_layers(encoders[0])), ctx.size, num_microbatches, b, dp,
                 f" (batch {b * dp} / {num_microbatches} microbatches)")
    if attention_mask is not None:
        bias = torch.where(attention_mask > 0, 0.0, -1e10).to(torch.float32)
    else:
        bias = torch.zeros((b, n), dtype=torch.float32, device=input_ids.device)
    return _pipeline(encoders, ctx, lambda e: e.embeddings(input_ids), bias, num_microbatches)


def pipelined_bert_forward(encoder, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor], mesh: Mesh2D,
                           num_microbatches: int) -> torch.Tensor:
    """last_hidden_state [b, L, hidden] of ``encoder`` (a ``BertEncoder``
    holding this rank's stage, or whole) on this rank's data slice of the
    batch, its layers pipelined over the mesh's stage group in
    ``num_microbatches`` microbatches. The embeddings run replicated and the
    layers deterministic, on the plain routes; padding's bias is −1e10.
    JAX's checks hold on the global batch (the slice times the data axis)."""
    return _bert_pipeline([encoder], stage_context(mesh), input_ids, attention_mask,
                          num_microbatches, mesh.data_size)


def pipelined_bert_shares(encoders, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor],
                          num_microbatches: int) -> torch.Tensor:
    """The one-process form of :func:`pipelined_bert_forward`: ``encoders[s]``
    is stage s's share (a copy of the tower, :func:`shard_stage_`), each
    with its own embeddings; every stage runs here, one after another."""
    size = len(encoders)
    return _bert_pipeline(encoders, StageContext(tuple(range(size)), size), input_ids,
                          attention_mask, num_microbatches)


def _vit_pipeline(vits, ctx: StageContext, images: torch.Tensor, num_microbatches: int,
                  dp: int = 1) -> torch.Tensor:
    _check_batch(len(_layers(vits[0])), ctx.size, num_microbatches, images.shape[0], dp, "")
    return vits[0].head(_pipeline(vits, ctx, lambda v: v.embed(images), None,
                                  num_microbatches))


def pipelined_vit_forward(vit, images: torch.Tensor, mesh: Mesh2D,
                          num_microbatches: int) -> torch.Tensor:
    """CLS features [b, hidden] of a ``ViT`` tower (holding this rank's
    stage, or whole) on this rank's data slice of ``images``, its encoder
    layers pipelined over the mesh's stage group: the image-side
    counterpart of :func:`pipelined_bert_forward`. The stem and the final
    LayerNorm run replicated; the layers deterministic, on the plain
    routes."""
    return _vit_pipeline([vit], stage_context(mesh), images, num_microbatches, mesh.data_size)


def pipelined_vit_shares(vits, images: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """The one-process form of :func:`pipelined_vit_forward` over every
    stage's share ``vits[s]``."""
    size = len(vits)
    return _vit_pipeline(vits, StageContext(tuple(range(size)), size), images,
                         num_microbatches)


# ---------------------------------------------------------------------------
# the pp train step
# ---------------------------------------------------------------------------


def make_pp_clip_pretrain_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    mesh: Mesh2D,
    num_microbatches: int,
    loss_name: str = "clip_self_distill",
    temperature: float = 2.0,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    max_grad_norm: Optional[float] = 1.0,
):
    """The phase-A step of ``train.make_clip_pretrain_step`` whose text
    tower runs pipelined over the mesh's stage group
    (:func:`pipelined_bert_forward`, deterministic), its text projector's
    dropout active; the image tower, BatchNorm, the loss and the gradient
    average over the data group. The state must be sharded by
    :func:`shard_state_pp`."""
    from ..train.steps import make_clip_pretrain_step

    if getattr(model.config, "text_moe_experts", 0):
        raise ValueError("pipeline parallelism does not support a MoE text tower: the stage "
                         "stack requires homogeneous (dense) blocks")

    def encode_text(input_ids, attention_mask, generator):
        hidden = pipelined_bert_forward(model.text_tower, input_ids, attention_mask, mesh,
                                        num_microbatches)
        return model.text_projector(hidden[:, 0, :], generator)

    return make_clip_pretrain_step(
        model, optimizer, label_fn, loss_name, temperature, image_size, mean, std,
        compute_dtype, max_grad_norm, encode_text=encode_text, **step_groups(mesh))


def pipeline_parallel_step(step_fn: Callable, mesh: Mesh2D) -> Callable:
    """``step(state, batch, ...)`` on this rank's data slice of ``batch``
    (the JAX ``pipeline_parallel_step``: the batch sharded on ``data``,
    replicated over ``stage``). ``step_fn`` is
    :func:`make_pp_clip_pretrain_step`'s over a state sharded by
    :func:`shard_state_pp`; its generator must be in lockstep on the ranks
    of a data slice (``Mesh2D.generator``)."""
    return tensor_parallel_step(step_fn, mesh)
