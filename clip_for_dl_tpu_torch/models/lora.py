"""LoRA: parameter-efficient fine-tuning of the frozen towers (counterpart
of ``clip_for_dl_tpu.models.lora``).

Each targeted 2-D weight W gets a trainable low-rank delta: W + (α/r)·A·B in
the JAX package's layout (A [in, r], B [r, out], B zero at init, so that
training starts exactly at the frozen model). The port's weights are in
``nn.Linear`` layout [out, in], so the delta lands as (A·B)ᵀ.

The factors are a :class:`LoRA` module whose tree mirrors the targets'
names, so that a factor's state-dict name is its target's with ``.a`` or
``.b``: ``make_optimizer`` and ``make_label_fn`` group it by its top-level
module, as the JAX step takes each factor's learning rate, and a
``TrainState`` of the factors and their optimizer checkpoints and resumes
like any other. A target's name is the parameter's in the model without
``core.device.cast_in_forward``'s parametrization, but for the ViT's packed
attention projection: JAX holds separate q, k and v kernels, the port one
``self_attention.in_proj_weight`` whose three row blocks (q | k | v, as
``models/convert.py`` stacks them) are the targets
``self_attention.q_proj.weight``, ``.k_proj.weight`` and ``.v_proj.weight``.

:func:`merge_lora` runs inside the step: the deltas in fp32 onto the fp32
masters, cast back to the masters' dtype, and the model runs on the merged
tensors through ``torch.func.functional_call`` (with ``cast_in_forward``
the merged master is what the cast reads), so gradients reach only A and B.
:func:`fold_lora` bakes trained deltas into plain weights for serving.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..core.device import plain_name

# every attention and MLP projection of the BERT and ViT towers, the
# projection heads' first layer and the fusion's two layers: the JAX
# pattern's kernels (query|key|value|attention_output|intermediate|output|
# q_proj|k_proj|v_proj|out_proj|mlp_1|mlp_2|projection|fc1|fc2) under the
# port's names. Embeddings (the ViT's patch projection too), norms and
# convolutions stay frozen, and so do the heads' ``fc`` and the adapters;
# with ResNet-50, LoRA adapts the text tower and the heads.
DEFAULT_TARGETS = (
    r"(\.attention\.self\.(query|key|value)|\.output\.dense|\.intermediate\.dense"
    r"|\.self_attention\.(q_proj|k_proj|v_proj|out_proj)|\.mlp\.[03]"
    r"|_projection|\.fusion\.[03])\.weight$"
)

_PACKED = "self_attention.in_proj_weight"
_SPLIT = ("q_proj", "k_proj", "v_proj")  # its row blocks, in order

Params = Mapping[str, torch.Tensor]


def _named(params: Union[nn.Module, Params]) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {plain_name(n): p for n, p in params.named_parameters()}
    return dict(params)


def _names(name: str) -> List[str]:
    """A parameter's target names: the packed projection's three blocks, or
    the name itself."""
    if name.endswith(_PACKED):
        stem = name[: -len(_PACKED)] + "self_attention."
        return [f"{stem}{s}.weight" for s in _SPLIT]
    return [name]


def _target(path: str) -> Tuple[str, Optional[int]]:
    """(the parameter a target lies in, its row block or None)."""
    for i, s in enumerate(_SPLIT):
        if path.endswith(f"self_attention.{s}.weight"):
            return path[: -len(f"{s}.weight")] + "in_proj_weight", i
    return path, None


def _shape(params: Dict[str, torch.Tensor], path: str) -> Tuple[int, int]:
    """[out, in] of a target."""
    name, block = _target(path)
    out, d_in = params[name].shape
    return (out // 3 if block is not None else out), d_in


def lora_paths(params: Union[nn.Module, Params], pattern: str = DEFAULT_TARGETS) -> List[str]:
    """The sorted names of every 2-D weight matching ``pattern`` (a model,
    or its parameters by name)."""
    out = []
    for name, p in _named(params).items():
        if p.ndim == 2:
            out += [n for n in _names(name) if re.search(pattern, n)]
    return sorted(out)


class LoRA(nn.Module):
    """The factors {target: (a [in, r], b [r, out])} as parameters named
    ``<target>.a`` and ``<target>.b``."""

    def __init__(self, factors: Mapping[str, Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        if not factors:
            raise ValueError("no LoRA factors")
        self.paths = sorted(factors)
        for path in self.paths:
            *parents, leaf_name = path.split(".")
            node = self
            for name in parents:
                if name not in node._modules:
                    node.add_module(name, nn.Module())
                node = node._modules[name]
            leaf = nn.Module()
            leaf.a, leaf.b = (nn.Parameter(t) for t in factors[path])
            node.add_module(leaf_name, leaf)

    def __getitem__(self, path: str) -> Tuple[nn.Parameter, nn.Parameter]:
        leaf = self.get_submodule(path)
        return leaf.a, leaf.b

    def items(self):
        return [(p, self[p]) for p in self.paths]


def init_lora(
    generator: torch.Generator,
    params: Union[nn.Module, Params],
    rank: int = 8,
    pattern: str = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> LoRA:
    """The factors of every target on the parameters' device: A ~ N(0, 1/r)
    (std 1/√r) drawn from ``generator`` target by target in sorted order,
    B = 0, so that the merged model starts bit-equal to the frozen one."""
    named = _named(params)
    a_std = 1.0 / float(rank) ** 0.5
    factors = {}
    for path in lora_paths(named, pattern):
        d_out, d_in = _shape(named, path)
        device = named[_target(path)[0]].device
        a = torch.randn((d_in, rank), generator=generator, dtype=dtype,
                        device=generator.device) * a_std
        factors[path] = (a.to(device), torch.zeros((rank, d_out), dtype=dtype, device=device))
    if not factors:
        raise ValueError(f"no 2-D weights matched pattern {pattern!r}")
    return LoRA(factors)


def _delta(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """(α/r)·(A·B)ᵀ in fp32, [out, in]."""
    return (a.float() @ b.float()).T * (alpha / a.shape[1])


def merge_lora(params: Params, lora: LoRA, alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """``params`` (by name) with W ← W + (α/r)·(A·B)ᵀ at every target:
    the delta in fp32 onto W in fp32, cast back to W's dtype. Differentiable
    in A and B; the other entries pass through."""
    out = dict(params)
    blocks: Dict[str, Dict[int, torch.Tensor]] = {}
    for path, (a, b) in lora.items():
        name, block = _target(path)
        if block is None:
            w = params[name]
            out[name] = (w.float() + _delta(a, b, alpha)).to(w.dtype)
        else:
            blocks.setdefault(name, {})[block] = _delta(a, b, alpha)
    for name, deltas in blocks.items():
        w = params[name]
        rows = w.float().chunk(3)
        out[name] = torch.cat([r + deltas[i] if i in deltas else r
                               for i, r in enumerate(rows)]).to(w.dtype)
    return out


@torch.no_grad()
def fold_lora(variables: Params, lora: LoRA, alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """Bake trained deltas into plain variables (a state dict by name, the
    BatchNorm statistics passing through) for serving and export."""
    return {k: v.detach() for k, v in merge_lora(variables, lora, alpha).items()}


def lora_param_count(lora: LoRA) -> int:
    return sum(p.numel() for p in lora.parameters())


def _merged_call(model: nn.Module, lora: LoRA, alpha: float):
    """``call(*args)``: the model's forward on its weights merged with
    ``lora``'s deltas (by the parameters' own names, parametrized or not)."""
    from torch.func import functional_call

    own = {plain_name(n): (n, p) for n, p in model.named_parameters()}
    targets = {_target(path)[0] for path in lora.paths}
    frozen = {name: own[name][1] for name in targets}

    def call(*args):
        merged = merge_lora(frozen, lora, alpha)
        return functional_call(model, {own[k][0]: v for k, v in merged.items()}, args)

    return call


def make_lora_pretrain_step(
    model: nn.Module,
    lora: LoRA,
    optimizer: torch.optim.Optimizer,
    loss_name: str = "clip_self_distill",
    temperature: float = 2.0,
    alpha: float = 16.0,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    max_grad_norm: Optional[float] = 1.0,
):
    """The CLIP contrastive pretrain step training only ``lora``'s factors:
    ``step(state, batch, lrs, generator) -> (state, {"loss"})`` with
    ``state = TrainState(lora, optimizer)`` and ``optimizer`` from
    ``train.make_optimizer(lora, label_fn, weight_decay)`` (each factor's
    learning rate from its top-level module, decay on every factor, as the
    JAX ``base_transform`` decays every parameter of ndim > 0).

    The whole frozen base runs in inference mode: BatchNorm on running
    statistics (left untouched) and no dropout, so ``generator`` is unused,
    as the JAX step ignores its key. The base's parameters are frozen here
    (``requires_grad`` off), so that no gradient is formed for them. Then,
    as the JAX step: the loss of the merged model's features, a zero
    gradient for the factors the forward does not reach (the fusion's),
    clipping by global norm over the factors, the update."""
    from ..ops.image_prep import preprocess_images
    from ..train.optim import clip_by_global_norm_, set_group_lrs
    from ..train.steps import PRETRAIN_LOSSES

    loss_fn = PRETRAIN_LOSSES[loss_name]
    model.requires_grad_(False)
    factors = list(lora.parameters())
    forward = _merged_call(model, lora, alpha)

    def step(state, batch, lrs, generator: Optional[torch.Generator] = None):
        del generator  # a deterministic forward (see above)
        if state.model is not lora or state.optimizer is not optimizer:
            raise ValueError("state holds other factors or another optimizer than this step")
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        model.eval()
        img_f, txt_f = forward(images, batch["input_ids"], batch["attention_mask"])
        loss = loss_fn(txt_f, img_f, temperature)
        loss.backward()
        for p in factors:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_grad_norm is not None:
            clip_by_global_norm_(factors, max_grad_norm)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_lora_eval_step(
    model: nn.Module,
    lora: LoRA,
    loss_name: str = "clip_self_distill",
    temperature: float = 2.0,
    alpha: float = 16.0,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """``step(state, batch) -> {"loss"}``: the pretrain loss of the merged
    model in eval mode, the objective the LoRA step trains (the JAX CLI's
    ``lora_eval``: it drives the plateau schedule, early stopping and the
    best checkpoint)."""
    from ..ops.image_prep import preprocess_images
    from ..train.steps import PRETRAIN_LOSSES

    loss_fn = PRETRAIN_LOSSES[loss_name]
    forward = _merged_call(model, lora, alpha)

    @torch.no_grad()
    def step(state, batch):
        model.eval()
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        img_f, txt_f = forward(images, batch["input_ids"], batch["attention_mask"])
        return {"loss": loss_fn(txt_f, img_f, temperature)}

    return step

