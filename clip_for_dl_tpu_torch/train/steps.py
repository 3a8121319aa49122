"""Train and eval step factories (counterpart of
``clip_for_dl_tpu.train.steps``). Ported so far: the phase-A CLIP pretrain
step and the phase-B C-Adapter step, each with its eval step.

``step(state, batch, lrs, generator) -> (state, {"loss"})`` runs, in order:
uint8 images → ``preprocess_images`` (kernel B2); the joint forward in train
mode (BatchNorm on batch statistics, running statistics updated; dropout;
attention dropout inside kernel B3, seeded from ``generator``); the loss in
fp32 on the raw features; backward through the attention (B6) and MLP (B8)
kernels' autograd functions; zero gradients for the heads the forward skips;
optax-style clipping by global norm; AdamW with the group learning rates of
``lrs``; the clamp of a learnable ``logit_scale`` at log 100; the EMA of
the parameters. Batches are dicts of device tensors: ``images`` uint8
[B, H, W, C], ``input_ids`` and ``attention_mask`` [B, L]; the adapter
steps read ``images`` and the multi-hot ``labels`` [B, C].

The pretrain losses are ``clip_self_distill``, ``info_nce`` and
``siglip``. A model built with ``learnable_temperature`` trains its scale
s = exp(min(logit_scale, log 100)) and bias: the softmax losses run at
T = 1/s, siglip at (s, b); without it siglip runs at the paper's s = 10,
b = -10 and ignores T.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..losses import bce_with_logits_loss, clip_self_distill_loss, info_nce_loss, siglip_loss
from ..ops.image_prep import preprocess_images
from .optim import clip_by_global_norm_, set_group_lrs
from .state import TrainState

Batch = Mapping[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

PRETRAIN_LOSSES = {
    "clip_self_distill": clip_self_distill_loss,
    "info_nce": lambda txt, img, t: info_nce_loss(img, txt, t),
    # SigLIP ignores the softmax temperature: the paper's scale/bias init
    # (s = 10, b = -10) is its operating point
    "siglip": lambda txt, img, t: siglip_loss(txt, img),
}

# open-CLIP's guard on the learnable scale: s = exp(log s) clamped to 100
_LOG_SCALE_MAX = math.log(100.0)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _learned_scale(params: Mapping[str, torch.Tensor]):
    """(s, b) from the model's calibration scalars, or None for a model
    built without ``learnable_temperature``."""
    if "logit_scale" not in params:
        return None
    log_s = params["logit_scale"].float()
    s = torch.exp(torch.minimum(log_s, torch.tensor(_LOG_SCALE_MAX, device=log_s.device)))
    return s, params["logit_bias"].float()


def _contrastive(loss_name: str, temperature: float) -> Callable:
    """``loss(txt, img, params)``: the pretrain loss at the model's learned
    scale where it has one, else at ``temperature``."""
    base = PRETRAIN_LOSSES[loss_name]

    def loss(txt_f, img_f, params):
        sb = _learned_scale(params)
        if sb is None:
            return base(txt_f, img_f, temperature)
        if loss_name == "siglip":
            return siglip_loss(txt_f, img_f, *sb)
        return base(txt_f, img_f, 1.0 / sb[0])

    return loss


@torch.no_grad()
def update_ema(ema: List[torch.Tensor], params: List[torch.Tensor], step: int,
               decay: float) -> None:
    """e ← e·d + p·(1 − d) in fp32 with the warmup-capped decay
    d = min(decay, (1 + t) / (10 + t)), t the step count before this step's
    increment (the JAX ``_apply_updates``): early steps track the live
    parameters rather than the initial weights the EMA was seeded with."""
    t = np.float32(step)
    d = np.minimum(np.float32(decay), (np.float32(1.0) + t) / (np.float32(10.0) + t))
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1.0) - d)))


def _check_groups(model, optimizer, label_fn) -> list:
    """Every parameter in ``optimizer`` sits in its ``label_fn`` group;
    returns them."""
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if label_fn(tuple(names[id(p)].split("."))) != group["label"]:
                raise ValueError(f"{names[id(p)]} is not in its label_fn group")
    return [p for group in optimizer.param_groups for p in group["params"]]


def _check_state(state: TrainState, model, optimizer) -> None:
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("state holds another model or optimizer than this step")


def make_clip_pretrain_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    loss_name: str = "clip_self_distill",
    temperature: float = 2.0,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    max_grad_norm: Optional[float] = 1.0,
    local_loss_mesh=None,
    ema_decay: float = 0.0,
):
    """The phase-A step for ``model`` and ``optimizer`` (built by
    ``optim.make_optimizer`` with ``label_fn``); the state passed to the step
    must hold these two. ``max_grad_norm`` is the clip the JAX package puts
    in its gradient transformation (``base_transform``). ``ema_decay``
    moves ``state.ema_params`` after each update, when the state has them
    (``TrainState.create(..., ema=True)``)."""
    contrastive = _contrastive(loss_name, temperature)
    if local_loss_mesh is not None:
        raise _not_ported("the local-loss (sharded) contrastive form", "A7")
    params = _check_groups(model, optimizer, label_fn)
    names = [n for n, _ in model.named_parameters()]
    live = [p for _, p in model.named_parameters()]
    scale = getattr(model, "logit_scale", None)

    def step(state: TrainState, batch: Batch, lrs: Mapping[str, float],
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Metrics]:
        _check_state(state, model, optimizer)
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        model.train()
        img_f, txt_f = model(images, batch["input_ids"], batch["attention_mask"],
                             generator=generator)
        loss = contrastive(txt_f, img_f, dict(model.named_parameters(recurse=False)))
        loss.backward()
        # JAX differentiates every parameter: the heads the forward skips get
        # zero gradients, so that AdamW decays them as optax does
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_grad_norm is not None:
            clip_by_global_norm_(params, max_grad_norm)
        optimizer.step()
        if scale is not None:
            # the parameter itself is clamped (open-CLIP): a clamp in the
            # loss alone would zero its gradient once a step overshot
            with torch.no_grad():
                scale.clamp_(max=_LOG_SCALE_MAX)
        if ema_decay and state.ema_params is not None:
            update_ema([state.ema_params[n] for n in names], live, state.step, ema_decay)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_clip_eval_step(
    model,
    loss_name: str = "clip_self_distill",
    temperature: float = 2.0,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_ema: bool = False,
):
    """``step(state, batch) -> {"loss"}`` in eval mode (running BatchNorm
    statistics, no dropout) with the pretrain loss; ``use_ema`` scores the
    EMA parameters (``state.ema_params``) with the live BatchNorm
    statistics."""
    contrastive = _contrastive(loss_name, temperature)

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        m = state.model.eval()
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        if use_ema:
            variables = state.to_variables(use_ema=True)
            img_f, txt_f = functional_call(
                m, variables, (images, batch["input_ids"], batch["attention_mask"]))
        else:
            variables = dict(m.named_parameters(recurse=False))
            img_f = m.encode_image(images)
            txt_f = m.encode_text(batch["input_ids"], batch["attention_mask"])
        return {"loss": contrastive(txt_f, img_f, variables)}

    return step


def make_adapter_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Phase B, the C-Adapter (02 nb cells 28-29): the image tower and its
    projection run in eval mode under ``no_grad`` (running BatchNorm
    statistics, no dropout), then ``adapter_logits`` and BCE in fp32; only
    the adapter trains.

    ``optimizer`` is ``make_optimizer(model, make_label_fn(["adapter"]))``
    with no weight decay, and ``lrs`` is ``{"adapter": lr, "default": 0.0}``:
    the JAX CLI's Adam without clipping (``base_transform(None, 0.0)``). The
    JAX step masks every update but the adapter's (``freeze_mask``); here no
    other parameter gets a gradient, so AdamW skips them, and they and the
    BatchNorm statistics stay bit-equal."""
    _check_groups(model, optimizer, label_fn)

    def step(state: TrainState, batch: Batch, lrs: Mapping[str, float],
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Metrics]:
        _check_state(state, model, optimizer)
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        model.eval()
        with torch.no_grad():
            feats = model.encode_image(images)
        loss = bce_with_logits_loss(model.adapter_logits(feats), batch["labels"])
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_adapter_eval_step(
    model,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """``step(state, batch) -> {"loss", "probs"}``: the adapter's BCE and
    sigmoid probabilities [B, C] in eval mode."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        m = state.model.eval()
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        logits = m.adapter_logits(m.encode_image(images))
        return {"loss": bce_with_logits_loss(logits, batch["labels"]),
                "probs": torch.sigmoid(logits)}

    return step


def make_shared_adapter_train_step(*args, **kwargs):
    """The shared-embedding adapter (03 nb "nouse" variant)."""
    raise _not_ported("the shared-embedding adapter step", "A8")


def make_shared_adapter_eval_step(*args, **kwargs):
    """The shared-embedding adapter's eval step."""
    raise _not_ported("the shared-embedding adapter eval step", "A8")
