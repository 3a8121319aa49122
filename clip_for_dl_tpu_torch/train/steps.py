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
``lrs``. Batches are dicts of device tensors: ``images`` uint8 [B, H, W, C],
``input_ids`` and ``attention_mask`` [B, L]; the adapter steps read
``images`` and the multi-hot ``labels`` [B, C].
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..losses import bce_with_logits_loss, clip_self_distill_loss
from ..ops.image_prep import preprocess_images
from .optim import clip_by_global_norm_, set_group_lrs
from .state import TrainState

Batch = Mapping[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

PRETRAIN_LOSSES = {"clip_self_distill": clip_self_distill_loss}


def _not_ported(what: str, item: str = "A3") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _pretrain_loss(loss_name: str) -> Callable:
    if loss_name not in PRETRAIN_LOSSES:
        raise _not_ported(f"pretrain loss {loss_name!r}")
    return PRETRAIN_LOSSES[loss_name]


def _check_model(model) -> None:
    if getattr(getattr(model, "config", None), "learnable_temperature", False):
        raise _not_ported("learnable temperature")


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
    in its gradient transformation (``base_transform``)."""
    loss_fn = _pretrain_loss(loss_name)
    _check_model(model)
    if local_loss_mesh is not None:
        raise _not_ported("the local-loss (sharded) contrastive form")
    if ema_decay:
        raise _not_ported("EMA of the parameters")
    params = _check_groups(model, optimizer, label_fn)

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
        loss = loss_fn(txt_f, img_f, temperature)
        loss.backward()
        # JAX differentiates every parameter: the heads the forward skips get
        # zero gradients, so that AdamW decays them as optax does
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_grad_norm is not None:
            clip_by_global_norm_(params, max_grad_norm)
        optimizer.step()
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
    statistics, no dropout) with the pretrain loss."""
    loss_fn = _pretrain_loss(loss_name)
    _check_model(model)
    if use_ema:
        raise _not_ported("EMA of the parameters")

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        m = state.model.eval()
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        img_f = m.encode_image(images)
        txt_f = m.encode_text(batch["input_ids"], batch["attention_mask"])
        return {"loss": loss_fn(txt_f, img_f, temperature)}

    return step


def make_adapter_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    ema_decay: float = 0.0,
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
    if ema_decay:
        raise _not_ported("EMA of the parameters")
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
