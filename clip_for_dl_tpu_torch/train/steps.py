"""Train and eval step factories (counterpart of
``clip_for_dl_tpu.train.steps``): the phase-A CLIP pretrain step, the
scripts' multi-view step (with its cross-modal attention variant), the
phase-B C-Adapter step and the shared-embedding adapter step, each with its
eval step.

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
steps read ``images`` and the multi-hot ``labels`` [B, C]. The multi-view
steps read ``images`` [B, 2, H, W, C] (frontal, lateral) and ``labels``,
and take the epoch's prompt-bank text features [C, D] before ``lrs``:
``step(state, batch, text_features, lrs, generator)``.

Every factory takes ``group``, a ``torch.distributed`` process group:
the step then runs data-parallel on this rank's rows of the global batch
(``parallel/dp.py``), as the JAX step runs on a batch-sharded mesh.
BatchNorm takes its statistics over the global batch, the contrastive
losses are their ``losses/global_batch.py`` forms, the gradients are
averaged over the ranks between the backward and the clip, and the metrics
are means over the global batch.

A model with a MoE text tower (``models/moe.py``) routes inside
``moe.routing(group)``: over the global batch, as the JAX steps do. The
pretrain and multi-view train steps add ``config.moe_aux_weight`` × the sum
of the layers' aux losses to the loss (the JAX steps' sown ``losses``); the
eval and adapter steps route the same way and add nothing.

The pretrain losses are ``clip_self_distill``, ``info_nce`` and
``siglip``. A model built with ``learnable_temperature`` trains its scale
s = exp(min(logit_scale, log 100)) and bias: the softmax losses run at
T = 1/s, siglip at (s, b); without it siglip runs at the paper's s = 10,
b = -10 and ignores T.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..losses import (
    asymmetric_loss,
    bce_with_logits_loss,
    clip_self_distill_loss,
    info_nce_loss,
    multilabel_contrastive_loss,
    siglip_loss,
)
from ..losses import global_batch
from ..models.moe import routing
from ..models.resnet import batch_norm_context
from ..ops.augment import augment_batch
from ..ops.image_prep import preprocess_images
from ..ops.similarity import l2_normalize
from ..parallel.dp import all_reduce_grads_, global_mean
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


# PRETRAIN_LOSSES over a process group's global batch, ``(txt, img, t,
# group)``: the all-gather forms, and with local_loss the block forms
# (siglip's is the ring)
GLOBAL_LOSSES = {
    "clip_self_distill": global_batch.global_clip_self_distill_loss,
    "info_nce": lambda txt, img, t, group: global_batch.global_info_nce_loss(img, txt, t,
                                                                             group),
    "siglip": lambda txt, img, t, group: global_batch.global_siglip_loss(txt, img,
                                                                         group=group),
}
LOCAL_LOSSES = {
    "clip_self_distill": global_batch.local_clip_self_distill_loss,
    "info_nce": lambda txt, img, t, group: global_batch.local_info_nce_loss(img, txt, t,
                                                                            group),
    "siglip": lambda txt, img, t, group: global_batch.ring_siglip_loss(txt, img, group=group),
}


def _learned_scale(params: Mapping[str, torch.Tensor]):
    """(s, b) from the model's calibration scalars, or None for a model
    built without ``learnable_temperature``."""
    if "logit_scale" not in params:
        return None
    log_s = params["logit_scale"].float()
    s = torch.exp(torch.minimum(log_s, torch.tensor(_LOG_SCALE_MAX, device=log_s.device)))
    return s, params["logit_bias"].float()


def _contrastive(loss_name: str, temperature: float, group=None,
                 local_loss: bool = False) -> Callable:
    """``loss(txt, img, params)``: the pretrain loss at the model's learned
    scale where it has one, else at ``temperature``; with ``group`` over the
    global batch (``local_loss``: in block form)."""
    if group is None:
        if local_loss:
            raise ValueError("the local-loss form needs a process group (a dp mesh)")
        base, sig = PRETRAIN_LOSSES[loss_name], siglip_loss
    else:
        base = functools.partial((LOCAL_LOSSES if local_loss else GLOBAL_LOSSES)[loss_name],
                                 group=group)
        sig = functools.partial(global_batch.ring_siglip_loss if local_loss
                                else global_batch.global_siglip_loss, group=group)

    def loss(txt_f, img_f, params):
        sb = _learned_scale(params)
        if sb is None:
            return base(txt_f, img_f, temperature)
        if loss_name == "siglip":
            return sig(txt_f, img_f, *sb)
        return base(txt_f, img_f, 1.0 / sb[0])

    return loss


def _aux_weight(model) -> float:
    return getattr(getattr(model, "config", None), "moe_aux_weight", 0.0)


def _with_aux(loss: torch.Tensor, aux: List[torch.Tensor], weight: float) -> torch.Tensor:
    """The loss plus ``weight`` × Σ the MoE layers' aux losses, when a MoE
    layer ran (the JAX steps' ``if sown``)."""
    return loss + weight * sum(aux) if aux else loss


def _reduce_grads(params, group) -> None:
    """With a group, every gradient becomes its mean over the ranks."""
    if group is not None:
        all_reduce_grads_([p for p in params if p.grad is not None], group)


def _global(x: torch.Tensor, group) -> torch.Tensor:
    """A metric's mean over this rank's rows → over the global batch."""
    return x if group is None else global_mean(x, group)


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
    ema_decay: float = 0.0,
    group=None,
    local_loss: bool = False,
    model_group=None,
    encode_text: Optional[Callable] = None,
):
    """The phase-A step for ``model`` and ``optimizer`` (built by
    ``optim.make_optimizer`` with ``label_fn``); the state passed to the step
    must hold these two. ``max_grad_norm`` is the clip the JAX package puts
    in its gradient transformation (``base_transform``). ``ema_decay``
    moves ``state.ema_params`` after each update, when the state has them
    (``TrainState.create(..., ema=True)``). ``local_loss`` (with ``group``)
    is the JAX step's ``local_loss_mesh``: the contrastive loss in block
    form, each rank scoring its [b, B_global] block (siglip: the ring).
    ``model_group`` is tensor parallelism's (``parallel/tp.py
    step_groups``, ``group`` then the data group): the clip sums the
    sharded parameters' squares over it. ``encode_text(input_ids,
    attention_mask, generator)`` takes the text half of the joint forward
    (``parallel/pp.py``'s pipelined tower); a parameter that takes no
    gradient (``requires_grad`` off: another stage's layer there) takes no
    part in the update."""
    contrastive = _contrastive(loss_name, temperature, group, local_loss)
    params = _check_groups(model, optimizer, label_fn)
    names = [n for n, _ in model.named_parameters()]
    live = [p for _, p in model.named_parameters()]
    scale = getattr(model, "logit_scale", None)
    aux_weight = _aux_weight(model)

    def step(state: TrainState, batch: Batch, lrs: Mapping[str, float],
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Metrics]:
        _check_state(state, model, optimizer)
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        model.train()
        with batch_norm_context(group), routing(group) as aux:
            if encode_text is None:
                img_f, txt_f = model(images, batch["input_ids"], batch["attention_mask"],
                                     generator=generator)
            else:
                img_f = model.encode_image(images, generator=generator)
                txt_f = encode_text(batch["input_ids"], batch["attention_mask"], generator)
        loss = _with_aux(contrastive(txt_f, img_f, dict(model.named_parameters(recurse=False))),
                         aux, aux_weight)
        loss.backward()
        # JAX differentiates every parameter: the heads the forward skips get
        # zero gradients, so that AdamW decays them as optax does
        trained = [p for p in params if p.requires_grad]
        for p in trained:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _reduce_grads(trained, group)
        if max_grad_norm is not None:
            clip_by_global_norm_(trained, max_grad_norm, model_group)
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
    group=None,
):
    """``step(state, batch) -> {"loss"}`` in eval mode (running BatchNorm
    statistics, no dropout) with the pretrain loss; ``use_ema`` scores the
    EMA parameters (``state.ema_params``) with the live BatchNorm
    statistics."""
    contrastive = _contrastive(loss_name, temperature, group)

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        m = state.model.eval()
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        with routing(group):
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
    group=None,
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
        _reduce_grads(model.parameters(), group)
        optimizer.step()
        state.step += 1
        return state, {"loss": _global(loss.detach(), group)}

    return step


def make_adapter_eval_step(
    model,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    group=None,
):
    """``step(state, batch) -> {"loss", "probs"}``: the adapter's BCE and
    sigmoid probabilities [B, C] in eval mode (with ``group``: the loss over
    the global batch, the probabilities of this rank's rows)."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        m = state.model.eval()
        images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        logits = m.adapter_logits(m.encode_image(images))
        return {"loss": _global(bce_with_logits_loss(logits, batch["labels"]), group),
                "probs": torch.sigmoid(logits)}

    return step


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can run a method other than ``forward``
    with other parameters (under the prefix ``model.``)."""

    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _prep_views(batch: Batch, image_size, mean, std, compute_dtype):
    """[B, 2, H, W, C] uint8 → (B, the 2B views through B2, flattened, in
    the compute dtype)."""
    imgs = batch["images"]
    b = imgs.shape[0]
    flat = imgs.reshape(b * 2, *imgs.shape[2:])
    return b, preprocess_images(flat, image_size, image_size, mean, std, compute_dtype)


def _multiview_loss(model, feats, text_features, labels, temperature, use_enhance,
                    group=None):
    """(loss, logits or None): the multilabel contrastive loss of the fused
    features against the bank (with ``group``, over the global batch), or
    with ``use_enhance`` the asymmetric loss of
    l2_normalize(enhance(feats, bank)) · bankᵀ / T (a mean over rows: this
    rank's rows' mean, which the gradient average makes global)."""
    if not use_enhance:
        if group is not None:
            return global_batch.global_multilabel_contrastive_loss(
                feats, text_features, labels, temperature, group), None
        return multilabel_contrastive_loss(feats, text_features, labels, temperature), None
    enhanced, _ = model.enhance(feats, text_features)
    logits = l2_normalize(enhanced).float() @ text_features.float().T / temperature
    return asymmetric_loss(logits, labels), logits


def make_multiview_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    temperature: float = 0.07,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_enhance: bool = False,
    augment: bool = False,
    flip_prob: float = 0.5,
    rotation_degrees: float = 10.0,
    translate_frac: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
    ema_decay: float = 0.0,
    group=None,
):
    """The scripts' training step (0426/train.py): (frontal, lateral) exams
    against the epoch's prompt-bank features [C, D] (encoded once an epoch,
    not per batch). One B2 call over the 2B views writes the compute dtype;
    with ``augment`` the scripts' flip / rotate / translate stack
    (``ops/augment.py``) widens them to fp32, warps and casts back, its
    parameters drawn from ``generator`` before the fusion's dropout mask;
    then ``encode_multiview`` in train mode, and the multilabel contrastive
    loss, or with ``use_enhance`` the cross-modal attention and the
    asymmetric loss. Every parameter the forward does not reach (the text
    tower, the adapters) gets a zero gradient, so that AdamW decays it as
    optax does; then the clip, the update and, with ``ema_decay``, the EMA
    as in the pretrain step (the JAX step has the option; the JAX CLI does
    not pass it, and ``make_multiview_eval_step(use_ema=True)`` scores it)."""
    params = _check_groups(model, optimizer, label_fn)
    names = [n for n, _ in model.named_parameters()]
    live = [p for _, p in model.named_parameters()]
    aux_weight = _aux_weight(model)

    def step(state: TrainState, batch: Batch, text_features: torch.Tensor,
             lrs: Mapping[str, float],
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Metrics]:
        _check_state(state, model, optimizer)
        b, images = _prep_views(batch, image_size, mean, std, compute_dtype)
        if augment:
            images = augment_batch(images, generator, flip_prob, rotation_degrees,
                                   translate_frac)
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        model.train()
        with batch_norm_context(group), routing(group) as aux:
            feats = model.encode_multiview(images.reshape(b, 2, *images.shape[1:]),
                                           generator=generator)
        loss, _ = _multiview_loss(model, feats, text_features, batch["labels"], temperature,
                                  use_enhance, group)
        loss = _with_aux(loss, aux, aux_weight)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _reduce_grads(params, group)
        if max_grad_norm is not None:
            clip_by_global_norm_(params, max_grad_norm)
        optimizer.step()
        if ema_decay and state.ema_params is not None:
            update_ema([state.ema_params[n] for n in names], live, state.step, ema_decay)
        state.step += 1
        return state, {"loss": _global(loss.detach(), group) if use_enhance else loss.detach()}

    return step


def make_multiview_eval_step(
    model,
    temperature: float = 0.07,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_enhance: bool = False,
    threshold: float = 0.5,
    use_ema: bool = False,
    group=None,
):
    """``step(state, batch, text_features) -> {"loss", "probs",
    "sample_accuracy", "per_class_accuracy"}`` in eval mode, un-augmented:
    the training loss, sigmoid probabilities of the logits (the enhanced
    ones, or the plain product l2_normalize(f) · l2_normalize(t)ᵀ / T),
    and the accuracies of the predictions at ``threshold`` (per exam, in
    percent, averaged; per class). ``use_ema`` scores the EMA parameters
    with the live BatchNorm statistics."""

    def forward(m, x, text_features, labels):
        feats = m.encode_multiview(x)
        loss, logits = _multiview_loss(m, feats, text_features, labels, temperature,
                                       use_enhance, group)
        if logits is None:
            logits = (l2_normalize(feats.float()) @ l2_normalize(text_features.float()).T
                      / temperature)
        return loss, logits

    @torch.no_grad()
    def step(state: TrainState, batch: Batch, text_features: torch.Tensor) -> Metrics:
        m = state.model.eval()
        b, images = _prep_views(batch, image_size, mean, std, compute_dtype)
        args = (images.reshape(b, 2, *images.shape[1:]), text_features, batch["labels"])
        if use_ema:
            variables = {f"model.{k}": v for k, v in state.to_variables(True).items()}
            loss, logits = functional_call(_Bound(m, forward), variables, args)
        else:
            loss, logits = forward(m, *args)
        probs = torch.sigmoid(logits)
        correct = ((probs > threshold).float() == batch["labels"].float()).float()
        if use_enhance:
            loss = _global(loss, group)
        return {"loss": loss, "probs": probs,
                "sample_accuracy": _global(correct.mean(dim=1).mean(), group) * 100.0,
                "per_class_accuracy": _global(correct.mean(dim=0), group)}

    return step


def _report_features(model, batch: Batch, image_size, mean, std, compute_dtype, group=None):
    """(image features, report text features) of the frozen towers in eval
    mode, under ``no_grad``; a MoE text tower routes over ``group``'s
    global batch."""
    images = preprocess_images(batch["images"], image_size, image_size, mean, std,
                               compute_dtype)
    model.eval()
    with torch.no_grad(), routing(group):
        return (model.encode_image(images),
                model.encode_text(batch["input_ids"], batch["attention_mask"]))


def make_shared_adapter_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    group=None,
):
    """The shared-embedding adapter (the 03 notebook's "nouse" variant): a
    Linear over concat(image features, the report's text features) with
    BCE; both towers frozen, in eval mode. Batch: ``images`` [B, H, W, C]
    uint8, ``input_ids`` / ``attention_mask``, ``labels``.

    ``optimizer`` is ``make_optimizer(model, make_label_fn(["shared_adapter"]))``
    with no weight decay, and ``lrs`` is ``{"shared_adapter": lr,
    "default": 0.0}``: the JAX CLI's Adam without clipping under
    ``freeze_mask``. Only the shared adapter gets a gradient, so every other
    parameter and the BatchNorm statistics stay bit-equal."""
    _check_groups(model, optimizer, label_fn)

    def step(state: TrainState, batch: Batch, lrs: Mapping[str, float],
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Metrics]:
        _check_state(state, model, optimizer)
        img_f, txt_f = _report_features(model, batch, image_size, mean, std, compute_dtype,
                                        group)
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        loss = bce_with_logits_loss(model.shared_adapter_logits(img_f, txt_f), batch["labels"])
        loss.backward()
        _reduce_grads(model.parameters(), group)
        optimizer.step()
        state.step += 1
        return state, {"loss": _global(loss.detach(), group)}

    return step


def make_shared_adapter_eval_step(
    model,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    group=None,
):
    """``step(state, batch) -> {"loss", "probs"}``: the shared adapter's BCE
    and sigmoid probabilities [B, C] (03 nb cell 30)."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        img_f, txt_f = _report_features(state.model, batch, image_size, mean, std,
                                        compute_dtype, group)
        logits = state.model.shared_adapter_logits(img_f, txt_f)
        return {"loss": _global(bce_with_logits_loss(logits, batch["labels"]), group),
                "probs": torch.sigmoid(logits)}

    return step
