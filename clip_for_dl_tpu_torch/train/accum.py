"""Gradient accumulation for contrastive pretraining, in GradCache form
(counterpart of ``clip_for_dl_tpu.train.accum``).

Accumulating microbatch gradients would shrink the contrastive negatives to
the microbatch. GradCache (Gao et al.; open-CLIP's large-batch form) keeps
the loss over the full batch in three passes:

1. **Features**: the towers over each microbatch in train mode under
   ``no_grad``, one microbatch at a time (the activations of one microbatch
   live at once); BatchNorm's running statistics move once per microbatch,
   in order.
2. **Loss**: the full-batch contrastive loss on the cached [B, D] features
   and its gradient with respect to them.
3. **Backward**: each microbatch's forward again, with gradient, then
   ``backward`` of its slice of the feature gradient; the parameter
   gradients add up over the microbatches.

Pass 3 replays pass 1: each microbatch's generator states (the model's
dropout layers draw from torch's generator, the attention kernel's seed
from the step's) are restored before its replay, BatchNorm normalizes with
the same microbatch statistics, and the running statistics are not moved a
second time (``batch_norm_context(update_stats=False)``). The chained
gradient is then the full-batch gradient for a tower without BatchNorm
(the ViT), and the JAX step's for one with it.

With ``group``, each rank's batch is its share of every global microbatch
(``parallel.dp.shard_batch(..., microbatches=accum_steps)``), so that a
ResNet's per-microbatch statistics are those of the global microbatch; the
loss of pass 2 is the global-batch form; the gradients are averaged over the
ranks before the clip. The rest (the zero gradients of the heads the
forward skips, the clip, AdamW, the clamp, the EMA) is the pretrain step's.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Tuple

import torch

from ..models.resnet import batch_norm_context
from ..ops.image_prep import preprocess_images
from .optim import clip_by_global_norm_, set_group_lrs
from .state import TrainState
from .steps import (
    _LOG_SCALE_MAX,
    GLOBAL_LOSSES,
    PRETRAIN_LOSSES,
    _check_groups,
    _check_state,
    _reduce_grads,
    update_ema,
)


def _rng_states(device: torch.device, generator: Optional[torch.Generator]):
    states = [torch.get_rng_state()]
    if device.type == "cuda":
        states.append(torch.cuda.get_rng_state(device))
    if generator is not None:
        states.append(generator.get_state())
    return states


def _set_rng_states(device: torch.device, generator: Optional[torch.Generator], states) -> None:
    states = list(states)
    torch.set_rng_state(states.pop(0))
    if device.type == "cuda":
        torch.cuda.set_rng_state(states.pop(0), device)
    if generator is not None:
        generator.set_state(states.pop(0))


def make_accum_clip_pretrain_step(
    model,
    optimizer: torch.optim.Optimizer,
    label_fn,
    accum_steps: int,
    loss_name: str = "clip_self_distill",
    temperature: float = 2.0,
    image_size: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    compute_dtype: torch.dtype = torch.bfloat16,
    max_grad_norm: Optional[float] = 1.0,
    ema_decay: float = 0.0,
    group=None,
):
    """The pretrain step (``steps.make_clip_pretrain_step``'s arguments and
    state) with the towers run in ``accum_steps`` microbatches and the loss
    and its gradient over the full batch. The loss runs at ``temperature``
    (siglip at s = 10, b = -10), as the JAX step's: a learnable scale gets a
    zero gradient, and the command line refuses the combination."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if getattr(getattr(model, "config", None), "text_moe_experts", 0):
        raise ValueError(
            "gradient accumulation does not compose with the MoE text "
            "tower (the sown aux loss bypasses the feature cache)"
        )
    base = (PRETRAIN_LOSSES[loss_name] if group is None
            else functools.partial(GLOBAL_LOSSES[loss_name], group=group))

    params = _check_groups(model, optimizer, label_fn)
    names = [n for n, _ in model.named_parameters()]
    live = [p for _, p in model.named_parameters()]
    scale = getattr(model, "logit_scale", None)
    device = next(model.parameters()).device

    def encode(mb, generator):
        images = preprocess_images(mb["images"], image_size, image_size, mean, std,
                                   compute_dtype)
        return model(images, mb["input_ids"], mb["attention_mask"], generator=generator)

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], lrs: Mapping[str, float],
             generator: Optional[torch.Generator] = None):
        _check_state(state, model, optimizer)
        b = batch["images"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch size {b} must divide into accum_steps={accum_steps}")
        m = b // accum_steps
        mbs = [{k: batch[k][i * m:(i + 1) * m]
                for k in ("images", "input_ids", "attention_mask")}
               for i in range(accum_steps)]
        set_group_lrs(optimizer, lrs)
        optimizer.zero_grad(set_to_none=True)
        model.train()

        # pass 1: features only, the running statistics moved per microbatch
        rng, img_fs, txt_fs = [], [], []
        with torch.no_grad(), batch_norm_context(group):
            for mb in mbs:
                rng.append(_rng_states(device, generator))
                img_f, txt_f = encode(mb, generator)
                img_fs.append(img_f)
                txt_fs.append(txt_f)
        after = _rng_states(device, generator)

        # pass 2: the full-batch loss and its gradient w.r.t. the features
        img_all = torch.cat(img_fs).requires_grad_()
        txt_all = torch.cat(txt_fs).requires_grad_()
        loss = base(txt_all, img_all, temperature)
        g_img, g_txt = torch.autograd.grad(loss, (img_all, txt_all))
        del img_fs, txt_fs, img_all, txt_all

        # pass 3: each microbatch replayed with gradient
        with batch_norm_context(group, update_stats=False):
            for i, mb in enumerate(mbs):
                _set_rng_states(device, generator, rng[i])
                img_f, txt_f = encode(mb, generator)
                torch.autograd.backward(
                    (img_f, txt_f),
                    (g_img[i * m:(i + 1) * m].to(img_f.dtype),
                     g_txt[i * m:(i + 1) * m].to(txt_f.dtype)))
        _set_rng_states(device, generator, after)

        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _reduce_grads(params, group)
        if max_grad_norm is not None:
            clip_by_global_norm_(params, max_grad_norm)
        optimizer.step()
        if scale is not None:
            with torch.no_grad():
                scale.clamp_(max=_LOG_SCALE_MAX)
        if ema_decay and state.ema_params is not None:
            update_ema([state.ema_params[n] for n in names], live, state.step, ema_decay)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step
