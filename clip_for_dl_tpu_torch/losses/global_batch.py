"""Global-batch contrastive losses over a process group (counterpart of
``clip_for_dl_tpu.losses.global_batch``).

Each rank holds its rows of the features. Two forms of every loss:

- ``global_*``: gather the features of every rank (in rank order), compute
  the B_global × B_global loss on every rank, and take the mean over the
  ranks of the identical values;
- ``local_*``: gather the features only, score this rank's [b, B_global]
  block, and take the mean over the ranks: the identical loss and gradients
  with a similarity block N times smaller on each rank.

:func:`ring_siglip_loss` is SigLIP in constant memory: each rank scores its
image block against the text block in hand ([b, b] logits) and passes that
block on round the ring; after N rounds every pair has been scored once. Its
backward sends each text block's gradient back the way the block came.

Gradients: see ``parallel/collectives.py``. Every form hands each rank N
times the gradient of its own rows, and the data-parallel step's average
brings that back to the loss's gradient, as the JAX package's all-gather
transposes do over its mesh.

``group=None`` is the default process group.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from ..ops.similarity import l2_normalize
from ..parallel.collectives import _group, all_gather_rows, all_reduce_sum, pmean, ring_shift
from .contrastive import (
    clip_self_distill_loss,
    info_nce_loss,
    multilabel_contrastive_loss,
    siglip_loss,
    soft_cross_entropy,
)


def global_clip_self_distill_loss(text_features, image_features, temperature=2.0,
                                  group=None) -> torch.Tensor:
    txt = all_gather_rows(text_features, group)
    img = all_gather_rows(image_features, group)
    return pmean(clip_self_distill_loss(txt, img, temperature), group)


def global_info_nce_loss(image_features, text_features, temperature=1.0,
                         group=None) -> torch.Tensor:
    img = all_gather_rows(image_features, group)
    txt = all_gather_rows(text_features, group)
    return pmean(info_nce_loss(img, txt, temperature), group)


def global_multilabel_contrastive_loss(image_features, text_features, labels,
                                       temperature=1.0, group=None) -> torch.Tensor:
    """Image rows and labels are this rank's; the per-class text matrix is
    the same on every rank, so only images and labels gather."""
    img = all_gather_rows(image_features, group)
    lbl = all_gather_rows(labels, group)
    return pmean(multilabel_contrastive_loss(img, text_features, lbl, temperature), group)


def global_siglip_loss(text_features, image_features, logit_scale=10.0, logit_bias=-10.0,
                       group=None) -> torch.Tensor:
    """The all-gather form: the B_global × B_global sigmoid loss on every
    rank. :func:`ring_siglip_loss` keeps [b, b]."""
    txt = all_gather_rows(text_features, group)
    img = all_gather_rows(image_features, group)
    return pmean(siglip_loss(txt, img, logit_scale, logit_bias), group)


def ring_siglip_loss(text_features, image_features, logit_scale=10.0, logit_bias=-10.0,
                     group=None) -> torch.Tensor:
    """SigLIP over the global batch with [b, b] logits a round (the SigLIP
    paper's chunked ring, Zhai et al. 2023, §3.1): round 0 scores this
    rank's own text block, which holds the positives; each later round the
    block of the rank before."""
    group = _group(group)
    n = torch.distributed.get_world_size(group)
    txt = l2_normalize(text_features.float())
    img = l2_normalize(image_features.float())
    b = img.shape[0]
    eye = torch.eye(b, device=img.device)
    total = img.new_zeros(())
    block = txt
    for i in range(n):
        logits = img @ block.T * logit_scale + logit_bias
        z = 2.0 * eye - 1.0 if i == 0 else -torch.ones_like(eye)
        total = total + F.softplus(-z * logits).sum()
        if i + 1 < n:
            block = ring_shift(block, group)
    # Σ over this rank's b rows × every column; the sum over the ranks
    # covers all pairs, / B_global
    return all_reduce_sum(total, group) / (n * b)


def _local_rows(b: int, group, device) -> torch.Tensor:
    """Global row indices of this rank's block."""
    return torch.distributed.get_rank(_group(group)) * b + torch.arange(b, device=device)


def local_info_nce_loss(image_features, text_features, temperature=1.0,
                        group=None) -> torch.Tensor:
    """InfoNCE over the global batch from [b, B] blocks; the value and the
    gradients of :func:`global_info_nce_loss`."""
    img, txt = image_features.float(), text_features.float()
    b = img.shape[0]
    img_g = all_gather_rows(img, group)
    txt_g = all_gather_rows(txt, group)
    one_hot = F.one_hot(_local_rows(b, group, img.device), img_g.shape[0]).float()
    loss_i = soft_cross_entropy((img @ txt_g.T) / temperature, one_hot).mean()
    loss_t = soft_cross_entropy((txt @ img_g.T) / temperature, one_hot).mean()
    return pmean((loss_i + loss_t) / 2.0, group)


def local_clip_self_distill_loss(text_features, image_features, temperature=2.0,
                                 group=None) -> torch.Tensor:
    """The self-distill CLIP loss in local form. Its target matrix
    softmax_rows(S), S = (img·imgᵀ + txt·txtᵀ)/2·T, is built on a symmetric S,
    so the transposed targets of this rank's image-side rows need only the
    global rows' log-normalizers, not the [B, B] matrix. Each is kept as the
    row's largest entry m (exact) and the small log l = log Σ exp(S − m),
    since S reaches |f|²·T (~1e3 on raw features), where rounding m + l
    would cost ~6e-5 in every target."""
    txt, img = text_features.float(), image_features.float()
    img_g = all_gather_rows(img, group)
    txt_g = all_gather_rows(txt, group)
    s_local = (img @ img_g.T + txt @ txt_g.T) / 2.0 * temperature  # [b, B]
    targets_rows = torch.softmax(s_local, dim=-1)
    m = s_local.detach().amax(-1)  # a shift: the normalized value does not depend on it
    l = torch.log(torch.exp(s_local - m[:, None]).sum(-1))
    norm_g = all_gather_rows(torch.stack([m, l], dim=-1), group)  # [B, 2]
    # (targetsᵀ)[j, i] = exp(S[i, j] − m_i − l_i) = exp(S[j, i] − m_i − l_i) by symmetry
    targets_cols = torch.exp((s_local - norm_g[None, :, 0]) - norm_g[None, :, 1])
    texts_loss = soft_cross_entropy((txt @ img_g.T) / temperature, targets_rows)
    images_loss = soft_cross_entropy((img @ txt_g.T) / temperature, targets_cols)
    return pmean(((texts_loss + images_loss) / 2.0).mean(), group)


def make_global(loss_fn: Callable[..., torch.Tensor], group=None,
                n_gather: int = 2) -> Callable[..., torch.Tensor]:
    """Any loss(a, b, ...) over the global batch: its first ``n_gather``
    tensor arguments gathered over the group, the value averaged."""

    @functools.wraps(loss_fn)
    def wrapped(*args, **kwargs):
        gathered = tuple(all_gather_rows(a, group) if i < n_gather else a
                         for i, a in enumerate(args))
        return pmean(loss_fn(*gathered, **kwargs), group)

    return wrapped
