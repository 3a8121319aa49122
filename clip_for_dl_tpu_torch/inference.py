"""Library inference API (counterpart of ``clip_for_dl_tpu.inference``, the
reference's load_model.py).

- :func:`load_trained_model` (0426/load_model.py:35-71): build the model,
  lay tower weight files over it, restore a checkpoint (a port
  ``CheckpointManager`` directory, a reference ``.pth`` or its
  ``.safetensors`` mirror) and cast it for serving.
- :class:`InferenceSession` / :func:`get_model_predictions`
  (0426/load_model.py:73-135): a multi-view uint8 batch → prep (kernel B2)
  → per-view encode → ``MultiViewFusion`` → similarity against the "a chest
  x-ray of {disease}" prompt features (kernel B1) → sigmoid(sim · 4.0) >
  0.5 → (predictions, probabilities).
- :class:`AdapterEngine`: the trained C-Adapter classifier as an engine
  with the surface ``serving.ZeroShotService`` uses.

With ``group`` (``eval`` over a process group) the session and the engine
shard each batch as ``zeroshot.engine.ZeroShotEngine`` does: every rank is
handed the same batch, its rows padded to a multiple of the ranks, each rank
runs its contiguous slice, and the outputs of every rank are gathered in
rank order, so that each rank holds the batch's.

Every entry point that builds or runs a model takes ``device``: the card
when None (``core.device.resolve_device``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .core.config import DISEASE_LABELS, ExperimentConfig, get_preset
from .core.device import cast_matmul_weights, resolve_device, to_device
from .models import CXRClip, init_weights
from .ops.image_prep import preprocess_images
from .ops.similarity import similarity
from .zeroshot.prompts import create_basic_prompts

# the folded weights of an export directory (tools/export_inference.py)
FOLDED_WEIGHTS_FILE = "weights.safetensors"


def _over_group(fn, rows: torch.Tensor, group) -> torch.Tensor:
    """``fn(rows)``, or with ``group`` ``parallel.dp.rows_over_group``."""
    if group is None:
        return fn(rows)
    from .parallel.dp import rows_over_group

    return rows_over_group(fn, rows, group)


def load_trained_model(
    checkpoint: Optional[str] = None,
    config: Optional[ExperimentConfig] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    allow_partial: bool = False,
    use_ema: bool = False,
    init_image_tower: Optional[str] = None,
    init_text_tower: Optional[str] = None,
    device=None,
    fold_bn: bool = False,
) -> CXRClip:
    """The ``CXRClip`` of ``config`` (the ``zero_shot`` preset by default) on
    ``device``, in eval mode, its matmul weights in ``compute_dtype``.

    Weights: drawn from a ``torch.Generator`` seeded with ``seed``; then the
    tower files ``init_image_tower`` / ``init_text_tower`` laid over them
    (the reference's pretrained=True construction, 0425/train.py:761-776);
    then ``checkpoint``, which wins: a ``.pth`` / ``.pt`` / ``.safetensors``
    reference-layout file (modules it lacks keep their weights), or a
    ``CheckpointManager`` directory, whose best epoch is restored (a tensor
    the checkpoint lacks is an error unless ``allow_partial``; an empty
    directory leaves the weights as they are). ``use_ema`` reads the
    directory's EMA slot (written by ``pretrain --ema-decay``) as the
    parameters, with the checkpoint's live BatchNorm statistics; it raises
    where the JAX function raises (no checkpoint, a reference file, an empty
    directory, a checkpoint without the slot).

    ``fold_bn``: a ``CXRClip(config.model, fold_bn=True)`` loaded from the
    folded weights that ``tools/export_inference`` writes (``checkpoint``:
    its ``weights.safetensors``, or the directory holding it), every tensor
    required."""
    cfg = config or get_preset("zero_shot")
    dev = resolve_device(device)
    with torch.device(dev):
        model = CXRClip(cfg.model, fold_bn=fold_bn)
    init_weights(model, torch.Generator(dev).manual_seed(seed))
    if fold_bn:
        from .models.safetensors_io import read_safetensors

        if not checkpoint or use_ema or init_image_tower or init_text_tower:
            raise ValueError("fold_bn loads the folded weights file alone (no EMA slot, "
                             "no tower files)")
        if os.path.isdir(checkpoint):
            checkpoint = os.path.join(checkpoint, FOLDED_WEIGHTS_FILE)
        model.load_state_dict(read_safetensors(checkpoint)[0])
    else:
        _restore(model, checkpoint, allow_partial, use_ema, init_image_tower, init_text_tower)
    if compute_dtype != torch.float32:
        cast_matmul_weights(model, compute_dtype)
    return model.eval()


def _restore(model, checkpoint, allow_partial, use_ema, init_image_tower, init_text_tower):
    """The tower files, then the checkpoint, laid over ``model`` (see
    :func:`load_trained_model`)."""
    from .models.pretrained import init_tower_weights
    from .train.checkpoint import CheckpointManager, import_reference_checkpoint

    if init_image_tower or init_text_tower:
        init_tower_weights(model, init_image_tower, init_text_tower)
    if not checkpoint:
        if use_ema:
            raise ValueError("use_ema requires a checkpoint (no EMA slot exists on a fresh init)")
    elif checkpoint.endswith((".pth", ".pt", ".safetensors")):
        if use_ema:
            raise ValueError(
                "use_ema is not available for reference-layout .pth/.safetensors checkpoints "
                "(they carry no EMA slot)")
        model.load_state_dict(import_reference_checkpoint(checkpoint)["state_dict"],
                              strict=False)
    else:
        mgr = CheckpointManager(checkpoint)
        if use_ema and mgr.best_epoch() is None:
            raise ValueError(f"use_ema: no checkpoint found under {checkpoint} — the "
                             "fresh-init fallback has no EMA slot")
        mgr.restore_variables(model, mgr.best_epoch(), allow_partial=allow_partial,
                              use_ema=use_ema)
        mgr.close()


class InferenceSession:
    """``get_model_predictions`` as a reusable session: the prompt features
    are encoded once. ``model`` is a port ``CXRClip`` on its device (see
    :func:`load_trained_model`); the session runs where its parameters are."""

    def __init__(
        self,
        model: CXRClip,
        tokenizer,
        disease_list: Sequence[str] = DISEASE_LABELS,
        mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
        std: Tuple[float, ...] = (1.0, 1.0, 1.0),
        image_size: int = 224,
        logit_scale: float = 4.0,
        threshold: float = 0.5,
        max_text_length: int = 64,
        group=None,
    ):
        self.model = model.eval()
        self.group = group
        self.device = next(model.parameters()).device
        self.disease_list = list(disease_list)
        self.mean, self.std = tuple(mean), tuple(std)
        self.image_size = image_size
        self.logit_scale = logit_scale
        self.threshold = threshold
        enc = tokenizer.encode(create_basic_prompts(self.disease_list),
                               max_length=max_text_length)
        with torch.inference_mode():
            text = model.encode_text(torch.from_numpy(enc["input_ids"]).to(self.device),
                                     torch.from_numpy(enc["attention_mask"]).to(self.device),
                                     normalize=True)
        self.text_features = text.float()

    @torch.inference_mode()
    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        b = images_u8.shape[0]
        x = preprocess_images(images_u8.reshape(b * 2, *images_u8.shape[2:]),
                              self.image_size, self.image_size, self.mean, self.std,
                              out_dtype=torch.bfloat16)
        fused = self.model.encode_multiview(x.reshape(b, 2, *x.shape[1:]))
        # sigmoid(l2_normalize(fused) · textᵀ · logit_scale) through kernel B1,
        # which normalizes the (unit) text rows once more
        return torch.sigmoid(similarity(fused.float(), self.text_features,
                                        1.0 / self.logit_scale))

    def __call__(self, images_u8) -> Tuple[np.ndarray, np.ndarray]:
        """[B, 2, H, W, C] uint8 (C = 3, or 1 for grey) → (binary predictions
        [B, C], probabilities [B, C])."""
        images = to_device(images_u8, self.device)
        probs = _over_group(self._forward, images, self.group)[:images.shape[0]]
        probs = probs.cpu().numpy()
        return (probs > self.threshold).astype(np.float32), probs


class AdapterEngine:
    """The trained C-Adapter classifier (phase-B models, 02 nb cells 28-30):
    ``sigmoid(Linear(512, C))`` over frozen-tower image features, with the
    engine surface ``serving.ZeroShotService`` uses (``_dispatch``,
    ``logits``, ``probs``): no prompt bank, no text tower."""

    def __init__(
        self,
        model: CXRClip,
        mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
        std: Tuple[float, ...] = (1.0, 1.0, 1.0),
        image_size: int = 224,
        compute_dtype: torch.dtype = torch.bfloat16,
        group=None,
    ):
        self.model = model.eval()
        self.group = group
        self.device = next(model.parameters()).device
        self.mean, self.std = tuple(mean), tuple(std)
        self.image_size = image_size
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def _logits(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = preprocess_images(images_u8, self.image_size, self.image_size, self.mean,
                              self.std, out_dtype=self.compute_dtype)
        feats = self.model.encode_image(x)
        return self.model.adapter_logits(feats).float()

    def _dispatch(self, images_u8) -> Tuple[torch.Tensor, int]:
        """Queue one batch; returns (device logits [B, C], rows): with a
        group, the rows' padding included. A [B, V, H, W, C] batch is
        flattened to its views."""
        imgs = to_device(images_u8, self.device)
        if imgs.dim() == 5:
            imgs = imgs.reshape(-1, *imgs.shape[2:])
        return _over_group(self._logits, imgs, self.group), imgs.shape[0]

    def logits(self, images_u8) -> np.ndarray:
        out, n_real = self._dispatch(images_u8)
        return out.cpu().numpy()[:n_real]

    def probs(self, images_u8) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits(images_u8)))


def get_model_predictions(
    model: CXRClip,
    images_u8,
    tokenizer,
    disease_list: Sequence[str] = DISEASE_LABELS,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot convenience wrapper (prefer InferenceSession for loops)."""
    return InferenceSession(model, tokenizer, disease_list, **kwargs)(images_u8)
