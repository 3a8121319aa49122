"""The port's main paths set up at full width from a seed: the models, the
zero-shot engine, the phase-A step and their inputs, as ``chip_smoke.py``
drives them and ``profile_paths`` profiles them. Weights are random (the
real ones are not in the repo); images are grey uint8 noise; reports are
random words of the dev vocabulary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import DISEASE_LABELS, get_preset
from ..core.device import cast_in_forward, cast_matmul_weights
from ..models import CXRClip, init_weights
from ..text import BertTokenizer
from ..text.tokenizer import build_dev_vocab
from ..train import make_clip_pretrain_step, make_label_fn, make_optimizer
from ..zeroshot import ZeroShotEngine

# serving path -> (preset, model switches beyond flash attention and the
# fused BERT MLP, which every path turns on)
SERVE_MODELS = {"serve": ("zero_shot", {}), "serve_vit": ("vit", {"vit_fused_mlp": True}),
                "serve_fp32": ("zero_shot", {})}
# serving paths in the parity mode (the JAX CLI's --fp32 --flash-attention):
# fp32 weights and compute, so the attention runs its fp32 kernels and the
# BERT MLP, whose fused kernel takes bf16 only, its plain route
FP32_PATHS = ("serve_fp32",)


def grey_images(rng, n: int, size: int = 512) -> np.ndarray:
    """uint8 [n, size, size, 1]: uniform noise over a per-image brightness
    range, so that images differ in more than their noise."""
    lo = rng.integers(0, 128, (n, 1, 1, 1))
    span = rng.integers(16, 128, (n, 1, 1, 1))
    noise = rng.random((n, size, size, 1), dtype=np.float32)
    return (lo + noise * span).astype(np.uint8)


def tokenizer() -> BertTokenizer:
    return BertTokenizer(build_dev_vocab(DISEASE_LABELS))


def _model(dev, seed: int, preset_name: str, **switches):
    preset = get_preset(preset_name)
    cfg = dataclasses.replace(preset.model, flash_attention=True, bert_fused_mlp=True,
                              **switches)
    with torch.device(dev):
        model = CXRClip(cfg)
    init_weights(model, torch.Generator(dev).manual_seed(seed))
    return preset, cfg, model


def build_engine(dev, seed: int, path: str):
    """(model config, ZeroShotEngine) of serving path ``path``
    (SERVE_MODELS): matmul weights cast to bf16, bf16 compute; fp32 weights
    and compute on the FP32_PATHS."""
    name, switches = SERVE_MODELS[path]
    preset, cfg, model = _model(dev, seed, name, **switches)
    dtype = torch.float32 if path in FP32_PATHS else torch.bfloat16
    if dtype != torch.float32:
        cast_matmul_weights(model, dtype)
    engine = ZeroShotEngine(
        model, tokenizer(), DISEASE_LABELS, preset.zeroshot, preset.augment.mean,
        preset.augment.std, cfg.image_size, cfg.max_text_length, dtype,
    )
    return cfg, engine


def train_model(dev, seed: int, preset_name: str, compute_dtype=torch.bfloat16, **switches):
    """(preset, model config, model): the preset's model at full width with
    flash attention, the fused BERT MLP and the model ``switches`` (such as
    ``vit_fused_mlp_train``), fp32 masters cast to bf16 in the forward (left
    in fp32 when ``compute_dtype`` is fp32), weights from ``seed``."""
    preset, cfg, model = _model(dev, seed, preset_name, **switches)
    if compute_dtype == torch.float32:
        return preset, cfg, model
    return preset, cfg, cast_in_forward(model, compute_dtype)


def base_lrs(preset) -> dict:
    return {**{g.name: g.lr for g in preset.train.groups}, "default": preset.train.lr}


def pretrain_step(model, preset, cfg, compute_dtype=torch.bfloat16, make=None, **step_kw):
    """(optimizer, step): the preset's AdamW over ``model`` and the phase-A
    step (``compute_dtype`` compute, the preset's temperature, prep and
    clip); ``step_kw`` go to the step factory (``make``, by default
    ``make_clip_pretrain_step``): a ``group`` to run data-parallel, the
    ``loss_name``, ``local_loss``."""
    label_fn = make_label_fn([g.name for g in preset.train.groups])
    opt = make_optimizer(model, label_fn, weight_decay=preset.train.weight_decay)
    step = (make or make_clip_pretrain_step)(
        model, opt, label_fn, temperature=cfg.temperature, image_size=cfg.image_size,
        mean=preset.augment.mean, std=preset.augment.std, compute_dtype=compute_dtype,
        max_grad_norm=preset.train.max_grad_norm, **step_kw)
    return opt, step


def train_batch(rng, tok: BertTokenizer, dev, batch: int, length: int) -> dict:
    """``batch`` grey uint8 512x512 images and reports of random words from
    the dev vocabulary, 8 to 260 words long, so that some fill all
    ``length`` tokens and the rest are padded."""
    words = sorted(w for w in tok.vocab if w.isalpha())
    reports = [" ".join(rng.choice(words, n)) for n in rng.integers(8, 260, batch)]
    enc = tok.encode(reports, max_length=length)
    return {"images": torch.from_numpy(grey_images(rng, batch)).to(dev),
            "input_ids": torch.from_numpy(enc["input_ids"]).to(dev),
            "attention_mask": torch.from_numpy(enc["attention_mask"]).to(dev)}
