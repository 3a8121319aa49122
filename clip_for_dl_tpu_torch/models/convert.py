"""JAX/flax CXRClip weights → the port's ``CXRClip`` state dict.

Takes the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of a variables dict gives them) and
returns a state dict that ``CXRClip.load_state_dict(..., strict=True)``
accepts:

- Dense kernel [in, out] → ``weight`` [out, in]; bias as is;
- Conv kernel HWIO → ``weight`` OIHW;
- BatchNorm scale/bias → weight/bias, batch statistics mean/var →
  running_mean/running_var (``num_batches_tracked`` 0);
- LayerNorm scale/bias → weight/bias; Embed embedding → weight.

Names are the ones ``clip_for_dl_tpu/models/torch_export.py`` emits
(torchvision ResNet, HF BertModel, the reference's head attributes) under
the port's module prefixes; ``tests/test_torch_models.py`` holds the two
equal. A ViT image tower gets torchvision ``vit_b_16`` names, the ones the
JAX ``import_torchvision_vit_b16`` reads (``tests/test_torch_vit.py`` holds
the round trip): the patch Dense kernel [P·P·C, hidden] becomes
``conv_proj.weight`` [hidden, C, P, P], and q/k/v stack into ``in_proj_*``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _conv(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}


def _batchnorm(p, stats, prefix: str) -> Dict[str, torch.Tensor]:
    out = _norm(p, prefix)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def _resnet(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    sd = _conv(params["conv1"], f"{prefix}.conv1")
    sd.update(_batchnorm(params["bn1"], stats["bn1"], f"{prefix}.bn1"))
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        dst = f"{prefix}.layer{stage}.{block}"
        p, s = params[name], stats[name]
        for i in (1, 2, 3):
            sd.update(_conv(p[f"conv{i}"], f"{dst}.conv{i}"))
            sd.update(_batchnorm(p[f"bn{i}"], s[f"bn{i}"], f"{dst}.bn{i}"))
        if "downsample_conv" in p:
            sd.update(_conv(p["downsample_conv"], f"{dst}.downsample.0"))
            sd.update(_batchnorm(p["downsample_bn"], s["downsample_bn"],
                                 f"{dst}.downsample.1"))
    return sd


def _bert(params, prefix: str) -> Dict[str, torch.Tensor]:
    emb = params["embeddings"]
    sd = {
        f"{prefix}.embeddings.{name}.weight": _t(emb[name]["embedding"])
        for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")
    }
    sd.update(_norm(emb["layer_norm"], f"{prefix}.embeddings.LayerNorm"))
    layers = sorted((k for k in params if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for name in layers:
        p = params[name]
        dst = f"{prefix}.encoder.layer.{name.split('_')[1]}"
        for qkv in ("query", "key", "value"):
            sd.update(_linear(p["attention"][qkv], f"{dst}.attention.self.{qkv}"))
        sd.update(_linear(p["attention_output"], f"{dst}.attention.output.dense"))
        sd.update(_norm(p["attention_layer_norm"], f"{dst}.attention.output.LayerNorm"))
        sd.update(_linear(p["intermediate"], f"{dst}.intermediate.dense"))
        sd.update(_linear(p["output"], f"{dst}.output.dense"))
        sd.update(_norm(p["output_layer_norm"], f"{dst}.output.LayerNorm"))
    return sd


def _vit(params, prefix: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(params["patch_embed"]["kernel"])  # [P·P·C, hidden], (P, P, C) order
    n, hidden = kernel.shape
    channels = 3  # the image prep's RGB output
    patch = int(round((n / channels) ** 0.5))
    sd = {
        f"{prefix}.conv_proj.weight": _t(
            kernel.reshape(patch, patch, channels, hidden).transpose(3, 2, 0, 1)),
        f"{prefix}.conv_proj.bias": _t(params["patch_embed"]["bias"]),
        f"{prefix}.class_token": _t(params["class_token"]),
        f"{prefix}.encoder.pos_embedding": _t(params["pos_embedding"]),
    }
    sd.update(_norm(params["ln"], f"{prefix}.encoder.ln"))
    layers = sorted((k for k in params if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for name in layers:
        p = params[name]
        dst = f"{prefix}.encoder.layers.encoder_layer_{name.split('_')[1]}"
        qkv = [p[k] for k in ("q_proj", "k_proj", "v_proj")]
        sd.update(_norm(p["ln_1"], f"{dst}.ln_1"))
        sd[f"{dst}.self_attention.in_proj_weight"] = _t(
            np.concatenate([np.asarray(t["kernel"]).T for t in qkv]))
        sd[f"{dst}.self_attention.in_proj_bias"] = _t(
            np.concatenate([np.asarray(t["bias"]) for t in qkv]))
        sd.update(_linear(p["out_proj"], f"{dst}.self_attention.out_proj"))
        sd.update(_norm(p["ln_2"], f"{dst}.ln_2"))
        sd.update(_linear(p["mlp_1"], f"{dst}.mlp.0"))
        sd.update(_linear(p["mlp_2"], f"{dst}.mlp.3"))
    return sd


def _projection(p, attr: str, prefix: str) -> Dict[str, torch.Tensor]:
    sd = _linear(p["projection"], f"{prefix}.{attr}")
    sd.update(_linear(p["fc"], f"{prefix}.fc"))
    sd.update(_norm(p["layer_norm"], f"{prefix}.layer_norm"))
    return sd


def state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """flax CXRClip (params, batch_stats) → port ``CXRClip`` state dict.
    A ViT image tower (recognized by its ``patch_embed``) has no batch
    statistics."""
    sd: Dict[str, torch.Tensor] = {}
    tower = params["image_tower"]
    if "patch_embed" in tower:
        sd.update(_vit(tower, "image_tower"))
    else:
        sd.update(_resnet(tower, batch_stats["image_tower"], "image_tower"))
    sd.update(_bert(params["text_tower"], "text_tower"))
    sd.update(_projection(params["image_projector"], "image_projection", "image_projector"))
    sd.update(_projection(params["text_projector"], "text_projection", "text_projector"))
    sd.update(_linear(params["view_fusion"]["fc1"], "view_fusion.fusion.0"))
    sd.update(_linear(params["view_fusion"]["fc2"], "view_fusion.fusion.3"))
    sd.update(_linear(params["adapter"]["classifier"], "adapter.classifier"))
    sd.update(_linear(params["shared_adapter"]["classifier"], "shared_adapter.classifier"))
    return sd
