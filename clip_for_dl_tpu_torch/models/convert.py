"""JAX/flax CXRClip weights → the port's ``CXRClip`` state dict.

Takes the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of a variables dict gives them) and
returns a state dict that ``CXRClip.load_state_dict(..., strict=True)``
accepts:

- Dense kernel [in, out] → ``weight`` [out, in]; bias as is;
- Conv kernel HWIO → ``weight`` OIHW (and its bias, where a BatchNorm
  was folded into it);
- BatchNorm scale/bias → weight/bias, batch statistics mean/var →
  running_mean/running_var (``num_batches_tracked`` 0);
- LayerNorm scale/bias → weight/bias; Embed embedding → weight;
- the learnable-temperature scalars ``logit_scale`` / ``logit_bias``
  (0-dim) under their own names;
- the cross-modal attention of a ``use_multimodal_attention`` model under
  ``multimodal_attention.{image_proj,text_proj,attention,output_proj}``;
- a MoE layer's ``moe_mlp``: the router as a Dense, ``wi/bi/wo/bo`` as
  they are (``models/moe.py``).

:func:`lora_from_jax` carries a JAX LoRA state ({path: {"a", "b"}}) over
under the port's target names (``models/lora.py``).

Names are the ones ``clip_for_dl_tpu/models/torch_export.py`` emits
(torchvision ResNet, HF BertModel, the reference's head attributes) under
the port's module prefixes; ``tests/test_torch_models.py`` holds the two
equal. A ViT image tower gets torchvision ``vit_b_16`` names, the ones the
JAX ``import_torchvision_vit_b16`` reads (``tests/test_torch_vit.py`` holds
the round trip): the patch Dense kernel [P·P·C, hidden] becomes
``conv_proj.weight`` [hidden, C, P, P], and q/k/v stack into ``in_proj_*``.

A folded ResNet tower (the JAX ``fold_clip_image_tower``'s output: convs
with biases, no BatchNorm, no tower statistics) maps onto
``CXRClip(config, fold_bn=True)``; :func:`fold_clip_image_tower` folds the
port's own state dict the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .lora import LoRA
from .resnet import fold_batchnorm


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _conv(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    sd = {f"{prefix}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:  # a folded BatchNorm's
        sd[f"{prefix}.bias"] = _t(p["bias"])
    return sd


def _batchnorm(p, stats, prefix: str) -> Dict[str, torch.Tensor]:
    out = _norm(p, prefix)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def _resnet(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """A ResNet tower's params and statistics; a folded tower (no ``bn1``)
    has convs with biases and no statistics."""
    folded = "bn1" not in params
    sd = _conv(params["conv1"], f"{prefix}.conv1")
    if not folded:
        sd.update(_batchnorm(params["bn1"], stats["bn1"], f"{prefix}.bn1"))
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        dst = f"{prefix}.layer{stage}.{block}"
        p = params[name]
        for i in (1, 2, 3):
            sd.update(_conv(p[f"conv{i}"], f"{dst}.conv{i}"))
            if not folded:
                sd.update(_batchnorm(p[f"bn{i}"], stats[name][f"bn{i}"], f"{dst}.bn{i}"))
        if "downsample_conv" in p:
            sd.update(_conv(p["downsample_conv"], f"{dst}.downsample.0"))
            if not folded:
                sd.update(_batchnorm(p["downsample_bn"], stats[name]["downsample_bn"],
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
        if "moe_mlp" in p:
            moe = p["moe_mlp"]
            sd.update(_linear(moe["router"], f"{dst}.moe_mlp.router"))
            sd.update({f"{dst}.moe_mlp.{k}": _t(moe[k]) for k in ("wi", "bi", "wo", "bo")})
        else:
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
    statistics, nor has a folded ResNet tower (``fold_clip_image_tower``'s
    output, for ``CXRClip(config, fold_bn=True)``)."""
    sd: Dict[str, torch.Tensor] = {}
    tower = params["image_tower"]
    if "patch_embed" in tower:
        sd.update(_vit(tower, "image_tower"))
    else:
        sd.update(_resnet(tower, batch_stats.get("image_tower"), "image_tower"))
    sd.update(_bert(params["text_tower"], "text_tower"))
    sd.update(_projection(params["image_projector"], "image_projection", "image_projector"))
    sd.update(_projection(params["text_projector"], "text_projection", "text_projector"))
    sd.update(_linear(params["view_fusion"]["fc1"], "view_fusion.fusion.0"))
    sd.update(_linear(params["view_fusion"]["fc2"], "view_fusion.fusion.3"))
    sd.update(_linear(params["adapter"]["classifier"], "adapter.classifier"))
    sd.update(_linear(params["shared_adapter"]["classifier"], "shared_adapter.classifier"))
    if "multimodal_attention" in params:
        for name in ("image_proj", "text_proj", "attention", "output_proj"):
            sd.update(_linear(params["multimodal_attention"][name],
                              f"multimodal_attention.{name}"))
    for name in ("logit_scale", "logit_bias"):
        if name in params:
            sd[name] = _t(params[name])
    return sd


def fold_clip_image_tower(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``CXRClip`` state dict → the state dict of ``CXRClip(config,
    fold_bn=True)``: the ResNet tower's BatchNorm folded into its
    convolutions (``resnet.fold_batchnorm``), every other entry as it is;
    a tower without BatchNorm (the ViT's) stays as it is. Counterpart of the
    JAX ``fold_clip_image_tower``."""
    prefix = "image_tower."
    if prefix + "bn1.weight" not in state_dict:
        return dict(state_dict)
    tower = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in fold_batchnorm(tower).items()})
    return out


# a JAX LoRA path's kernel (below its layer) -> the port's target name
_BERT_LORA = {"attention/query": "attention.self.query", "attention/key": "attention.self.key",
              "attention/value": "attention.self.value",
              "attention_output": "attention.output.dense",
              "intermediate": "intermediate.dense", "output": "output.dense"}
_VIT_LORA = {"q_proj": "self_attention.q_proj", "k_proj": "self_attention.k_proj",
             "v_proj": "self_attention.v_proj", "out_proj": "self_attention.out_proj",
             "mlp_1": "mlp.0", "mlp_2": "mlp.3"}
_HEAD_LORA = {"image_projector/projection": "image_projector.image_projection",
              "text_projector/projection": "text_projector.text_projection",
              "view_fusion/fc1": "view_fusion.fusion.0",
              "view_fusion/fc2": "view_fusion.fusion.3"}


def lora_path_from_jax(path: str) -> str:
    """A JAX LoRA path (``text_tower/layer_0/attention/query/kernel``) →
    the port's target name (``text_tower.encoder.layer.0.attention.self.
    query.weight``)."""
    parts = path.split("/")
    stem = "/".join(parts[:-1])
    if parts[-1] == "kernel" and stem in _HEAD_LORA:
        return _HEAD_LORA[stem] + ".weight"
    if parts[-1] == "kernel" and len(parts) >= 4 and parts[1].startswith("layer_"):
        i, rest = parts[1][len("layer_"):], "/".join(parts[2:-1])
        if parts[0] == "text_tower" and rest in _BERT_LORA:
            return f"text_tower.encoder.layer.{i}.{_BERT_LORA[rest]}.weight"
        if parts[0] == "image_tower" and rest in _VIT_LORA:
            return f"image_tower.encoder.layers.encoder_layer_{i}.{_VIT_LORA[rest]}.weight"
    raise ValueError(f"no port target for the JAX LoRA path {path!r}")


def lora_from_jax(lora: Mapping[str, Mapping[str, Any]]) -> LoRA:
    """A JAX LoRA state {path: {"a" [in, r], "b" [r, out]}} (numpy or JAX
    arrays) → the port's :class:`~.lora.LoRA` in fp32 on the CPU, the
    factors in the same layout."""
    return LoRA({lora_path_from_jax(path): (_t(ab["a"]), _t(ab["b"]))
                 for path, ab in lora.items()})
