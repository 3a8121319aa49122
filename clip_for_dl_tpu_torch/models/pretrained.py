"""Hub-pretrained tower initialization from files (counterpart of
``clip_for_dl_tpu.models.pretrained``).

The reference builds both towers from hub weights at construction
(`0425/train.py:761-776`: torchvision ``resnet50(pretrained=True)`` or
``vit_b_16``, HF ``AutoModel.from_pretrained``). Without hub access the
equivalent is file-based: :func:`init_tower_weights` lays a torchvision or
HF weight file (``.safetensors``, ``.pth``/``.bin`` or an HF snapshot
directory) over a freshly built model. The port's towers carry torchvision
and HF state-dict names, so the files load as they are, under two checks:

- :func:`check_tree_matches`: the file must match the tower key for key and
  shape for shape; the first mismatch raises, so a wrong geometry is a clear
  error instead of training on garbage;
- :func:`cast_tree_like`: every tensor takes the dtype of the tensor it
  replaces, so a half-precision re-upload cannot lower the model's
  precision.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..core.device import plain_name
from .safetensors_io import load_state_dict

# entries a torchvision ResNet file may carry that a model may lack (or the
# file lack): BatchNorm's step counters, which no forward reads
_OPTIONAL = ("num_batches_tracked",)
# HF BertModel buffers and heads that the reference's CLS pooling never reads
_BERT_DROPPED = ("cls.", "pooler.", "embeddings.position_ids", "embeddings.token_type_ids")


def _own(tower: nn.Module) -> Dict[str, str]:
    """Reference name → the tower's own state-dict name (they differ under
    ``core.device.cast_in_forward``'s parametrization)."""
    return {plain_name(k): k for k in tower.state_dict()}


def check_tree_matches(name: str, got: Mapping[str, torch.Tensor],
                       want: Mapping[str, torch.Tensor]) -> None:
    """Raise ValueError at the first key or shape mismatch between imported
    weights and the tower they are meant for. Entries named in _OPTIONAL may
    be absent on either side."""
    required = {k for k in want if not k.endswith(_OPTIONAL)}
    missing = sorted(required - set(got))
    extra = sorted(k for k in got if k not in want and not k.endswith(_OPTIONAL))
    if missing or extra:
        raise ValueError(
            f"{name}: imported weights do not match the model config — missing keys "
            f"{missing[:5]}, unexpected keys {extra[:5]} (check the preset / tower geometry "
            "against the weight file)")
    for k, v in got.items():
        if k in want and tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"{name}: shape mismatch at '{k}': weight file has {tuple(v.shape)}, model "
                f"expects {tuple(want[k].shape)} (check the preset / tower geometry against "
                "the weight file)")


def cast_tree_like(got: Mapping[str, torch.Tensor],
                   want: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each imported tensor in the dtype of the tensor it replaces (shapes
    were checked by :func:`check_tree_matches`)."""
    return {k: v.to(want[k].dtype) for k, v in got.items() if k in want}


def _strip(sd: Mapping[str, torch.Tensor], drop: Sequence[str]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if not k.startswith(tuple(drop))}


def load_image_tower_weights(path: str, image_tower: str) -> Dict[str, torch.Tensor]:
    """Weight file → state dict of the configured image tower: a
    torchvision ``resnet50`` (its ``fc.*`` head dropped, as the reference
    drops it) or ``vit_b_16`` (``heads.*`` dropped)."""
    sd = load_state_dict(path)
    if image_tower == "resnet50":
        return _strip(sd, ("fc.",))
    if image_tower == "vit_b16":
        return _strip(sd, ("heads.",))
    raise ValueError(f"unknown image tower {image_tower!r}")


def load_text_tower_weights(path: str) -> Dict[str, torch.Tensor]:
    """Weight file or HF snapshot directory → BertModel state dict: bare
    (``embeddings...``) or prefixed (``bert.embeddings...``, the
    Bio_ClinicalBERT hub layout); MLM heads, the pooler and HF's position
    and token-type id buffers are dropped."""
    sd = load_state_dict(path)
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
    return _strip(sd, _BERT_DROPPED)


def _overlay(tower: nn.Module, sd: Mapping[str, torch.Tensor], name: str) -> None:
    own = _own(tower)
    current = tower.state_dict()
    want = {ref: current[k] for ref, k in own.items()}
    check_tree_matches(name, sd, want)
    cast = cast_tree_like(sd, want)
    tower.load_state_dict({own[k]: v for k, v in cast.items()}, strict=False)


def init_tower_weights(
    model: nn.Module,
    image_path: Optional[str] = None,
    text_path: Optional[str] = None,
) -> nn.Module:
    """Lay hub-pretrained tower weights over a fresh port ``CXRClip`` in
    place and return it; the heads and adapters keep their initialization
    (the reference trains them from scratch on the pretrained towers). Each
    tower is checked key for key and shape for shape."""
    if image_path:
        _overlay(model.image_tower,
                 load_image_tower_weights(image_path, model.config.image_tower),
                 f"init_image_tower {image_path}")
    if text_path:
        _overlay(model.text_tower, load_text_tower_weights(text_path),
                 f"init_text_tower {text_path}")
    return model
