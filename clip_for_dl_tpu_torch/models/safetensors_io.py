"""Weight files: ``.safetensors`` read and written in plain Python, torch
pickles, HF snapshot directories (counterpart of
``clip_for_dl_tpu.models.safetensors_io``).

The ``.safetensors`` format is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]},
"__metadata__": {str: str}}`` (offsets relative to the end of the header),
then the tensors' raw little-endian bytes. This module reads and writes it
without the ``safetensors`` package, which the GPU machine need not have;
bf16 tensors stay bf16 (``torch.frombuffer``).

- :func:`load_state_dict` reads any weight file a user has on day one into
  a flat ``{name: torch.Tensor}`` mapping on the CPU.
- :func:`save_reference_checkpoint_safetensors` /
  :func:`load_reference_checkpoint_safetensors` mirror the reference's
  ``{epoch, models: {name: state_dict}}`` ``.pth`` layout as a flat file:
  keys ``"{module}.{param}"`` (module names hold no dot), the epoch and a
  format tag in the metadata, under the JAX package's keys, so that a file
  written by either package is read by the other.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# metadata keys of the flat reference-checkpoint layout (the JAX package's)
_FORMAT_KEY = "clip_for_dl_tpu.format"
_FORMAT = "reference-checkpoint-v1"
_EPOCH_KEY = "clip_for_dl_tpu.epoch"

# HF snapshot directories: preferred file order
_HF_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")

# safetensors dtype names <-> torch dtypes
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _tensor(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.detach().cpu().contiguous()


def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """A ``.safetensors`` file → (``{name: tensor}``, metadata)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    meta = dict(header.pop("__metadata__", None) or {})
    body = memoryview(data)[8 + n:]
    tensors: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or end > len(body):
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for "
                             f"shape {shape} of {info['dtype']}")
        if count == 0:
            tensors[name] = torch.empty(shape, dtype=dtype)
        else:
            tensors[name] = torch.frombuffer(body[begin:end], dtype=dtype).reshape(shape)
    return tensors, meta


def save_safetensors(
    tensors: Mapping[str, object],
    path: str,
    metadata: Optional[Mapping[str, str]] = None,
) -> str:
    """Flat ``{name: tensor or array}`` → ``.safetensors`` file. Tensors are
    laid out as the ``safetensors`` package lays them out (wider types
    first, then by name) and the header is space-padded to 8 bytes."""
    flat = {k: _tensor(v) for k, v in tensors.items()}
    order = sorted(flat, key=lambda k: (-flat[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for k in order:
        t = flat[k]
        if t.dtype not in _NAMES:
            raise TypeError(f"{k}: {t.dtype} has no safetensors dtype")
        size = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = flat[k]
            if t.numel():
                # bytes of any dtype, bf16 and bool included, through uint8
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    os.replace(tmp, path)
    return path


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Weight file → flat ``{name: tensor}`` state dict on the CPU.

    Accepts ``*.safetensors``; ``*.pth`` / ``*.pt`` / ``*.bin`` (a torch
    pickle of a flat state dict, loaded with ``weights_only``; nested
    reference checkpoints go through
    ``train.checkpoint.import_reference_checkpoint``); or a directory (an
    HF snapshot), whose ``model.safetensors`` then ``pytorch_model.bin`` is
    read."""
    if os.path.isdir(path):
        for name in _HF_WEIGHT_FILES:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return load_state_dict(cand)
        raise FileNotFoundError(
            f"{path} is a directory but contains none of {_HF_WEIGHT_FILES} "
            "(expected an HF model snapshot)")
    if path.endswith(".safetensors"):
        return read_safetensors(path)[0]
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch refuses arbitrary pickles (nn.Module etc.)
        raise ValueError(
            f"{path} is not a plain tensor state_dict (torch weights_only load failed: "
            f"{e}) — if a whole nn.Module was pickled, save its .state_dict() instead "
            "and retry") from e
    out = {k: v.detach().cpu() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    skipped = sorted(set(sd) - set(out))
    if skipped:
        warnings.warn(f"{path}: skipped {len(skipped)} non-tensor entries "
                      f"({skipped[:5]}{'...' if len(skipped) > 5 else ''})", stacklevel=2)
    return out


def save_reference_checkpoint_safetensors(
    state_dict: Mapping[str, torch.Tensor], path: str, epoch: int = 0,
) -> str:
    """A port ``CXRClip`` state dict (``train.checkpoint.model_state``) →
    the flat mirror of the reference's checkpoint: keys
    ``"{module}.{param}"`` under the reference's module names, the epoch in
    the metadata. Counterpart of the JAX function of this name."""
    from ..train.checkpoint import reference_models

    flat = {f"{module}.{k}": v
            for module, sd in reference_models(state_dict).items() for k, v in sd.items()}
    return save_safetensors(flat, path,
                            metadata={_FORMAT_KEY: _FORMAT, _EPOCH_KEY: str(int(epoch))})


def load_reference_checkpoint_safetensors(
    path: str,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int]:
    """Flat reference-layout file → (``{module: state_dict}``, epoch).

    The format tag is required: a hub weight file (Bio_ClinicalBERT's
    ``model.safetensors``) passed as a checkpoint would otherwise split into
    unknown modules, import nothing, and score with fresh weights."""
    tensors, meta = read_safetensors(path)
    if meta.get(_FORMAT_KEY) != _FORMAT:
        raise ValueError(
            f"{path} is not a {_FORMAT} checkpoint (metadata {_FORMAT_KEY!r} missing) — "
            "hub tower weight files load via init_image_tower/init_text_tower, not as a "
            "checkpoint")
    models: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in tensors.items():
        module, _, param = key.partition(".")
        if not param:
            raise ValueError(f"{path}: key {key!r} has no module prefix — not a "
                             "reference-layout checkpoint (expected 'module.param.path')")
        models.setdefault(module, {})[param] = v
    return models, int(meta.get(_EPOCH_KEY, 0))
