"""Deployment artifacts through ``torch.export`` (counterpart of
``clip_for_dl_tpu.export``).

Four programs, each with the weights (and, for the scorers, the prompt
bank) baked in and a symbolic batch ``b``:

- ``score_multiview.pt2``: ``[b, 2, H, W, 3]`` uint8 → probabilities
  (``inference.InferenceSession``'s forward);
- ``score_image.pt2``: ``[b, H, W, 3]`` uint8 → logits over the serve
  command's prompt bank at the preset's temperature
  (``zeroshot.engine.ZeroShotEngine._logits``);
- ``score_adapter.pt2``: ``[b, H, W, 3]`` uint8 → C-Adapter logits
  (``inference.AdapterEngine``);
- ``encode_text.pt2``: ``[b, L]`` token ids and mask → unit text features.

The JAX programs carry the plain XLA image prep and similarity so that one
artifact lowers for cpu and tpu. Here the forward kernels are PyTorch
operators (``ops/library.py``): a program traced on the CPU holds
``cxr::preprocess_images`` and ``cxr::similarity`` (and, where the model
runs them, ``cxr::flash_attention_packed``, ``cxr::dense_gelu_dense`` and
``cxr::fused_mlp_block``), which run their plain versions on the CPU and
launch the kernels once the loader moves the program to the card
(``torch.export.passes.move_to_device_pass``).

Each ``make_*`` function returns an ``nn.Module`` that holds copies of the
parts of the model it runs, in eval mode, its weights frozen (so that no
wrapper takes its autograd route) and the bank as a buffer; it runs the
same operations in the same order as the live engine it mirrors. Each
``export_*`` function traces one at a batch of 2 with ``Dim("b", min=1)``
and returns the bytes of ``torch.export.save``.

Loading (:class:`ExportedScorer`, :class:`ExportedEngine`,
:class:`ExportedTextEncoder`) needs ``torch`` and the operators, that is,
this module, which imports ``clip_for_dl_tpu_torch.ops`` and
``core``: not the model code, the tokenizer or the checkpoint format
(``models``, ``text``, ``train``, ``cli``). A ``.pt2`` is tied to the torch
version that wrote it, where a JAX artifact needs only a ``jax`` that reads
its serialization version. The loaders run on the card unless the caller
names another device.
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .core.config import DISEASE_LABELS
from .core.device import resolve_device, to_device
# every module that defines an operator, so that a program holding it loads
from .ops import flash_attention, mlp_block, mlp_train  # noqa: F401
from .ops.image_prep import preprocess_images
from .ops.similarity import l2_normalize, similarity

SCORER_FILE = "score_multiview.pt2"
SINGLEVIEW_FILE = "score_image.pt2"
ADAPTER_FILE = "score_adapter.pt2"
TEXT_ENCODER_FILE = "encode_text.pt2"
MANIFEST_FILE = "manifest.json"

# the batch a program is traced at: torch.export specialises sizes 0 and 1
EXAMPLE_BATCH = 2


class _Program(nn.Module):
    """Copies of the named parts of a ``CXRClip``, in eval mode, frozen."""

    def __init__(self, model: nn.Module, parts: Sequence[str]):
        super().__init__()
        for name in parts:
            self.add_module(name, copy.deepcopy(getattr(model, name)))
        self.eval().requires_grad_(False)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """``CXRClip.encode_image`` (not normalized)."""
        return self.image_projector(self.image_tower(x))


class _MultiviewScorer(_Program):
    def __init__(self, model, text_features, image_size, mean, std, logit_scale):
        super().__init__(model, ("image_tower", "image_projector", "view_fusion"))
        self.register_buffer("text_features", torch.as_tensor(text_features).float().clone())
        self.image_size, self.mean, self.std = image_size, tuple(mean), tuple(std)
        self.logit_scale = float(logit_scale)

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        b = images_u8.shape[0]
        x = preprocess_images(images_u8.reshape(b * 2, *images_u8.shape[2:]), self.image_size,
                              self.image_size, self.mean, self.std, torch.bfloat16)
        feats = self.encode_image(x).reshape(b, 2, -1)
        fused = self.view_fusion(feats[:, 0], feats[:, 1])
        return torch.sigmoid(similarity(fused.float(), self.text_features,
                                        1.0 / self.logit_scale))


class _SingleviewScorer(_Program):
    def __init__(self, model, text_features, image_size, mean, std, temperature,
                 compute_dtype, use_enhance):
        parts = ("image_tower", "image_projector")
        super().__init__(model, parts + ("multimodal_attention",) * bool(use_enhance))
        self.register_buffer("text_features", torch.as_tensor(text_features).float().clone())
        self.image_size, self.mean, self.std = image_size, tuple(mean), tuple(std)
        self.temperature, self.compute_dtype = float(temperature), compute_dtype
        self.use_enhance = bool(use_enhance)

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = preprocess_images(images_u8, self.image_size, self.image_size, self.mean,
                              self.std, self.compute_dtype)
        feats = l2_normalize(self.encode_image(x))
        if self.use_enhance:
            feats = l2_normalize(self.multimodal_attention(feats, self.text_features)[0])
        return similarity(feats.float(), self.text_features, self.temperature)


class _AdapterScorer(_Program):
    def __init__(self, model, image_size, mean, std, compute_dtype):
        super().__init__(model, ("image_tower", "image_projector", "adapter"))
        self.image_size, self.mean, self.std = image_size, tuple(mean), tuple(std)
        self.compute_dtype = compute_dtype

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = preprocess_images(images_u8, self.image_size, self.image_size, self.mean,
                              self.std, self.compute_dtype)
        return self.adapter(self.encode_image(x)).float()


class _TextEncoder(_Program):
    def __init__(self, model):
        super().__init__(model, ("text_tower", "text_projector"))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.text_tower(input_ids, attention_mask)
        return l2_normalize(self.text_projector(hidden[:, 0, :])).float()


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _serialize(program: nn.Module, example: Tuple[torch.Tensor, ...]) -> bytes:
    """``program`` traced at ``example`` (batch :data:`EXAMPLE_BATCH`) with
    a symbolic first dim on every input, as the bytes of ``torch.export.save``."""
    b = torch.export.Dim("b", min=1)
    exported = torch.export.export(program, example, strict=False,
                                   dynamic_shapes=tuple({0: b} for _ in example))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def _images(program: nn.Module, shape) -> torch.Tensor:
    return torch.zeros((EXAMPLE_BATCH, *shape), dtype=torch.uint8, device=_device_of(program))


def make_multiview_scorer(model, text_features, image_size: int, mean: Sequence[float],
                          std: Sequence[float], logit_scale: float = 4.0) -> nn.Module:
    """``InferenceSession``'s forward with the weights and the prompt
    features baked in: ``images_u8 [b, 2, H, W, 3] -> probs [b, C]`` (bf16
    image prep, as the session preps)."""
    return _MultiviewScorer(model, text_features, image_size, mean, std, logit_scale)


def export_multiview_scorer(model, text_features, image_size: int, mean: Sequence[float],
                            std: Sequence[float], logit_scale: float = 4.0,
                            source_hw: Optional[Tuple[int, int]] = None) -> bytes:
    """The multi-view scorer as ``.pt2`` bytes. ``source_hw``: the static
    height and width of the incoming uint8 views (default ``(image_size,
    image_size)``)."""
    h, w = source_hw or (image_size, image_size)
    program = make_multiview_scorer(model, text_features, image_size, mean, std, logit_scale)
    return _serialize(program, (_images(program, (2, h, w, 3)),))


def make_singleview_scorer(model, text_features, image_size: int, mean: Sequence[float],
                           std: Sequence[float], temperature: float = 0.5,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           use_enhance: bool = False) -> nn.Module:
    """The serving hot path (``ZeroShotEngine._logits``) with the weights,
    the bank and the temperature baked in: ``images_u8 [b, H, W, 3] ->
    logits [b, C]``."""
    return _SingleviewScorer(model, text_features, image_size, mean, std, temperature,
                             compute_dtype, use_enhance)


def export_singleview_scorer(model, text_features, image_size: int, mean: Sequence[float],
                             std: Sequence[float], temperature: float = 0.5,
                             source_hw: Optional[Tuple[int, int]] = None,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             use_enhance: bool = False) -> bytes:
    """The single-view serving scorer as ``.pt2`` bytes."""
    h, w = source_hw or (image_size, image_size)
    program = make_singleview_scorer(model, text_features, image_size, mean, std,
                                     temperature, compute_dtype, use_enhance)
    return _serialize(program, (_images(program, (h, w, 3)),))


def make_adapter_scorer(model, image_size: int, mean: Sequence[float], std: Sequence[float],
                        compute_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The C-Adapter serving path (``AdapterEngine``): ``images_u8 [b, H,
    W, 3] -> classifier logits [b, C]``."""
    return _AdapterScorer(model, image_size, mean, std, compute_dtype)


def export_adapter_scorer(model, image_size: int, mean: Sequence[float], std: Sequence[float],
                          source_hw: Optional[Tuple[int, int]] = None,
                          compute_dtype: torch.dtype = torch.bfloat16) -> bytes:
    """The C-Adapter scorer as ``.pt2`` bytes; it scores at chance unless the
    model's adapter head was trained (the ``adapter`` command's output)."""
    h, w = source_hw or (image_size, image_size)
    program = make_adapter_scorer(model, image_size, mean, std, compute_dtype)
    return _serialize(program, (_images(program, (h, w, 3)),))


def make_text_encoder(model) -> nn.Module:
    """``(input_ids, attention_mask) [b, L] int32 -> unit text features
    [b, D] fp32`` (``CXRClip.encode_text(normalize=True)``)."""
    return _TextEncoder(model)


def export_text_encoder(model, max_text_length: int) -> bytes:
    """The text encoder as ``.pt2`` bytes: the prompt-bank builder for new
    prompt families or disease sets without the model code."""
    program = make_text_encoder(model)
    ids = torch.zeros((EXAMPLE_BATCH, max_text_length), dtype=torch.int32,
                      device=_device_of(program))
    return _serialize(program, (ids, torch.ones_like(ids)))


def write_artifact(out_dir: str, scorer_bytes: bytes, text_encoder_bytes: Optional[bytes] = None,
                   manifest: Optional[dict] = None, singleview_bytes: Optional[bytes] = None,
                   adapter_bytes: Optional[bytes] = None) -> None:
    """Lay out the deployment directory: the programs and the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    for name, data in ((SCORER_FILE, scorer_bytes), (SINGLEVIEW_FILE, singleview_bytes),
                       (ADAPTER_FILE, adapter_bytes), (TEXT_ENCODER_FILE, text_encoder_bytes)):
        if data is not None:
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(data)
    if manifest is not None:
        with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
            json.dump(manifest, f, indent=2)


def _read_manifest(path: str) -> dict:
    manifest_path = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(manifest_path):
        return {}
    with open(manifest_path) as f:
        return json.load(f)


class _Loaded:
    """One program read from ``path`` (a ``.pt2`` file, or the file named
    ``module`` in an artifact directory, whose manifest is read too) and
    moved to ``device`` (the card when None)."""

    def __init__(self, path: str, module: str, device=None):
        self.manifest = _read_manifest(path) if os.path.isdir(path) else {}
        program_path = os.path.join(path, module) if os.path.isdir(path) else path
        if not os.path.exists(program_path):
            raise FileNotFoundError(
                f"{program_path} not found — produce it with "
                "python -m clip_for_dl_tpu_torch.tools.export_inference --stablehlo")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the index a tensor on "cuda" reports, so that a batch already
            # there is used where it lies
            self.device = torch.device("cuda", torch.cuda.current_device())
        exported = torch.export.load(program_path)
        if self.device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, self.device)
        inputs = set(exported.graph_signature.user_inputs)
        # the shapes the program was traced at: symbolic batch, static rest
        self.input_shapes = [n.meta["val"].shape for n in exported.graph.nodes
                             if n.op == "placeholder" and n.name in inputs]
        self.exported = exported
        self._module = exported.module()

    @torch.inference_mode()
    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        return self._module(*inputs)


class ExportedScorer:
    """Load and run a multi-view scorer, with ``InferenceSession``'s
    ``__call__`` contract and no model code. ``path``: the artifact
    directory (its ``score_multiview.pt2``; labels from ``manifest.json``)
    or the program file."""

    def __init__(self, path: str, threshold: float = 0.5,
                 disease_list: Optional[Sequence[str]] = None, device=None):
        self._program = _Loaded(path, SCORER_FILE, device)
        self.device = self._program.device
        self.threshold = float(threshold)
        self.disease_list = list(disease_list or self._program.manifest.get("disease_labels")
                                 or DISEASE_LABELS)
        shape = self._program.input_shapes[0]  # [b, 2, H, W, 3]
        self.input_hw = (int(shape[2]), int(shape[3]))

    def __call__(self, images_u8) -> Tuple[np.ndarray, np.ndarray]:
        """[B, 2, H, W, 3] uint8 → (binary predictions, probabilities)."""
        x = to_device(images_u8, self.device)
        if x.dim() != 5 or x.shape[1] != 2 or tuple(x.shape[2:4]) != self.input_hw:
            raise ValueError(
                f"expected [B, 2, {self.input_hw[0]}, {self.input_hw[1]}, 3] uint8 views "
                f"(the exported geometry), got {tuple(x.shape)}")
        probs = self._program(x.to(torch.uint8)).cpu().numpy()
        return (probs > self.threshold).astype(np.float32), probs


class ExportedEngine:
    """A ``ZeroShotEngine`` in place of the model, built from a single-view
    scorer (``serve --exported``): the surface ``serving.ZeroShotService``
    uses (``_dispatch``, ``logits``, ``probs``). ``module``:
    :data:`SINGLEVIEW_FILE` (zero-shot, the default) or
    :data:`ADAPTER_FILE` (the trained C-Adapter classifier). The bank and
    the temperature were baked in at export."""

    def __init__(self, path: str, disease_list: Optional[Sequence[str]] = None,
                 module: str = SINGLEVIEW_FILE, device=None):
        self._program = _Loaded(path, module, device)
        self.device = self._program.device
        self.manifest = self._program.manifest
        # the loaded torch.export.ExportedProgram: its state_dict holds the
        # weights and the baked bank ("text_features")
        self.exported = self._program.exported
        self.disease_list = list(disease_list or self.manifest.get("disease_labels")
                                 or DISEASE_LABELS)
        shape = self._program.input_shapes[0]  # [b, H, W, 3]
        self.input_hw = (int(shape[1]), int(shape[2]))
        self.image_size = self.input_hw[0]

    def _dispatch(self, images_u8) -> Tuple[torch.Tensor, int]:
        """Queue one batch; returns (device logits [B, C], rows). A
        [B, V, H, W, 3] batch is flattened to its views."""
        imgs = to_device(images_u8, self.device)
        if imgs.dim() == 5:
            imgs = imgs.reshape(-1, *imgs.shape[2:])
        if tuple(imgs.shape[1:3]) != self.input_hw:
            raise ValueError(
                f"expected [B, {self.input_hw[0]}, {self.input_hw[1]}, 3] uint8 (the exported "
                f"geometry), got {tuple(imgs.shape)}")
        return self._program(imgs.to(torch.uint8)), imgs.shape[0]

    def logits(self, images_u8) -> np.ndarray:
        out, n_real = self._dispatch(images_u8)
        return out.cpu().numpy()[:n_real]

    def probs(self, images_u8) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits(images_u8)))


class ExportedTextEncoder:
    """Load and run a text encoder (prompt-bank rebuilds)."""

    def __init__(self, path: str, device=None):
        self._program = _Loaded(path, TEXT_ENCODER_FILE, device)
        self.device = self._program.device
        self.max_text_length = int(self._program.input_shapes[0][1])

    def __call__(self, input_ids, attention_mask) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(input_ids, np.int32))
        mask = torch.as_tensor(np.asarray(attention_mask, np.int32))
        if ids.dim() != 2 or ids.shape[1] != self.max_text_length:
            raise ValueError(
                f"expected [B, {self.max_text_length}] token ids (the exported "
                f"max_text_length), got {tuple(ids.shape)}")
        return self._program(ids.to(self.device), mask.to(self.device)).cpu().numpy()
