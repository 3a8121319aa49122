"""The zero-shot inference engine (the serving slice's main path).

Counterpart of ``clip_for_dl_tpu.zeroshot.engine``:

- the prompt bank of every disease is tokenized into fixed-size batches,
  run through the text tower once, L2-normalized per prompt and averaged
  per disease into a cached [C, D] text-feature matrix;
- an image batch goes uint8 → fused resize + normalize (kernel B2) → image
  tower → projection → L2-normalize (with ``use_enhance``: the model's
  cross-modal attention against the bank, then L2-normalize again) →
  normalize + similarity (kernel B1), as work queued on the device; the
  host turns logits into probabilities and prediction sets (predict.py).

``_dispatch`` returns the device tensor without synchronising: the uint8
batch is staged in pinned memory, so its copy to the device is queued like
the kernels; a batch already on the device (``--device-cache``) is used
where it lies. ``stream_logits`` queues batch N+1, and the copy of its logits
to the host, before it waits for batch N's copy alone (:class:`HostCopy`),
so the host stages the next batch while the device computes.

With ``group`` (``zeroshot --num-devices``, the JAX engine's 1-D mesh),
every rank is handed the same batch: the rows are padded to a multiple of
the ranks, each rank scores its contiguous slice, and the logits of every
rank are gathered in rank order, so that each rank holds the batch's.
With ``mesh`` (``--tp``, the JAX engine's 2-D ``(data, model)`` mesh) the
towers are tensor-parallel over the model axis (``parallel/tp.py``; the
engine shards the model it is given) and the batch shards over the data
axis as above; the prompt bank is encoded on every rank, collectively.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import ZeroShotConfig
from ..core.device import to_device
from ..ops.image_prep import preprocess_images
from ..ops.similarity import l2_normalize, similarity
from .predict import sigmoid_predictions, softmax_topk_predictions

# prompts per text-tower call; the last chunk is padded with empty prompts
# so that every call has the same shape
_PROMPT_BATCH = 64


def encode_prompt_bank(
    prompts: Dict[str, List[str]],
    disease_list: Sequence[str],
    encode_fn,
    tokenizer,
    max_length: int = 512,
) -> torch.Tensor:
    """disease → prompt list ⇒ [C, D] fp32 text-feature matrix (on the CPU).

    Flattens every prompt into one tokenized batch, runs ``encode_fn(ids,
    mask)`` (numpy int32 in, [batch, D] tensor out) over chunks of 64,
    L2-normalizes per prompt, then
    means within each disease's segment (normalize-then-mean)."""
    flat: List[str] = []
    segments: List[int] = []
    for c, d in enumerate(disease_list):
        plist = prompts.get(d) or [f"This is a chest X-ray showing {d}."]
        flat.extend(plist)
        segments.extend([c] * len(plist))
    seg = np.asarray(segments)

    feats = []
    for start in range(0, len(flat), _PROMPT_BATCH):
        chunk = flat[start : start + _PROMPT_BATCH]
        if len(chunk) < _PROMPT_BATCH:
            chunk = chunk + [""] * (_PROMPT_BATCH - len(chunk))
        enc = tokenizer.encode(chunk, max_length=max_length)
        out = encode_fn(enc["input_ids"], enc["attention_mask"])
        feats.append(out.float().cpu().numpy())
    all_feats = np.concatenate(feats)[: len(flat)]
    all_feats = l2_normalize(torch.from_numpy(all_feats)).numpy()

    c = len(disease_list)
    sums = np.zeros((c, all_feats.shape[1]), np.float32)
    np.add.at(sums, seg, all_feats)
    counts = np.bincount(seg, minlength=c).astype(np.float32)[:, None]
    return torch.from_numpy(sums / np.maximum(counts, 1.0))


class HostCopy:
    """A device tensor's copy to pinned host memory, queued on the current
    stream behind the work that produces it. :meth:`numpy` waits for this
    copy alone, not for work queued after it (a plain ``.cpu()`` waits for
    the whole stream)."""

    @torch.inference_mode()
    def __init__(self, t: torch.Tensor):
        self._done = None
        if t.device.type == "cpu":
            self._host = t
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


class ZeroShotEngine:
    """Batched zero-shot prediction over a fixed text-feature bank.

    ``model`` is a port ``CXRClip`` on its device and in its compute dtype;
    the engine runs where the model's parameters are, puts it in eval mode
    and runs it under ``torch.inference_mode``."""

    def __init__(
        self,
        model,
        tokenizer,
        disease_list: Sequence[str],
        config: Optional[ZeroShotConfig] = None,
        mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
        std: Tuple[float, ...] = (1.0, 1.0, 1.0),
        image_size: int = 224,
        max_text_length: int = 512,
        compute_dtype: torch.dtype = torch.bfloat16,
        use_enhance: bool = False,
        group=None,
        mesh=None,
    ):
        if mesh is not None:
            if group is not None:
                raise ValueError("pass a group or a mesh, not both")
            if mesh.model_size > 1:
                from ..parallel.tp import tensor_parallel_

                tensor_parallel_(model, mesh)
            group = mesh.data_group
        self.model = model.eval()
        self.group = group
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.disease_list = list(disease_list)
        self.config = config or ZeroShotConfig()
        self.mean, self.std = tuple(mean), tuple(std)
        self.image_size = image_size
        self.max_text_length = max_text_length
        self.compute_dtype = compute_dtype
        self.use_enhance = use_enhance
        self.text_features: Optional[torch.Tensor] = None

    # -- text ---------------------------------------------------------------

    @torch.inference_mode()
    def _encode_text(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        return self.model.encode_text(ids_t, mask_t, normalize=True)

    def build_text_features(self, prompts: Dict[str, List[str]]) -> torch.Tensor:
        feats = encode_prompt_bank(
            prompts, self.disease_list, self._encode_text, self.tokenizer,
            self.max_text_length,
        )
        self.text_features = feats.to(self.device)
        return self.text_features

    # -- images -------------------------------------------------------------

    @torch.inference_mode()
    def _logits(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = preprocess_images(
            images_u8, self.image_size, self.image_size, self.mean, self.std,
            out_dtype=self.compute_dtype,
        )
        feats = self.model.encode_image(x, normalize=True)
        if self.use_enhance:
            feats = l2_normalize(self.model.enhance(feats, self.text_features)[0])
        return similarity(feats.float(), self.text_features, self.config.temperature)

    def _dispatch(self, images_u8) -> Tuple[torch.Tensor, int]:
        """Queue one batch; returns (device logits [B, C], rows) unsynchronised."""
        if self.text_features is None:
            raise RuntimeError("call build_text_features first")
        imgs = to_device(images_u8, self.device)
        if imgs.dim() == 5:
            imgs = imgs.reshape(-1, *imgs.shape[2:])
        n_real = imgs.shape[0]
        if self.group is None:
            return self._logits(imgs), n_real
        from ..parallel.dp import rows_over_group

        # the padding's rows are sliced off by the caller
        return rows_over_group(self._logits, imgs, self.group), n_real

    def logits(self, images_u8) -> np.ndarray:
        """[B, H, W, C] uint8 (or [B, V, H, W, C], flattened) → [B, C]."""
        out, n_real = self._dispatch(images_u8)
        return out.cpu().numpy()[:n_real]

    def probs(self, images_u8) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits(images_u8)))

    def stream_logits(self, batches):
        """Double-buffered evaluation: dispatch batch N+1 to the device
        before fetching batch N's logits. Yields (batch, logits) in order."""
        pending = None
        for batch in batches:
            handle, n_real = self._dispatch(batch["images"])
            copy = HostCopy(handle)
            if pending is not None:
                prev_batch, prev_copy, prev_n = pending
                yield prev_batch, prev_copy.numpy()[:prev_n]
            pending = (batch, copy, n_real)
        if pending is not None:
            prev_batch, prev_copy, prev_n = pending
            yield prev_batch, prev_copy.numpy()[:prev_n]

    def predict(
        self, images_u8, threshold=None, top_k: Optional[int] = None
    ) -> Tuple[List[List[str]], List[List[float]]]:
        """Reference-semantics prediction sets."""
        if self.config.predictor == "softmax_topk":
            return softmax_topk_predictions(
                self.logits(images_u8), self.disease_list,
                top_k or self.config.top_k,
            )
        return sigmoid_predictions(
            self.probs(images_u8),
            self.disease_list,
            self.config.threshold if threshold is None else threshold,
            top_k,
        )
