"""Checkpointing (counterpart of ``clip_for_dl_tpu.train.checkpoint``):
epoch-keyed ``torch.save`` files with best-metric retention, a preemption
slot, and the reference ``.pth`` importer.

The JAX package keeps an orbax manager; this one keeps its rules on plain
files in ``directory``:

- ``{epoch}.pt`` holds ``{"model", "optimizer", "step"}`` of a
  ``TrainState``, and ``{epoch}.json`` its metrics. Each is written to a
  ``.tmp`` name and renamed, the metrics first, so a crash never leaves half
  a checkpoint under an epoch's name.
- Retention is orbax's ``BestN``: once more than ``max_to_keep`` epochs
  exist, only the ``max_to_keep`` best by ``metric_name`` (``best_mode``
  "min" or "max", ties to the newest) stay. A save at an epoch not after the
  latest kept one is skipped, as orbax skips it.
- ``extra_{epoch}.json`` is the resume payload of a mid-epoch save; a
  completed-epoch save of that epoch removes it.
- ``preempt/`` is a single-slot store for mid-epoch preemption saves, keyed
  ``epoch · 1e6 + step`` and outside best-k retention: a metric-less save
  among the ranked epochs would be dropped as the worst at the next save.

Saves are synchronous (the state is copied to the host by ``torch.save``),
so ``wait`` only prunes preemption saves that a completed epoch superseded.
Restores load into the template state's model and optimizer, whose
``load_state_dict`` puts every tensor on the template's device.

Model tensors are stored under the model's state-dict names with
``core.device.cast_in_forward``'s parametrization taken out
(``conv1.parametrizations.weight.original`` → ``conv1.weight``): the
reference's names, so a checkpoint loads into a model with or without that
parametrization.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

logger = logging.getLogger("clip_for_dl_tpu_torch.checkpoint")

# Preemption-slot keys are epoch * base + batch_step: monotone across
# repeated preemptions, so a new save never reuses (= never deletes) the key
# of the copy it replaces.
_PREEMPT_BASE = 1_000_000

_PARAMETRIZED = re.compile(r"\.parametrizations\.([^.]+)\.original$")


def model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` under the reference's names (see above)."""
    return {_PARAMETRIZED.sub(r".\1", k): v for k, v in model.state_dict().items()}


def _load_model(model: nn.Module, saved: Mapping[str, torch.Tensor], *,
                allow_missing: bool, what: str) -> None:
    own = {_PARAMETRIZED.sub(r".\1", k): k for k in model.state_dict()}
    missing = [k for k in own if k not in saved]
    if missing:
        msg = (f"{what} lacks {len(missing)} of the model's tensors (e.g. {missing[:4]}): "
               "those would keep their initial values. Build the model the checkpoint "
               "was trained with, or pass allow_partial=True to accept partial weights.")
        if not allow_missing:
            raise ValueError(msg)
        logger.warning(msg)
    model.load_state_dict({own[k]: saved[k] for k in own if k in saved}, strict=False)


def _replace_write(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_json(path: str, obj) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)

    _replace_write(path, write)


def _read_json(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class _Store:
    """Checkpoint files ``{key}.pt`` (+ ``{key}.json`` metrics) in one
    directory; ``extra_{key}.json`` sidecars are the caller's."""

    def __init__(self, directory: str):
        self.directory = directory

    def keys(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n[:-3]) for n in os.listdir(self.directory)
                      if n.endswith(".pt") and n[:-3].isdigit())

    def path(self, key: int, suffix: str = ".pt") -> str:
        return os.path.join(self.directory, f"{key}{suffix}")

    def metrics(self, key: int) -> Optional[Dict[str, float]]:
        return _read_json(self.path(key, ".json"))

    def latest(self) -> Optional[int]:
        keys = self.keys()
        return keys[-1] if keys else None

    def write(self, key: int, state, metrics: Optional[Dict[str, float]]) -> bool:
        """Save ``state`` under ``key`` unless a key at or after it exists
        (orbax's rule); returns whether it saved."""
        latest = self.latest()
        if latest is not None and key <= latest:
            logger.warning("not saving %s/%d: %d is saved already", self.directory, key, latest)
            return False
        os.makedirs(self.directory, exist_ok=True)
        if metrics is not None:
            _write_json(self.path(key, ".json"), metrics)
        payload = {"model": model_state(state.model),
                   "optimizer": state.optimizer.state_dict(), "step": int(state.step)}
        _replace_write(self.path(key), lambda tmp: torch.save(payload, tmp))
        return True

    def read(self, key: int) -> Dict[str, Any]:
        # to the host: load_state_dict then copies each tensor onto its
        # parameter's device, and AdamW's step counters stay on the host,
        # where they were saved from
        return torch.load(self.path(key), map_location="cpu", weights_only=True)

    def delete(self, key: int) -> None:
        for suffix in (".pt", ".json"):
            if os.path.exists(self.path(key, suffix)):
                os.remove(self.path(key, suffix))

    def extra_path(self, key: int) -> str:
        return os.path.join(self.directory, f"extra_{key}.json")


def _restore_into(store: _Store, key: int, template):
    saved = store.read(key)
    _load_model(template.model, saved["model"], allow_missing=False,
                what=store.path(key))
    template.optimizer.load_state_dict(saved["optimizer"])
    template.step = int(saved["step"])
    return template, _read_json(store.extra_path(key))


class CheckpointManager:
    """Train-state checkpoints keyed by epoch, best tracked by metric, and a
    separate single-slot store for mid-epoch preemption saves (see the
    module docstring)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: Optional[int] = 3,
        best_mode: str = "min",
        metric_name: str = "val_loss",
    ):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode
        self.metric_name = metric_name
        self._store = _Store(self.directory)
        self._preempt = _Store(os.path.join(self.directory, "preempt"))

    # -- ranking -------------------------------------------------------------

    def _ranked(self, epochs: List[int]) -> List[int]:
        """The epochs that have metrics, worst first (orbax's sort: stable,
        so among equal metrics the newest ranks best)."""
        scored = [(e, m) for e in epochs if (m := self._store.metrics(e)) is not None]
        scored = sorted(scored, key=lambda em: em[1][self.metric_name],
                        reverse=self.best_mode == "min")
        return [e for e, _ in scored]

    def _retain(self) -> None:
        epochs = self._store.keys()
        if self.max_to_keep is None or len(epochs) <= self.max_to_keep:
            return
        ranked = self._ranked(epochs)
        keep = set(ranked[len(ranked) - self.max_to_keep:] if self.max_to_keep else [])
        keep |= set(epochs) - set(ranked)  # epochs without metrics stay
        for e in epochs:
            if e not in keep:
                self._store.delete(e)

    def all_epochs(self) -> List[int]:
        return self._store.keys()

    def latest_epoch(self) -> Optional[int]:
        return self._store.latest()

    def best_epoch(self) -> Optional[int]:
        ranked = self._ranked(self._store.keys())
        return ranked[-1] if ranked else None

    # -- epoch checkpoints ---------------------------------------------------

    def save(self, epoch: int, state, extra: Optional[Dict[str, Any]] = None,
             metrics: Optional[Dict[str, float]] = None) -> None:
        if epoch in self._store.keys():
            # replace, don't collide (mid-epoch saves go through save_preempt
            # and never reuse an epoch key)
            self._store.delete(epoch)
        if self._store.write(epoch, state, metrics or {self.metric_name: float("inf")}):
            self._retain()
        extra_path = self._store.extra_path(epoch)
        if extra:
            _write_json(extra_path, extra)
        elif os.path.exists(extra_path):
            # completed-epoch save supersedes a stale mid-epoch marker
            os.remove(extra_path)

    def restore(self, state_template, epoch: Optional[int] = None):
        """Restore (state, extra) at `epoch` (default: latest) into the
        template's model and optimizer."""
        key = epoch if epoch is not None else self._store.latest()
        if key is None:
            return None, None
        return _restore_into(self._store, key, state_template)

    def restore_variables(
        self,
        model: nn.Module,
        epoch: Optional[int] = None,
        allow_partial: bool = False,
        use_ema: bool = False,
    ) -> Optional[nn.Module]:
        """Load only the model's weights and BatchNorm statistics, into
        ``model``, independent of the optimizer the checkpoint was trained
        with: the start of phase B from phase A. Returns ``model``, or None
        when there is no checkpoint.

        A tensor of ``model`` that the checkpoint lacks is an error: it would
        keep its initial value and score as an untrained weight. Pass
        ``allow_partial=True`` for the reference's tolerant load
        (0425/train.py:523-541). Tensors of the checkpoint that ``model``
        lacks are ignored."""
        if use_ema:
            raise NotImplementedError("EMA of the parameters is not ported yet (ROADMAP A3)")
        key = epoch if epoch is not None else self._store.latest()
        if key is None:
            return None
        saved = self._store.read(key)
        _load_model(model, saved["model"], allow_missing=allow_partial,
                    what=f"checkpoint {self._store.path(key)}")
        return model

    # -- mid-epoch preemption slot -------------------------------------------

    def save_preempt(self, epoch: int, state,
                     extra: Optional[Dict[str, Any]] = None) -> None:
        """Durable mid-epoch save, outside best-k retention. `extra` is the
        resume payload ({mid_epoch, loader, num_batches})."""
        step = 0
        if extra and isinstance(extra.get("loader"), dict):
            step = int(extra["loader"].get("step", 0))
        key = epoch * _PREEMPT_BASE + min(max(step, 0), _PREEMPT_BASE - 1)
        if self._preempt.write(key, state, None):
            for old in self._preempt.keys()[:-1]:  # a single slot
                self._drop_preempt(old)
        if extra:
            _write_json(self._preempt.extra_path(key), extra)

    def _drop_preempt(self, key: int) -> None:
        self._preempt.delete(key)
        if os.path.exists(self._preempt.extra_path(key)):
            os.remove(self._preempt.extra_path(key))

    def preempt_latest(self) -> Optional[int]:
        """Epoch of the newest preemption save, or None."""
        key = self._preempt.latest()
        return None if key is None else key // _PREEMPT_BASE

    def restore_preempt(self, state_template):
        """Restore (state, extra) from the newest preemption save."""
        key = self._preempt.latest()
        if key is None:
            return None, None
        return _restore_into(self._preempt, key, state_template)

    def prune_preempt(self) -> None:
        """Drop preemption saves superseded by a completed-epoch checkpoint
        (run after that checkpoint is on disk, never inside save)."""
        latest = self._store.latest()
        if latest is None:
            return
        for key in self._preempt.keys():
            if key // _PREEMPT_BASE <= latest:
                self._drop_preempt(key)

    def wait(self) -> None:
        self.prune_preempt()

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""


# ---------------------------------------------------------------------------
# reference .pth import
# ---------------------------------------------------------------------------

# reference module name → the port's submodule (the state-dict names below
# it are the reference's own)
_MODULES = {
    "resnet": "image_tower",
    "image_projector": "image_projector",
    "text_projector": "text_projector",
    "text_model": "text_tower",
    "view_fusion": "view_fusion",
    "multimodal_attention": "multimodal_attention",
    "classifier": "adapter.classifier",
}


def convert_reference_models(models: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{reference module name: state_dict} → one state dict under the port's
    ``CXRClip`` names. Modules the mapping does not know are skipped."""
    sd: Dict[str, torch.Tensor] = {}
    for name, module_sd in models.items():
        if not isinstance(module_sd, dict) or name not in _MODULES:
            continue
        for k, v in module_sd.items():
            sd[f"{_MODULES[name]}.{k}"] = torch.as_tensor(v)
    return sd


def import_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference checkpoint ``{epoch, models: {name: state_dict},
    ...}`` (a torch ``.pth`` pickle: load only files you trust) and map each
    module onto the port's submodules. Returns ``{"state_dict", "epoch"}``;
    the state dict goes to ``CXRClip.load_state_dict``. Modules absent from
    the file are absent from it (the reference's tolerant load,
    0425/train.py:523-541)."""
    if path.endswith(".safetensors"):
        raise NotImplementedError("the .safetensors mirror needs models/safetensors_io.py, "
                                  "which is not ported yet (ROADMAP A4b)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    models = ckpt.get("models", ckpt)
    return {
        "state_dict": convert_reference_models(models),
        "epoch": int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0,
    }
