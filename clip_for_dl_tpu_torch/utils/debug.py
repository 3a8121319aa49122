"""Debug and fault-injection tools (counterpart of
``clip_for_dl_tpu.utils.debug``):

- ``debug_mode()``: autograd's anomaly detection, which names the forward
  operation whose backward made a NaN, for a scope;
- ``assert_finite``: fail fast with the path of the offending leaf;
- ``validate_batch``: input-pipeline contract checks (shapes, label range,
  mask consistency);
- ``deterministic_run``: one switch that pins numpy's and torch's global
  generators for a scope and hands out a seeded generator;
- ``FaultInjector``: wraps a loader and drops or corrupts chosen batches;
- ``count_params``: the elements of a module's parameters or of a tree of
  arrays.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Scope with anomaly detection (a NaN made by a backward raises, naming
    the forward operation) when ``nans``."""
    with torch.autograd.detect_anomaly(check_nan=True) if nans else contextlib.nullcontext():
        yield


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def _with_paths(tree: Any, path: tuple = ()) -> Iterator[tuple]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_paths(v, path + (f"[{i}]",))
    else:
        yield path, tree


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Host-side finite check naming the bad leaf (debug cadence only: it
    copies every leaf to the host)."""
    for path, leaf in _with_paths(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}:{'/'.join(path)} "
                f"(nan={np.isnan(arr).sum()}, inf={np.isinf(arr).sum()})"
            )


def validate_batch(
    batch: Dict[str, Any],
    batch_size: Optional[int] = None,
    num_classes: int = 16,
) -> None:
    """Input-pipeline contract checks for host (or device) batches."""
    if "images" in batch:
        imgs = _host(batch["images"])
        if batch_size is not None and imgs.shape[0] != batch_size:
            raise ValueError(f"batch size {imgs.shape[0]} != expected {batch_size}")
        if imgs.dtype != np.uint8 and not np.isfinite(imgs).all():
            raise ValueError("non-finite image values")
    if "labels" in batch:
        lbl = _host(batch["labels"])
        if lbl.shape[-1] != num_classes:
            raise ValueError(f"label dim {lbl.shape[-1]} != {num_classes}")
        if ((lbl != 0) & (lbl != 1)).any():
            raise ValueError("labels must be binary")
    if "mask" in batch and "images" in batch:
        if len(batch["mask"]) != len(batch["images"]):
            raise ValueError("mask/images length mismatch")


@contextlib.contextmanager
def deterministic_run(seed: int = 0):
    """Seed numpy's and torch's global generators (every card's too) for the
    scope, restoring their states after; yields a CPU ``torch.Generator``
    seeded with ``seed``."""
    np_state = np.random.get_state()
    np.random.seed(seed)
    try:
        with torch.random.fork_rng(devices=range(torch.cuda.device_count())):
            torch.manual_seed(seed)
            yield torch.Generator().manual_seed(seed)
    finally:
        np.random.set_state(np_state)


class FaultInjector:
    """Wrap a batch iterator; drop or corrupt selected batches.

    modes: "drop" (skip the batch, the reference's try/except-continue),
    "nan" (poison image floats), "zero" (the zero-image decode fallback).
    """

    def __init__(
        self,
        loader: Iterable[Dict[str, Any]],
        fault_batches: Sequence[int] = (),
        mode: str = "drop",
        on_fault: Optional[Callable[[int, str], None]] = None,
    ):
        self.loader = loader
        self.fault_batches = set(fault_batches)
        self.mode = mode
        self.on_fault = on_fault
        self.faults_injected = 0

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i, batch in enumerate(self.loader):
            if i in self.fault_batches:
                self.faults_injected += 1
                if self.on_fault:
                    self.on_fault(i, self.mode)
                if self.mode == "drop":
                    continue
                batch = dict(batch)
                imgs = np.array(batch["images"], copy=True)
                if self.mode == "nan":
                    imgs = imgs.astype(np.float32)
                    imgs[0] = np.nan
                elif self.mode == "zero":
                    imgs[0] = 0
                batch["images"] = imgs
            yield batch


def count_params(tree: Any) -> int:
    """Elements of a module's parameters, or of every leaf with a shape in a
    tree (a state dict, the JAX variables' layout)."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    return sum(int(np.prod(x.shape)) for _, x in _with_paths(tree) if hasattr(x, "shape"))
