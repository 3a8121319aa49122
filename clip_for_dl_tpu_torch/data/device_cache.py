"""Device-resident image cache: the whole image set lives in device memory
(counterpart of ``clip_for_dl_tpu.data.device_cache``).

The disk ``ImageCache`` (data/cache.py) already saves the decode; this
module saves the per-batch host-to-device copy as well. The whole Indiana
set is ~225 MB as the grey-packed uint8 cache (4,497 × 224 × 224 × 1),
against 80 GB on an H100.

- At open, the cache's rows and one zero row go into one uint8 tensor on
  the device, in one bulk copy from pinned memory.
- Per batch, only the index vector crosses to the device: ``gather``
  selects the rows there, so a batch holds the cache's bytes exactly, as
  the streamed path does. Index −1 gives the zero row (a missing view, or a
  padded sample of the last batch).
- Indices are checked on the host: one below −1 or at or past the cache's
  length raises ``IndexError``. (The JAX gather clips them to the last row
  and scores a wrong image without a word.)
- A set larger than ``budget_frac`` of the device's memory raises
  ``DeviceCacheBudgetError``; the CLI then streams from the disk cache.

Datasets built with ``image_rows=True`` emit cache row indices in place of
pixels; ``device_image_feed`` swaps the collated indices for the gathered
batch just before the step (the CLI's ``--device-cache``).
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from .cache import DATA_NAME, ImageCache

logger = logging.getLogger("clip_for_dl_tpu_torch.data")

ENV_BUDGET = "CLIP_FOR_DL_TPU_HBM_BYTES"


class DeviceCacheBudgetError(RuntimeError):
    """The dataset does not fit the device-memory budget — stream instead."""


def device_memory_budget(device=None) -> int:
    """The memory, in bytes, of ``device`` (default: the card):
    ``CLIP_FOR_DL_TPU_HBM_BYTES`` when set, else the card's total memory
    (``torch.cuda.get_device_properties``), or the host's physical memory
    for the CPU."""
    env = os.environ.get(ENV_BUDGET)
    if env:
        return int(float(env))
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class DeviceImageCache:
    """A built ``ImageCache`` held in device memory. ``gather(rows)``
    returns the uint8 [*rows.shape, S, S, C] batch of those row indices, on
    the device; only the indices cross from the host."""

    def __init__(self, cache: ImageCache, *, budget_frac: float = 0.5, device=None):
        self.device = resolve_device(device)
        self.image_size = cache.image_size
        self.channels = cache.channels
        self._cache = cache  # row()/__contains__ delegate: one key scheme
        s, c = self.image_size, self.channels
        n = len(cache)
        nbytes = n * s * s * c
        budget = int(budget_frac * device_memory_budget(self.device))
        if nbytes > budget:
            raise DeviceCacheBudgetError(
                f"device cache needs {nbytes / 2**20:.0f} MB for {n} images "
                f"but the device budget is {budget / 2**20:.0f} MB "
                f"({budget_frac:.0%} of the device's memory) — use the "
                f"streaming ImageCache path"
            )
        rows = np.memmap(os.path.join(cache.directory, DATA_NAME), dtype=np.uint8,
                         mode="r", shape=(n, s, s, c))
        # row n is the zero image; the host copy is pinned so that the one
        # bulk copy streams at the link's rate
        host = torch.zeros((n + 1, s, s, c), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host.numpy()[:n] = rows
        self.array = host.to(self.device)
        del host
        self.nbytes = nbytes
        self._zero_row = n
        logger.info("device cache resident: %d images, %.0f MB on %s", n, nbytes / 2**20,
                    self.device)

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, path: str) -> bool:
        return path in self._cache

    def row(self, path: str):
        return self._cache.row(path)

    def gather(self, rows) -> torch.Tensor:
        """uint8 [*rows.shape, S, S, C] device batch for int row indices:
        multi-dimensional indices gather per element ([B, V] views →
        [B, V, ...]); index −1 gives the zero image. Raises IndexError for
        an index below −1 or at or past ``len(self)``."""
        rows = np.asarray(rows)
        if rows.size and (int(rows.min()) < -1 or int(rows.max()) >= self._zero_row):
            raise IndexError(
                f"device cache rows must lie in [-1, {self._zero_row}); got "
                f"[{int(rows.min())}, {int(rows.max())}]")
        idx = torch.from_numpy(np.where(rows < 0, self._zero_row, rows).astype(np.int64))
        if self.device.type == "cuda":  # from pageable memory the copy waits for the stream
            idx = idx.pin_memory()
        idx = idx.reshape(-1).to(self.device, non_blocking=True)
        return self.array.index_select(0, idx).reshape(*rows.shape, *self.array.shape[1:])


class DeviceFeedLoader:
    """Wraps a HostLoader built over ``image_rows=True`` datasets so that
    iteration swaps the collated row indices for batches gathered on the
    device — a drop-in for the streaming loader at every call site (len,
    state_dict and load_state_dict delegate, so a mid-epoch resume works
    unchanged)."""

    def __init__(self, loader, dcache: DeviceImageCache,
                 keys: Sequence[str] = ("image", "images")):
        self.loader = loader
        self.dcache = dcache
        self.keys = keys

    def __iter__(self) -> Iterator[dict]:
        return device_image_feed(iter(self.loader), self.dcache, self.keys)

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def state_dict(self):
        return self.loader.state_dict()

    def load_state_dict(self, state) -> None:
        self.loader.load_state_dict(state)

    def set_lengths(self, lengths) -> None:
        self.loader.set_lengths(lengths)


def device_image_feed(
    batches: Iterable[Mapping],
    dcache: DeviceImageCache,
    keys: Sequence[str] = ("image", "images"),
) -> Iterator[dict]:
    """Swap collated ``<key>_rows`` index vectors for batches gathered on
    the device: the step sees the ``image`` / ``images`` entry it always
    did, already on the device."""
    for batch in batches:
        out = dict(batch)
        for key in keys:
            rows = out.pop(key + "_rows", None)
            if rows is not None:
                out[key] = dcache.gather(rows)
        yield out
