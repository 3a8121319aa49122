"""Preprocessed image cache: decode once, read at disk bandwidth after
(counterpart of ``clip_for_dl_tpu.data.cache``, in the same on-disk format,
so a cache built by either package is read by the other).

The reference decodes and resizes every image on every epoch
(0425/prepare_data.py:65-90 runs inside Dataset.__getitem__). The cache
amortizes the decode to a one-time pass: a flat uint8 memmap of
preprocessed images plus a JSON index keyed by filename. Rows carry the
exact ``datasets.load_image`` bytes (``native/bindings.py`` decode and
resize, the zero image on a decode failure), so a cached run and an
uncached run feed the model the same bytes.

Grayscale packing (channels=1): chest X-ray sources are grayscale PNGs that
the reference triplicates to RGB at decode. build_image_cache checks every image;
when all three channels are identical for every row, the cache stores one
uint8 channel per pixel ([N, S, S, 1], 3x smaller on disk and over the
host-to-device copy) and the prep on the card (kernel B2) broadcasts back
to 3 channels after the resize, bit-identically. One colour image keeps the
RGB layout for the whole cache (a memmap needs one row stride).

Layout (directory):
  cache_meta.json  — {"version", "image_size", "channels", "keys": [...]}
  images.u8        — C-order uint8 [len(keys), S, S, channels] raw memmap
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

META_NAME = "cache_meta.json"
DATA_NAME = "images.u8"
# v1: [N,S,S,3] RGB rows. v2: adds "channels" (1 for grayscale-packed
# caches, 3 for RGB). v1 caches still open (channels defaults to 3).
_VERSION = 2
_READABLE_VERSIONS = (1, 2)


def _key(path: str) -> str:
    """Rows are keyed by filename: datasets join image_dir at load time, so
    the same cache serves any --image-dir mount point. Collisions are
    rejected at build time (Indiana filenames are globally unique)."""
    return os.path.basename(path)


class ImageCache:
    """Read-only view of a built cache; get() returns the preprocessed
    uint8 [S, S, channels] row (channels is 1 for grayscale-packed caches,
    3 for RGB) or None for an unknown filename (callers fall back to the
    live decode path, so a partial cache degrades gracefully)."""

    def __init__(self, directory: str):
        meta_path = os.path.join(directory, META_NAME)
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("version") not in _READABLE_VERSIONS:
            raise ValueError(
                f"image cache {directory} has version {meta.get('version')}, "
                f"expected one of {_READABLE_VERSIONS} — rebuild it"
            )
        self.directory = directory
        self.image_size = int(meta["image_size"])
        self.channels = int(meta.get("channels", 3))
        if self.channels not in (1, 3):
            raise ValueError(
                f"image cache {directory} has channels={self.channels}, "
                f"expected 1 or 3"
            )
        keys = meta["keys"]
        self._rows: Dict[str, int] = {k: i for i, k in enumerate(keys)}
        s, c = self.image_size, self.channels
        expected = len(keys) * s * s * c
        data_path = os.path.join(directory, DATA_NAME)
        actual = os.path.getsize(data_path)
        if actual != expected:
            raise ValueError(
                f"image cache {directory} is truncated or stale: "
                f"{DATA_NAME} is {actual} bytes, metadata implies {expected} "
                f"— rebuild it"
            )
        self._arr = np.memmap(
            data_path, dtype=np.uint8, mode="r", shape=(len(keys), s, s, c)
        )

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, path: str) -> bool:
        return _key(path) in self._rows

    def row(self, path: str) -> Optional[int]:
        """Row index of `path` in the memmap (the device-resident cache
        gathers by these indices — data/device_cache.py), or None."""
        return self._rows.get(_key(path))

    def get(self, path: str) -> Optional[np.ndarray]:
        row = self._rows.get(_key(path))
        if row is None:
            return None
        # copy out of the memmap: downstream code mutates/stacks batches and
        # must not pin the file mapping
        return np.array(self._arr[row])


def build_image_cache(
    paths: Sequence[str],
    image_size: int,
    directory: str,
    workers: int = 8,
    channels: str = "auto",
) -> "ImageCache":
    """One-time pass: decode + host-resize every path into the memmap,
    through ``native.batch_load_resize_u8`` (threaded, byte-identical to
    ``datasets.load_image``: PNG, JPEG, BMP, TIFF and Netpbm decode; a
    file that cannot be read or decoded leaves its row zero, the zero
    image; a format the port does not decode raises
    ``native.UnportedFormat``).

    channels="auto" (default): after the decode pass, every row is checked
    for grayscale (three identical channels); if ALL rows are gray the cache
    is compacted to one channel per pixel. channels="rgb" forces the full
    RGB layout."""
    if channels not in ("auto", "rgb"):
        raise ValueError(f"channels must be 'auto' or 'rgb', got {channels!r}")
    from ..native import bindings as native

    keys, first_path, unique_paths = [], {}, []
    for p in paths:
        k = _key(p)
        prev = first_path.get(k)
        if prev is not None:
            # duplicate filename: fine when it is the same file repeated in
            # the frame (multi-label rows share images); a different path
            # with the same basename would silently alias — reject it.
            if os.path.abspath(prev) != os.path.abspath(p):
                raise ValueError(
                    f"filename collision in image cache: {prev!r} and "
                    f"{p!r} share basename {k!r}"
                )
            continue
        first_path[k] = p
        keys.append(k)
        unique_paths.append(p)

    os.makedirs(directory, exist_ok=True)
    s = image_size
    arr = np.memmap(
        os.path.join(directory, DATA_NAME),
        dtype=np.uint8,
        mode="w+",
        shape=(len(keys), s, s, 3),
    )

    chunk = 256  # bounds the decoded batch in memory at ~chunk·S²·3 bytes
    for start in range(0, len(keys), chunk):
        chunk_paths = unique_paths[start : start + chunk]
        batch, _ = native.batch_load_resize_u8(chunk_paths, s, s, threads=max(1, workers))
        arr[start : start + len(chunk_paths)] = batch
    arr.flush()

    # Grayscale gate: one streaming pass over the just-written rows (page
    # cache still warm — memory bandwidth, not re-decode). Per-file check;
    # one color file keeps the whole cache RGB.
    n_channels = 3
    if channels == "auto" and len(keys):
        all_gray = True
        scan = 512
        for start in range(0, len(keys), scan):
            block = arr[start : start + scan]
            if not (block[..., :1] == block[..., 1:]).all():
                all_gray = False
                break
        if all_gray:
            n_channels = 1
    del arr

    if n_channels == 1:
        # Compact in place: channel 0 IS the gray value for every row.
        src = np.memmap(
            os.path.join(directory, DATA_NAME), dtype=np.uint8, mode="r",
            shape=(len(keys), s, s, 3),
        )
        packed_path = os.path.join(directory, DATA_NAME + ".tmp1")
        dst = np.memmap(
            packed_path, dtype=np.uint8, mode="w+", shape=(len(keys), s, s, 1)
        )
        chunk_rows = 512
        for start in range(0, len(keys), chunk_rows):
            dst[start : start + chunk_rows] = (
                src[start : start + chunk_rows, :, :, :1]
            )
        dst.flush()
        del src, dst
        os.replace(packed_path, os.path.join(directory, DATA_NAME))

    meta = {
        "version": _VERSION,
        "image_size": s,
        "channels": n_channels,
        "keys": keys,
    }
    tmp = os.path.join(directory, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(directory, META_NAME))
    return ImageCache(directory)
