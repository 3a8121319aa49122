"""A PNG writer on ``zlib``, ``struct`` and ``binascii.crc32``: 8- or 16-bit
grey, grey + alpha, RGB or RGBA, any row filters, optionally Adam7
interlaced. Test scaffolding for the decoder in ``native/bindings.py``."""

from __future__ import annotations

import binascii
import struct
import zlib
from typing import Optional, Union

import numpy as np

_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", binascii.crc32(kind + body) & 0xFFFFFFFF))


def _filtered(rows: np.ndarray, bpp: int, types: np.ndarray) -> bytes:
    """[h, stride] bytes → scanlines each led by its filter type, every
    filter computed from the unfiltered bytes."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    out = (x - pred[types, np.arange(len(x))]) & 255
    return np.concatenate([types[:, None].astype(np.uint8), out.astype(np.uint8)],
                          axis=1).tobytes()


def encode_png(img: np.ndarray, filters: Union[int, str] = 0, interlace: bool = False,
               rng: Optional[np.random.Generator] = None, level: int = 6) -> bytes:
    """[H, W] or [H, W, C] uint8/uint16 (C in 1-4) → PNG bytes. ``filters``
    is one filter type for every row, or "random" (a type drawn per row
    from ``rng``)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[img.dtype]
    data = img.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch) if depth == 16 else img
    bpp = ch * depth // 8
    rng = rng or np.random.default_rng(0)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = data[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.reshape(sub.shape[0], -1)
        types = (rng.integers(0, 5, len(rows)) if filters == "random"
                 else np.full(len(rows), int(filters)))
        raw += _filtered(rows, bpp, types)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR[ch], 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, **kw) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img, **kw))
    return path
