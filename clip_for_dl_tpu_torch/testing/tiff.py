"""A TIFF writer on ``zlib``, ``struct`` and numpy: strips or tiles,
PlanarConfiguration 1 or 2, 1- to 16-bit samples in either byte order,
classic TIFF or BigTIFF, no compression, PackBits, LZW (the usual bit order
or the old LSB-first one), Deflate, Predictor 2, any extra tags, several
pages. Test scaffolding for the decoder in ``native/src/tiff.cpp``: it
writes what neither cv2 nor PIL writes (tiles, planar 2, BigTIFF,
big-endian, the old LZW, an Orientation tag, ...)."""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# TIFF field types: struct format and size
_TYPES = {1: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
Tags = Dict[int, Tuple[int, Sequence[int]]]


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


class _Codes:
    """LZW codes packed MSB first, or LSB first for the old bit order."""

    def __init__(self, old: bool):
        self.old, self.acc, self.bits, self.out = old, 0, 0, bytearray()

    def put(self, code: int, width: int) -> None:
        if self.old:
            self.acc |= code << self.bits
            self.bits += width
            while self.bits >= 8:
                self.out.append(self.acc & 255)
                self.acc >>= 8
                self.bits -= 8
        else:
            self.acc = (self.acc << width) | code
            self.bits += width
            while self.bits >= 8:
                self.bits -= 8
                self.out.append((self.acc >> self.bits) & 255)
                self.acc &= (1 << self.bits) - 1

    def end(self) -> bytes:
        if self.bits:
            self.put(0, 8 - self.bits)
        return bytes(self.out)


def lzw_codes(codes: Iterable[int], old: bool = False) -> bytes:
    """A stream of LZW data codes (each adding one table entry, as an
    encoder's do), led by a clear code and ended by EOI, the width growing as
    libtiff's encoder grows it (one code later in the old bit order); a
    clear code is put where the table fills."""
    out = _Codes(old)
    width, nxt = 9, 258
    out.put(256, width)
    for code in codes:
        out.put(code, width)
        nxt += 1
        if nxt == 4094:
            out.put(256, width)
            width, nxt = 9, 258
        elif nxt > (1 << width) - (0 if old else 1) and width < 12:
            width += 1
    out.put(257, width)  # at the width the decoder has grown to by then
    return out.end()


def lzw(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW of ``data``."""
    def codes():
        table = {bytes([i]): i for i in range(256)}
        nxt, w = 258, b""
        for c in data:
            wc = w + bytes([c])
            if wc in table:
                w = wc
                continue
            yield table[w]
            table[wc] = nxt
            nxt += 1
            if nxt == 4094:
                table, nxt = {bytes([i]): i for i in range(256)}, 258
            w = bytes([c])
        if w:
            yield table[w]

    return lzw_codes(codes(), old)


def _pack(px: np.ndarray, bps: int, order: str) -> bytes:
    """[h, w, s] sample values → rows of bytes, each row padded to a byte."""
    h, w, s = px.shape
    if bps == 8:
        return px.astype(np.uint8).tobytes()
    if bps in (16, 32):
        return px.astype(f"{order}u{bps // 8}").tobytes()
    bits = ((px.reshape(h, w * s)[..., None] >> np.arange(bps - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, w * s * bps), axis=1).tobytes()


def _difference(raw: bytes, bps: int, samples: int, width: int, order: str) -> bytes:
    """Predictor 2 over the rows of a block of 8- or 16-bit samples."""
    dtype = np.uint8 if bps == 8 else np.dtype(f"{order}u2")
    a = np.frombuffer(raw, dtype).reshape(-1, width, samples).astype(np.int64)
    a[:, 1:] -= np.frombuffer(raw, dtype).reshape(-1, width, samples)[:, :-1]
    return (a & ((1 << bps) - 1)).astype(dtype).tobytes()


def _encode(raw: bytes, compression: int, old_lzw: bool) -> bytes:
    if compression == 1:
        return raw
    if compression == 32773:
        return packbits(raw)
    if compression == 5:
        return lzw(raw, old_lzw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    raise ValueError(f"no encoder for compression {compression}")


def encode_tiff(px, bps: int = 8, photometric: Optional[int] = None, compression: int = 1,
                predictor: int = 1, planar: int = 1, rows_per_strip: Optional[int] = None,
                tile: Optional[Tuple[int, int]] = None, order: str = "<", big: bool = False,
                orientation: Optional[int] = None, extra: Optional[Sequence[int]] = None,
                colormap=None, sample_format: Optional[int] = None, pages: int = 1,
                old_lzw: bool = False, fill_order: Optional[int] = None,
                tags: Optional[Tags] = None) -> bytes:
    """``px`` ([h, w] or [h, w, samples] values) as a TIFF: strips of
    ``rows_per_strip`` rows (all by default) or tiles of ``tile`` (rows,
    columns), zero past the image; ``order`` "<" little-endian, ">" big;
    ``colormap`` [2^bps, 3]; ``tags`` added last ({tag: (type, values)})."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, spp = px.shape
    blocks: List[bytes] = []
    for plane in ([px] if planar == 1 else [px[..., i:i + 1] for i in range(spp)]):
        samples = plane.shape[2]
        if tile:
            th, tw = tile
            parts = []
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, samples), px.dtype)
                    part = plane[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    parts.append((t, tw))
        else:
            rps = rows_per_strip or h
            parts = [(plane[y:y + rps], w) for y in range(0, h, rps)]
        for part, width in parts:
            raw = _pack(part, bps, order)
            if predictor == 2 and bps in (8, 16):
                raw = _difference(raw, bps, samples, width, order)
            blocks.append(_encode(raw, compression, old_lzw))
    fields: Tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
                    262: (3, [(1 if spp < 3 else 2) if photometric is None else photometric]),
                    277: (3, [spp]), 284: (3, [planar])}
    if tile:
        fields[322], fields[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        fields[278] = (4, [rows_per_strip or h])
    for tag, value in ((317, predictor if predictor != 1 else None), (274, orientation),
                       (266, fill_order)):
        if value is not None:
            fields[tag] = (3, [value])
    if extra is not None:
        fields[338] = (3, list(extra))
    if colormap is not None:
        fields[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if sample_format is not None:
        fields[339] = (3, [sample_format] * spp)
    fields.update(tags or {})
    return build_tiff(fields, blocks, tile is not None, order, big, pages)


def build_tiff(fields: Tags, blocks: Sequence[bytes], tiled: bool = False, order: str = "<",
               big: bool = False, pages: int = 1) -> bytes:
    """A TIFF of the given directory ``fields`` and data ``blocks`` (strips,
    or tiles with ``tiled``), whose offsets and byte counts are filled in:
    each page the blocks, then its directory, then the directory's values."""
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHHQ", 43, 8, 0, 0) if big else struct.pack(order + "HI", 42, 0))
    out = bytearray(head)
    dirs = []  # (where a directory starts, where its next-directory pointer lies)
    ref = "Q" if big else "I"
    for _ in range(pages):
        at = []
        for b in blocks:
            at.append(len(out))
            out += b + b"\0" * (len(b) % 2)
        page = dict(fields)
        page[325 if tiled else 279] = (16 if big else 4, [len(b) for b in blocks])
        page[324 if tiled else 273] = (16 if big else 4, at)
        start = len(out)
        size = (8 + 20 * len(page) + 8) if big else (2 + 12 * len(page) + 4)
        values, entries = bytearray(), bytearray(struct.pack(order + ("Q" if big else "H"),
                                                             len(page)))
        for tag in sorted(page):
            kind, vals = page[tag]
            raw = struct.pack(order + _TYPES[kind] * len(vals), *vals)
            entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, kind, len(vals))
            if len(raw) <= (8 if big else 4):
                entries += raw.ljust(8 if big else 4, b"\0")
            else:
                entries += struct.pack(order + ref, start + size + len(values))
                values += raw + b"\0" * (len(raw) % 2)
        dirs.append((start, start + len(entries)))
        out += entries + b"\0" * (8 if big else 4) + values
    pointers = [8 if big else 4] + [p for _, p in dirs]
    for pointer, (start, _) in zip(pointers, dirs):
        out[pointer:pointer + (8 if big else 4)] = struct.pack(order + ref, start)
    return bytes(out)


__all__ = ["build_tiff", "encode_tiff", "lzw", "lzw_codes", "packbits"]
