"""Host-side image decoding and resizing (counterpart of
``clip_for_dl_tpu.native.bindings``, and of the cv2 calls the JAX package
makes for every format but PNG).

The JAX package builds ``native/src/cxr_native.cpp`` against libpng. The
GPU machine has zlib but neither libpng's headers nor its library (the
probe printed by ``chip_smoke.py``), so PNG is decoded here, on the
standard library's ``zlib`` and numpy, with the same results byte for byte.
JPEG, BMP, TIFF and Netpbm go to the C++ library of ``native/decoder.py``,
byte-equal to cv2. :func:`decode_image` dispatches on the magic bytes:

- :func:`decode_png`: PNG bytes → RGB uint8 HWC with the native runtime's
  transform set, itself cv2.imread's: 16-bit samples keep their high byte,
  palettes and 1/2/4-bit grey expand to 8 bits, alpha is dropped, grey is
  copied to three channels; every filter type, Adam7 interlacing. None when
  the bytes are not a PNG or do not decode (a critical chunk's CRC, a bad
  header, too little image data).
- :func:`decode_image`: PNG to :func:`decode_png`; JPEG, BMP, TIFF and
  Netpbm (:data:`DECODED`) to ``decoder.decode``; a format cv2 reads that
  the port does not (the list is :func:`unported_format`'s) raises
  ``UnportedFormat`` naming ROADMAP A2c; unknown bytes give None.
- :func:`resize_u8`: OpenCV's fixed-point INTER_LINEAR on uint8 (11-bit
  coefficients from float32 source coordinates, the vectorized path's
  rounding), as ``cxr_native.cpp`` computes it.
- :func:`batch_resize_u8` and :func:`batch_load_resize_u8`: the batched
  forms. Reading, inflating, the C++ library's decoding and resizing run
  over a thread pool (``zlib``, ctypes and numpy's larger operations release the
  interpreter lock); the PNG scanline reconstruction runs in the calling
  thread, since its many small numpy steps hold the lock
  (``tools/decode_threads.py`` times each stage both ways).

Average and Paeth rows depend on the pixel to their left, so they are
reconstructed one anti-diagonal of pixels a numpy step; the images a call
decodes share those steps, zero-padded into stacks of up to _STACK_BYTES of
working arrays (~100 MB).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import decoder
from .decoder import UnportedFormat

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the formats besides PNG that the port decodes (native/decoder.py)
DECODED = ("JPEG", "BMP", "TIFF", "Netpbm")
# what cv2's PFM reader takes for the byte after the magic (isspace)
_SPACE = (b" ", b"\t", b"\n", b"\v", b"\f", b"\r")
# samples a pixel and the bit depths each colour type allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# libpng's default limit on either side of an image
_MAX_SIDE = 1_000_000
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))

# bytes of the reconstruction arrays of one stack of images (_diagonals)
_STACK_BYTES = 96 << 20
# OpenCV's INTER_RESIZE_COEF_BITS
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


class _Png(NamedTuple):
    width: int
    height: int
    depth: int
    color: int
    interlace: int
    palette: Optional[np.ndarray]  # [256, 3] uint8, zero past its entries
    idat: bytes


def _parse(data: bytes) -> Optional[_Png]:
    """The header, palette and image data of a PNG, or None. Reads chunks up
    to the end of the first run of IDAT chunks, as libpng's row reader
    does; a critical chunk's CRC is checked, an ancillary one's is not."""
    if len(data) < 8 or data[:8] != _SIGNATURE:
        return None
    pos, ihdr, palette, idat, in_idat = 8, None, None, [], False
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data) or length > 0x7FFFFFFF:
            if in_idat or kind == b"IDAT" or not idat:
                return None  # image data or the header cut short
            break
        body = data[pos + 8:pos + 8 + length]
        if not kind[0] & 0x20 and zlib.crc32(kind + body) != struct.unpack(
                ">I", data[end - 4:end])[0]:
            return None
        if ihdr is None and kind != b"IHDR":
            return None
        if kind == b"IHDR":
            if length != 13 or ihdr is not None:
                return None
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE" and not idat:
            if length % 3 or length > 768:
                return None
            palette = np.zeros((256, 3), np.uint8)
            palette[:length // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            if idat and not in_idat:
                break  # a second run of image data is never read
            idat.append(body)
            in_idat = True
        elif in_idat:
            break  # the image data has ended
        if kind == b"IEND":
            break
        pos = end
    if ihdr is None or not idat:
        return None
    w, h, depth, color, compression, filt, interlace = ihdr
    if (not 0 < w <= _MAX_SIDE or not 0 < h <= _MAX_SIDE or color not in _CHANNELS
            or depth not in _DEPTHS[color] or compression or filt or interlace > 1
            or (color == 3 and palette is None)):
        return None
    return _Png(w, h, depth, color, interlace, palette, b"".join(idat))


def png_info(data: bytes) -> Optional[Tuple[int, int]]:
    """(height, width) of a PNG's header, or None if it is not one."""
    png = _parse(data)
    return None if png is None else (png.height, png.width)


def _inflate(png: _Png) -> Optional[np.ndarray]:
    try:
        return np.frombuffer(zlib.decompressobj().decompress(png.idat), np.uint8)
    except zlib.error:
        return None


def _passes(png: _Png):
    """(x0, y0, dx, dy, width, height, stride) of each non-empty pass."""
    bits = _CHANNELS[png.color] * png.depth
    out = []
    for x0, y0, dx, dy in _ADAM7 if png.interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(png.width - x0) // dx), -(-(png.height - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph, (pw * bits + 7) // 8))
    return out


def _scanlines(png: _Png, raw: Optional[np.ndarray]) -> Optional[List[np.ndarray]]:
    """Each pass's filtered scanlines, [height, stride + 1] (each row led by
    its filter type); None when the data is short or a filter type unknown."""
    if raw is None:
        return None
    pos, out = 0, []
    for *_, ph, stride in _passes(png):
        size = ph * (stride + 1)
        if pos + size > raw.size:
            return None  # too little image data
        rows = raw[pos:pos + size].reshape(ph, stride + 1)
        if (rows[:, 0] > 4).any():
            return None
        out.append(rows)
        pos += size
    return out


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[n, h, stride + 1] filtered scanlines of n images → [n, h, stride]
    bytes. Rows where every image has a None, Sub or Up filter take a few
    numpy operations each; the rows from the first Average or Paeth row of
    any image to the last go through :func:`_diagonals`. Images shorter or
    narrower than the stack are padded with None-filtered zeros, which no
    byte of theirs depends on."""
    ftype, x = rows[:, :, 0], rows[:, :, 1:]
    n, h, stride = x.shape
    out = np.empty((n, h, stride), np.uint8)
    slow = np.flatnonzero((ftype >= 3).any(0))
    first, last = (int(slow[0]), int(slow[-1])) if slow.size else (h, h - 1)

    def fast(r):
        f, xr = ftype[:, r, None], x[:, r]
        sub = np.cumsum(xr.reshape(n, -1, bpp), axis=1, dtype=np.uint8).reshape(n, stride)
        out[:, r] = np.where(f == 0, xr, np.where(f == 1, sub, xr + (out[:, r - 1] if r else 0)))

    for r in range(first):
        fast(r)
    if slow.size:
        prev = out[:, first - 1] if first else np.zeros((n, stride), np.uint8)
        out[:, first:last + 1] = _diagonals(x[:, first:last + 1], ftype[:, first:last + 1],
                                            prev, bpp)
    for r in range(last + 1, h):
        fast(r)
    return out


def _diagonals(x: np.ndarray, ftype: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of any filter types, reconstructed along anti-diagonals of
    pixels: pixel (r, c) needs (r, c - 1), (r - 1, c) and (r - 1, c - 1),
    all on earlier diagonals, so each diagonal is one vector step over
    every image of the stack. The rows are stored skewed and diagonal-major,
    pixel (r, c) of image i at S[r + c + 2, i, r + 1] (row 0 the row above,
    S[r + 1, :, r + 1] the zero left edge), so that a step reads and writes
    contiguous memory."""
    n, m, stride = x.shape
    p = stride // bpp
    rows = np.arange(m)[:, None]
    diag = rows + np.arange(p)  # pixel (r, c) -> diagonal r + c
    xs = np.zeros((m + p - 1, n, m, bpp), np.int16)
    xs[diag, :, rows] = x.reshape(n, m, p, bpp).transpose(1, 2, 0, 3)
    S = np.zeros((m + p + 1, n, m + 1, bpp), np.int16)
    S[1:p + 1, :, 0] = prev.reshape(n, p, bpp).transpose(1, 0, 2)
    masks = [(ftype == k)[:, :, None] for k in range(1, 5)]
    average, paeth = bool(masks[2].any()), bool(masks[3].any())
    for t in range(m + p - 1):
        lo, hi = max(0, t - p + 1), min(m, t + 1)
        a, b, c = S[t + 1, :, lo + 1:hi + 1], S[t + 1, :, lo:hi], S[t, :, lo:hi]
        f1, f2, f3, f4 = (k[:, lo:hi] for k in masks)
        pred = np.where(f1, a, np.where(f2, b, 0))
        if average:
            pred = np.where(f3, (a + b) >> 1, pred)
        if paeth:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where(f4, np.where((pa <= pb) & (pa <= pc), a,
                                         np.where(pb <= pc, b, c)), pred)
        S[t + 2, :, lo + 1:hi + 1] = (xs[t, :, lo:hi] + pred) & 255
    got = S[diag + 2, :, rows + 1]  # [m, p, n, bpp]
    return got.transpose(2, 0, 1, 3).reshape(n, m, stride).astype(np.uint8)


def _stacks(blocks: List[np.ndarray], bpp: int) -> List[List[int]]:
    """Positions of ``blocks`` (scanline arrays of one bpp) grouped into
    stacks of similar sizes whose reconstruction arrays stay within
    _STACK_BYTES."""
    order = sorted(range(len(blocks)), key=lambda i: blocks[i].shape)
    out: List[List[int]] = []
    h = w = 0
    for i in order:
        bh, bw = blocks[i].shape
        nh, nw = max(h, bh), max(w, bw)
        if out and (len(out[-1]) + 1) * nh * (nh * bpp + nw) * 4 <= _STACK_BYTES:
            out[-1].append(i)
            h, w = nh, nw
        else:
            out.append([i])
            h, w = bh, bw
    return out


def _unfilter_blocks(blocks: List[np.ndarray], bpp: int) -> List[np.ndarray]:
    """Each [h, stride + 1] scanline block (one bpp) → its [h, stride]
    bytes, through :func:`_unfilter` on zero-padded stacks."""
    out: List[Optional[np.ndarray]] = [None] * len(blocks)
    for stack in _stacks(blocks, bpp):
        h = max(blocks[i].shape[0] for i in stack)
        w = max(blocks[i].shape[1] for i in stack)
        padded = np.zeros((len(stack), h, w), np.uint8)
        for j, i in enumerate(stack):
            padded[j, :blocks[i].shape[0], :blocks[i].shape[1]] = blocks[i]
        got = _unfilter(padded, bpp)
        for j, i in enumerate(stack):
            out[i] = got[j, :blocks[i].shape[0], :blocks[i].shape[1] - 1]
    return out


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """[h, stride] unfiltered bytes → [h, w, channels] uint8 samples (16-bit
    samples keep their high byte; 1/2/4-bit samples unpacked, unscaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        return rows[:, :2 * w * channels:2].reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _rgb(png: _Png, unfiltered: List[np.ndarray]) -> np.ndarray:
    """Each pass's unfiltered bytes → the RGB uint8 image."""
    channels = _CHANNELS[png.color]
    samples = np.empty((png.height, png.width, channels), np.uint8)
    for (x0, y0, dx, dy, pw, _, _), rows in zip(_passes(png), unfiltered):
        samples[y0::dy, x0::dx] = _samples(rows, pw, png.depth, channels)
    if png.color == 3:
        return png.palette[samples[..., 0]]
    if png.color in (2, 6):
        return np.ascontiguousarray(samples[..., :3])
    grey = samples[..., 0]
    if png.depth < 8:
        grey = grey * np.uint8(255 // ((1 << png.depth) - 1))
    return np.repeat(grey[..., None], 3, axis=2)


def _decode_other(data: bytes, file: bool) -> Optional[np.ndarray]:
    """Bytes that are not a PNG: a format cv2 reads and the port does not
    raises; the rest goes to the C++ library, which decodes JPEG, BMP, TIFF
    and Netpbm and gives None for anything else."""
    name = unported_format(data)
    if name is not None:
        raise UnportedFormat(f"{name} images are not decoded (ROADMAP A2c): the port "
                             f"decodes PNG, {', '.join(DECODED)}")
    return decoder.decode(data, file)


def _decode_many(datas: Sequence[Optional[bytes]], pool=None, file: bool = False,
                 png_only: bool = False) -> List[Optional[np.ndarray]]:
    """Image bytes (or None) → RGB images (or None where bytes fail to
    decode), each as :func:`decode_image` with ``file`` decodes it (as
    :func:`decode_png` with ``png_only``), over ``pool`` if one is given.
    The one place bytes go to a decoder by their magic. The scanlines of all
    the PNGs, by bytes per pixel, are reconstructed in stacks, so one numpy
    step serves many images."""
    mapper = pool.map if pool else map
    others = [None] * len(datas) if png_only else list(mapper(
        lambda d: None if d is None or d[:8] == _SIGNATURE else _decode_other(d, file), datas))
    pngs = [None if d is None else _parse(d) for d in datas]
    raws = list(mapper(lambda png: None if png is None else _inflate(png), pngs))
    scans = [None if png is None else _scanlines(png, raw) for png, raw in zip(pngs, raws)]
    del raws
    unfiltered: List[List[Optional[np.ndarray]]] = [[None] * len(s) if s else [] for s in scans]
    by_bpp: dict = {}
    for i, (png, blocks) in enumerate(zip(pngs, scans)):
        for j, block in enumerate(blocks or ()):
            by_bpp.setdefault(max(1, _CHANNELS[png.color] * png.depth // 8), []).append(
                (i, j, block))
    for bpp, items in by_bpp.items():
        for (i, j, _), rows in zip(items, _unfilter_blocks([b for *_, b in items], bpp)):
            unfiltered[i][j] = rows
    return [other if blocks is None else _rgb(png, unfiltered[i])
            for i, (png, blocks, other) in enumerate(zip(pngs, scans, others))]


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes → RGB uint8 [H, W, 3] (see the module docstring), or None
    when the bytes are not a PNG or fail to decode."""
    return _decode_many([data], png_only=True)[0]


def unported_format(data: bytes) -> Optional[str]:
    """The name of the image format of ``data`` when cv2 reads it and the
    port does not decode it (ROADMAP A2c), else None. The one list of what
    stays refused by format; the variants of a decoded format that stay
    refused (a JPEG or TIFF codec, CMYK, ...) are the library's (its
    sources' headers name them)."""
    head = bytes(data[:16])
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:4] == b"\xff\x4f\xff\x51" or head[:12] == b"\0\0\0\x0cjP  \r\n\x87\n":
        return "JPEG 2000"
    if head[:1] == b"P" and head[1:2] in (b"f", b"F") and head[2:3] in _SPACE:
        return "PFM"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if head[:4] == b"\x59\xa6\x6a\x95":
        return "Sun raster"
    if head.startswith((b"#?RADIANCE", b"#?RGBE")):
        return "Radiance HDR"
    if head[:4] == b"\x76\x2f\x31\x01":
        return "OpenEXR"
    if head[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    return None


def decode_image(data: bytes, file: bool = False) -> Optional[np.ndarray]:
    """Image bytes → RGB uint8 [H, W, 3] as the JAX package decodes them
    (its native PNG runtime, else cv2), or None where it gets no image.
    ``file`` decodes as ``cv2.imread`` reads a file rather than as
    ``cv2.imdecode`` decodes a buffer (they differ on a JPEG cut short and
    on uncompressed TIFF tiles). Raises :class:`UnportedFormat` for a format
    (:func:`unported_format`) or variant cv2 reads and the port does not
    decode (ROADMAP A2c)."""
    return _decode_many([data], file=file)[0]


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


def _taps(src: int, dst: int):
    """OpenCV's interpolation table: left/top source index and the two
    11-bit coefficients of each output position, from float32 source
    coordinates (``cxr_native.cpp build_table``)."""
    d = np.arange(dst, dtype=np.float64)
    s = ((d + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i = np.floor(s)
    f = (s - i).astype(np.float32)
    i = i.astype(np.int64)
    low, high = i < 0, i >= src - 1
    i[low], f[low] = 0, 0
    i[high], f[high] = src - 1, 0
    scale = np.float32(_COEF_SCALE)
    c0 = np.clip(np.rint((np.float32(1) - f) * scale), -32768, 32767).astype(np.int64)
    c1 = np.clip(np.rint(f * scale), -32768, 32767).astype(np.int64)
    return i, np.minimum(i + 1, src - 1), c0, c1


def resize_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR)-parity uint8 HWC resize."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, _ = src.shape
    xi, xi1, a0, a1 = _taps(sw, dw)
    yi, yi1, b0, b1 = _taps(sh, dh)
    used, inverse = np.unique(np.concatenate([yi, yi1]), return_inverse=True)
    rows = src[used].astype(np.int64)
    horiz = rows[:, xi] * a0[:, None] + rows[:, xi1] * a1[:, None]  # [rows, dw, c]
    r0, r1 = horiz[inverse[:dh]], horiz[inverse[dh:]]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    interior = (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    # a row with no second tap (fy == 0): exact 11-bit rounding of one row
    border = (r0 + (_COEF_SCALE >> 1)) >> _COEF_BITS
    return np.clip(np.where(b1 == 0, border, interior), 0, 255).astype(np.uint8)


def _pool(threads: int) -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=threads if threads > 0 else (os.cpu_count() or 1))


def batch_resize_u8(images: Sequence[np.ndarray], dh: int, dw: int,
                    threads: int = 0) -> np.ndarray:
    """Variable-size uint8 HWC images → NHWC uint8 batch (threaded)."""
    c = images[0].shape[2]
    out = np.empty((len(images), dh, dw, c), np.uint8)

    def fill(i):
        out[i] = resize_u8(images[i], dh, dw)

    with _pool(threads) as pool:
        list(pool.map(fill, range(len(images))))
    return out


def _read(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def batch_load_resize_u8(paths: Sequence[str], dh: int, dw: int,
                         threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """File paths → (NHWC RGB uint8 batch resized to dh × dw, ok flags).
    A file that cannot be read or decoded leaves its slot zero, ok False
    (the reference's decode-failure fallback); a format the port does not
    decode raises (:func:`decode_image`)."""
    out = np.zeros((len(paths), dh, dw, 3), np.uint8)
    ok = np.zeros(len(paths), bool)
    if not len(paths):
        return out, ok
    with _pool(threads) as pool:
        images = _decode_many(list(pool.map(_read, paths)), pool, file=True)

        def fill(i):
            img = images[i]
            if img is not None:
                out[i] = img if img.shape[:2] == (dh, dw) else resize_u8(img, dh, dw)
                ok[i] = True

        list(pool.map(fill, range(len(paths))))
    return out, ok


__all__: List[str] = ["DECODED", "UnportedFormat", "batch_load_resize_u8", "batch_resize_u8",
                      "decode_image", "decode_png", "png_info", "resize_u8", "unported_format"]
