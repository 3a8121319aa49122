"""Image decoding beyond PNG (ROADMAP A2c, fault C11): the port's JPEG and
BMP decoder (``native/decoder.py``, the C++ of ``native/src/decode.cpp``)
against cv2 byte for byte, and the paths that use it against the JAX
package's.

- JPEG written by cv2 and PIL at qualities 50-100, every sampling the two
  write (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), baseline and progressive, grey
  and colour, restart intervals, EXIF orientations 1-8, an RGB (Adobe)
  stream, sizes 1 x 1 to 300 x 260; held against ``cv2.imdecode`` (and, for
  a file, ``cv2.imread``) with the channels reversed, tolerance 0.
- Bad data: streams cut short (a buffer gives None, a file reads on as
  libjpeg's fake EOI), bytes changed inside the entropy data (bad Huffman
  codes, stray markers), missing tables, corrupt marker segments.
- BMP at 1, 4, 8, 16, 24 and 32 bits, BI_RGB, BI_RLE4, BI_RLE8 and
  BI_BITFIELDS, the core and info headers, rows bottom-up and top-down,
  written by cv2, PIL and the struct packing below.
- The paths: ``decode_request_image`` byte for byte with JAX's;
  ``load_image`` and ``build_image_cache`` byte for byte at downscaling and
  within 1 at upscaling (JAX resizes these files with cv2.resize, the port
  with its one ``resize_u8``); ``cache-images`` over a layout of JPEGs.
- What stays refused (arithmetic, lossless and 12-bit JPEG, CMYK, the
  Group 4, CMYK and uncompressed YCbCr TIFFs, WebP, JPEG 2000, GIF) raises
  naming A2c on every path; a failed build raises too. TIFF and Netpbm
  themselves are held in ``test_torch_image_formats_tiff_pnm.py``.

The decoder library is built at first use into the gitignored build
directory; workers that find none build into temporary files of their own
and rename them into place, so no worker reads a half-written library.
"""

import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from clip_for_dl_tpu import serving as jserving
from clip_for_dl_tpu.data import cache as jcache
from clip_for_dl_tpu.data import datasets as jdatasets
from clip_for_dl_tpu.native import bindings as jnative
from clip_for_dl_tpu_torch import serving
from clip_for_dl_tpu_torch.data import build_image_cache, datasets
from clip_for_dl_tpu_torch.native import bindings as native
from clip_for_dl_tpu_torch.native import decoder

QUALITIES = (50, 75, 95, 100)
SIZES = ((1, 1), (7, 13), (17, 33), (300, 260))
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, c, seed):
    """Noise blurred into something an encoder keeps detail of."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c) if c > 1 else (h, w)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5) if h > 8 and w > 8 else img


def _cv2_jpeg(img, quality=90, progressive=False, sampling=None, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _pil(img, fmt, **kw):
    out = io.BytesIO()
    Image.fromarray(img).save(out, fmt, **kw)
    return out.getvalue()


def _cv2_rgb(data: bytes, file_dir=None):
    """cv2's decode in RGB: imdecode of a buffer, or imread of the bytes
    written to a file under ``file_dir``."""
    if file_dir is None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    else:
        path = os.path.join(file_dir, "image.jpg")
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path)
    return None if img is None else img[..., ::-1]


def _same(data: bytes, file_dir=None):
    got = decoder.decode(data, file=file_dir is not None)
    want = _cv2_rgb(data, file_dir)
    assert (got is None) == (want is None), (got is None, want is None)
    if want is not None:
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    return got


# -- JPEG: the matrix -----------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["grey", *SAMPLING])
def test_cv2_written_jpegs_decode_equal(sampling, progressive, quality, size):
    grey = sampling == "grey"
    img = _image(*size, 1 if grey else 3, seed=quality + size[0])
    _same(_cv2_jpeg(img, quality, progressive, None if grey else sampling))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("mode", ["L", "RGB-444", "RGB-422", "RGB-420"])
def test_pil_written_jpegs_decode_equal(mode, progressive, quality, size):
    img = _image(*size, 1 if mode == "L" else 3, seed=quality * 7 + size[1])
    kw = {} if mode == "L" else {"subsampling": ["RGB-444", "RGB-422", "RGB-420"].index(mode)}
    _same(_pil(img, "JPEG", quality=quality, progressive=progressive, **kw))


@pytest.mark.parametrize("restart", [1, 3, 7])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["grey", "420", "444"])
def test_restart_intervals_decode_equal(sampling, progressive, restart):
    data = _cv2_jpeg(_image(77, 91, 1 if sampling == "grey" else 3, restart), 85, progressive,
                     None if sampling == "grey" else sampling, restart)
    assert b"\xff\xdd" in data  # a DRI marker
    _same(data)


def test_pil_restart_markers_and_optimized_tables_decode_equal():
    img = _image(100, 120, 3, 6)
    _same(_pil(img, "JPEG", quality=80, restart_marker_blocks=5))
    _same(_pil(img, "JPEG", quality=80, optimize=True))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_exif_orientation_is_applied_as_cv2_applies_it(orientation, progressive):
    exif = Image.Exif()
    exif[0x0112] = orientation
    data = _pil(_image(40, 80, 3, orientation), "JPEG", quality=90, exif=exif.tobytes(),
                progressive=progressive)
    got = _same(data)
    assert got.shape == ((80, 40, 3) if orientation >= 5 else (40, 80, 3))


def test_rgb_colour_space_decodes_equal():
    """An Adobe marker with transform 0: the components are R, G, B."""
    data = _pil(_image(30, 40, 3, 2), "JPEG", quality=90, keep_rgb=True)
    assert b"Adobe" in data
    _same(data)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_large_radiograph_decodes_equal(progressive):
    _same(_cv2_jpeg(_image(1100, 900, 1, 9), 95, progressive))


# -- JPEG: bad data ------------------------------------------------------------------


@pytest.mark.parametrize("cut", [1, 2, 3, 9, "3/4", "1/2", 300, 100])
@pytest.mark.parametrize("kind", ["grey", "420", "444-rst", "grey-progressive"])
def test_streams_cut_short_decode_as_cv2(kind, cut, tmp_path):
    """As a buffer (cv2.imdecode: None unless the MCUs were all read before
    the data ran out) and as a file (cv2.imread: libjpeg's fake EOI, the
    rest of the segment grey). A progressive stream cut short is held only
    where libjpeg would not smooth it (the refusal is tested below)."""
    grey = kind.startswith("grey")
    data = _cv2_jpeg(_image(64, 80, 1 if grey else 3, 11), 90, kind.endswith("progressive"),
                     None if grey else kind[:3], 4 if kind.endswith("rst") else 0)
    n = {"3/4": len(data) * 3 // 4, "1/2": len(data) // 2}.get(cut, None)
    short = data[:n] if n else (data[:-cut] if cut < 20 else data[:cut])  # small: from the end
    _same(short)
    try:
        _same(short, str(tmp_path))
    except decoder.UnportedFormat as exc:
        assert kind.endswith("progressive") and "block smoothing" in str(exc)


@pytest.mark.parametrize("seed", range(16))
def test_changed_entropy_bytes_decode_as_cv2(seed, tmp_path):
    """Bytes changed inside the scan data: bad Huffman codes, runs past the
    block, stray markers; values that overflow 16 bits take libjpeg-turbo's
    SIMD IDCT's saturation."""
    rng = np.random.default_rng(seed)
    kinds = [("grey", False, 0), ("420", False, 0), ("444", False, 3), ("422", True, 0)]
    sampling, progressive, restart = kinds[seed % 4]
    img = _image(16 + seed * 3, 24 + seed * 5, 1 if sampling == "grey" else 3, seed)
    data = bytearray(_cv2_jpeg(img, 50 + seed * 3, progressive,
                               None if sampling == "grey" else sampling, restart))
    sos = data.find(b"\xff\xda")
    for _ in range(1 + seed % 3):
        data[int(rng.integers(sos + 20, len(data) - 2))] = int(rng.integers(0, 256))
    for file_dir in (None, str(tmp_path)):
        try:
            _same(bytes(data), file_dir)
        except decoder.UnportedFormat as exc:
            assert progressive and "block smoothing" in str(exc)


def _segments(data):
    """(marker, start, end) of each marker segment up to the first SOS."""
    out, i = [], 2
    while True:
        marker, length = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        out.append((marker, i, i + 2 + length))
        if marker == 0xDA:
            return out
        i += 2 + length


def _without(data, keep):
    segs = [s for s in _segments(data) if keep(s)]
    return data[:2] + b"".join(data[s:e] for _, s, e in segs) + data[_segments(data)[-1][2]:]


@pytest.mark.parametrize("case", ["baseline-dc0", "baseline-ac0", "baseline-all-huffman",
                                  "baseline-quant", "progressive-first-dht",
                                  "progressive-all-huffman", "progressive-quant"])
def test_missing_tables_decode_as_cv2(case):
    """A baseline stream falls back on Annex K's Huffman tables, a
    progressive one does not; no quantization table gives None."""
    img = _image(50, 70, 3, 3)
    if case.startswith("baseline"):
        data = _pil(img, "JPEG", quality=80)  # one DHT segment a table
    else:
        data = _cv2_jpeg(img, 80, True)  # a DHT segment before each scan
    if case.endswith("quant"):
        data = _without(data, lambda s: s[0] != 0xDB)
    elif case.endswith("dc0") or case.endswith("ac0"):
        slot = 0x00 if case.endswith("dc0") else 0x10
        data = _without(data, lambda s: s[0] != 0xC4 or data[s[1] + 4] != slot)
    elif case == "progressive-first-dht":
        first = next(s for s in _segments(data) if s[0] == 0xC4)
        data = data[:first[1]] + data[first[2]:]
    else:
        out, i = bytearray(data[:2]), 2
        while i < len(data):
            if data[i] == 0xFF and data[i + 1] == 0xC4:
                i += 2 + ((data[i + 2] << 8) | data[i + 3])
            else:
                out.append(data[i])
                i += 1
        data = bytes(out)
    got = _same(data)
    assert (got is None) == (case.endswith("quant") or case.startswith("progressive"))


@pytest.mark.parametrize("corrupt", ["dht-length", "sof-length", "sos-component", "unknown-app",
                                     "empty-height", "dqt-index", "bytes-before-marker"])
def test_corrupt_markers_decode_as_cv2(corrupt):
    data = bytearray(_cv2_jpeg(_image(50, 70, 3, 3), 80))
    segs = _segments(bytes(data))
    at = {m: s for m, s, _ in reversed(segs)}
    if corrupt == "dht-length":
        data[at[0xC4] + 3] = 7
    elif corrupt == "sof-length":
        data[at[0xC0] + 3] = 5
    elif corrupt == "sos-component":
        data[segs[-1][1] + 5] = 9
    elif corrupt == "unknown-app":
        data[3] = 0x02
    elif corrupt == "empty-height":
        data[at[0xC0] + 5:at[0xC0] + 7] = b"\0\0"
    elif corrupt == "dqt-index":
        data[at[0xDB] + 4] = 5
    else:
        data[segs[2][1]:segs[2][1]] = b"\x12\x34"
    _same(bytes(data))



@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_exif_after_the_first_scan_is_ignored_as_cv2_ignores_it(progressive):
    """cv2 reads EXIF from the APP1 markers before the first scan only."""
    exif = Image.Exif()
    exif[0x0112] = 6
    payload = exif.tobytes()  # "Exif\0\0" and the TIFF header
    app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    data = _cv2_jpeg(_image(40, 80, 3, 5), 90, progressive)
    at = data.find(b"\xff\xda", data.find(b"\xff\xda") + 2) if progressive else len(data) - 2
    late = data[:at] + app1 + data[at:]
    assert _same(late).shape == (40, 80, 3)
    assert _same(data[:2] + app1 + data[2:]).shape == (80, 40, 3)


# the peak resident set of this process's memory (VmHWM: ru_maxrss would
# carry the forking parent's), in bytes
_PEAK = r"""
import json, sys
from clip_for_dl_tpu_torch.native import decoder


def peak():
    with open("/proc/self/status") as f:
        return next(int(l.split()[1]) * 1024 for l in f if l.startswith("VmHWM:"))


decoder.library()
with open(sys.argv[1], "rb") as f:
    data = f.read()
before = peak()
img = decoder.decode(data, file=sys.argv[2] == "file")
print(json.dumps([None if img is None else list(img.shape), peak() - before]))
"""


def _declaring(data: bytes, h: int, w: int) -> bytes:
    """``data`` with its SOF's height and width replaced."""
    sof = next(s for m, s, _ in _segments(data) if m in (0xC0, 0xC2))
    return data[:sof + 5] + struct.pack(">HH", h, w) + data[sof + 9:]


def _huge_tiff_and_pnm(case: str) -> bytes:
    """A TIFF or a PGM whose header declares 2048 x 2048 16-bit grey pixels,
    with a few bytes of data, or a 256 x 256 8-bit TIFF whose one strip's
    LZW or Deflate stream would inflate to 24 MB (100 times the image)."""
    import zlib

    from clip_for_dl_tpu_torch.testing.tiff import build_tiff, encode_tiff, lzw_codes

    side = 2048
    if case == "pgm-huge":
        return f"P5\n{side} {side}\n65535\n".encode() + bytes(64)
    if case == "tiff-huge":
        small = encode_tiff(_image(16, 16, 1, 3).astype(np.uint16) * 257, bps=16, compression=5)
        fields = {256: (4, [side]), 257: (4, [side]), 258: (3, [16]), 259: (3, [5]),
                  262: (3, [1]), 277: (3, [1]), 278: (4, [side]), 284: (3, [1])}
        start = 8
        return build_tiff(fields, [small[start:start + 300]])
    # every code the previous string and one more zero: each clear's run of
    # codes writes 8 MB
    data = (lzw_codes(([0] + list(range(258, 4094))) * 3) if case == "tiff-lzw-bomb"
            else zlib.compress(bytes(24 << 20), 9))
    fields = {256: (4, [256]), 257: (4, [256]), 258: (3, [8]), 259: (3, [5 if "lzw" in case else 8]),
              262: (3, [1]), 277: (3, [1]), 278: (4, [256]), 284: (3, [1])}
    return build_tiff(fields, [data])


@pytest.mark.parametrize("case", ["baseline-cut", "progressive-cut", "baseline-eoi",
                                  "progressive-eoi", "baseline-file", "tiff-huge", "pgm-huge",
                                  "tiff-lzw-bomb", "tiff-deflate-bomb"])
def test_a_huge_declared_image_holds_no_more_than_its_output(case, tmp_path):
    """A body of a few hundred bytes whose SOF declares 2048 x 2048 colour
    pixels: cut before EOI it gives None and touches a few MB; ended by EOI
    (or read as a file) it is grey and holds about its output, as cv2 does,
    not a whole image of coefficients and of samples besides. A TIFF that
    declares as much holds no more than its output (the strip's buffer is
    touched only where data decodes), a PGM nothing (its data is short); a
    strip whose LZW or Deflate stream inflates past its size is cut at it.
    The peak is read in a process of its own."""
    import json
    import subprocess
    import sys

    side = 2048
    if case.startswith(("tiff", "pgm")):
        data = _huge_tiff_and_pnm(case)
    else:
        data = _declaring(_cv2_jpeg(_image(16, 16, 3, 1), 90, case.startswith("progressive"),
                                    "444"), side, side)
        if case.endswith("cut") or case.endswith("file"):
            data = data[:-2]
    path = tmp_path / "huge.img"
    path.write_bytes(data)
    mode = "file" if case.endswith("file") else "buffer"
    run = subprocess.run([sys.executable, "-c", _PEAK, str(path), mode], capture_output=True,
                         text=True, cwd=os.path.dirname(os.path.dirname(__file__)), timeout=120)
    assert run.returncode == 0, run.stderr
    shape, grown = json.loads(run.stdout)
    if case.endswith("cut") or case == "pgm-huge":
        assert shape is None and grown < 4 << 20, run.stdout
        assert _cv2_rgb(data) is None
    elif case.endswith("bomb"):
        assert shape == [256, 256, 3] and grown < 4 << 20, run.stdout
        _same(data)
    else:  # the old decoder's coefficients, planes and copy: 5 times the output
        assert shape == [side, side, 3] and grown < side * side * 3 + (4 << 20), run.stdout
    if case.endswith("eoi") or case == "tiff-huge":
        _same(data)


# -- BMP ------------------------------------------------------------------------------


def _bmp(width, height, bpp, data, palette=None, compression=0, header=40, masks=None,
         top_down=False):
    """A BMP file: ``data`` the stored pixel rows (or the RLE stream)."""
    n = 0 if palette is None else len(palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
        pal = b"".join(bytes(p) for p in palette) if n else b""
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bpp, compression, 0, 2835, 2835, n, 0)
        extra = struct.pack(f"<{len(masks)}I", *masks) if masks and header > 40 else b""
        info += extra + b"\0" * (header - 40 - len(extra))
        pal = b"".join(bytes(p) + b"\0" for p in palette) if n else b""
        if masks and header == 40:
            pal = struct.pack(f"<{len(masks)}I", *masks) + pal
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + pal + data


def _rows(pixels, bpp, bottom_up=True):
    """[h, w] indices or [h, w, k] bytes → stored rows, each padded to 4 bytes."""
    out = []
    for row in (pixels[::-1] if bottom_up else pixels):
        if bpp < 8:
            per = 8 // bpp
            idx = list(row) + [0] * (-len(row) % per)
            raw = bytes(sum(int(v) << (8 - bpp * (j + 1)) for j, v in enumerate(idx[i:i + per]))
                        for i in range(0, len(idx), per))
        else:
            raw = np.ascontiguousarray(row).tobytes()
        out.append(raw + b"\0" * (-len(raw) % 4))
    return b"".join(out)


def _rle8(indices):
    """Rows as encoded runs and absolute runs, each row ended by EOL, then EOB."""
    out = bytearray()
    for row in indices[::-1]:
        row, x = [int(v) for v in row], 0
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 2 or len(row) - x < 3:
                out += bytes([n, row[x]])
                x += n
            else:
                m = min(len(row) - x, 255)
                out += bytes([0, m, *row[x:x + m]]) + b"\0" * (m % 2)
                x += m
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(indices):
    """Rows as two-colour encoded runs and absolute runs, EOL, then EOB."""
    out = bytearray()
    for row in indices[::-1]:
        row, x = [int(v) for v in row], 0
        while x < len(row):
            m = min(len(row) - x, 6)
            if m >= 3 and (x // 3) % 2:
                packed = bytes((row[x + i] << 4) | (row[x + i + 1] if i + 1 < m else 0)
                               for i in range(0, m, 2))
                out += bytes([0, m]) + packed + b"\0" * (len(packed) % 2)
                x += m
                continue
            n = min(len(row) - x, 2 + x % 3)
            out += bytes([n, (row[x] << 4) | (row[x + 1] if n > 1 else 0)])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("writer", ["cv2-grey", "cv2-bgr", "PIL-1", "PIL-L", "PIL-P", "PIL-RGB",
                                    "PIL-RGBA"])
def test_written_bmps_decode_equal(writer, size):
    img = _image(*size, 3, seed=size[0] * size[1])
    if writer.startswith("cv2"):
        ok, buf = cv2.imencode(".bmp", img[..., 0] if writer == "cv2-grey" else img)
        assert ok
        data = buf.tobytes()
    else:
        mode = writer[4:]
        im = Image.fromarray(img)
        if mode == "P":
            im = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=13)
        elif mode == "RGBA":
            im = Image.fromarray(np.dstack([img, img[..., :1]]))
        else:
            im = im.convert(mode)
        out = io.BytesIO()
        im.save(out, "BMP")
        data = out.getvalue()
    _same(data)


BMP_CASES = ["pal1", "pal4", "pal8", "pal1-core", "pal4-core", "pal8-core", "pal8-topdown",
             "pal4-short-palette", "24-core", "24-topdown", "24-v5", "16-rgb", "16-565",
             "16-555", "16-bad-masks", "32-rgb", "32-bitfields", "32-v5-rgba", "32-v5-5bit",
             "32-core", "rle8", "rle4", "rle8-delta-eob", "rle4-delta-eob", "rle8-overrun",
             "rle8-short", "24-short", "bad-compression"]


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (40, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", BMP_CASES)
def test_packed_bmps_decode_equal(case, size):
    """Every depth, compression, header and row order cv2's reader takes,
    including the bad ones it refuses."""
    h, w = size
    rng = np.random.default_rng(len(case) * 31 + h)
    palette = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256)]
    bgr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    words = rng.integers(0, 65536, (h, w)).astype("<u2")
    bgra = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if case.startswith("pal"):
        bpp = int(case[3])
        idx = rng.integers(0, (1 << bpp) // (2 if "short" in case else 1), (h, w))
        pal = palette[:(1 << bpp) // (2 if "short" in case else 1)]
        data = _bmp(w, h, bpp, _rows(idx, bpp, "topdown" not in case), pal,
                    header=12 if "core" in case else 40, top_down="topdown" in case)
    elif case.startswith("24"):
        data = _bmp(w, h, 24, _rows(bgr, 24, case != "24-topdown"),
                    header={"24-core": 12, "24-v5": 124}.get(case, 40), top_down=case == "24-topdown")
        if case == "24-short":
            data = data[:-3]
    elif case.startswith("16"):
        masks = {"16-565": (0xF800, 0x7E0, 0x1F), "16-555": (0x7C00, 0x3E0, 0x1F),
                 "16-bad-masks": (0xF00, 0xF0, 0xF)}.get(case)
        data = _bmp(w, h, 16, _rows(words, 16), compression=3 if masks else 0, masks=masks)
    elif case.startswith("32"):
        masks = {"32-bitfields": (0xFF0000, 0xFF00, 0xFF),
                 "32-v5-rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                 "32-v5-5bit": (0x1F, 0x3E0, 0x7C00, 0x8000)}.get(case)
        data = _bmp(w, h, 32, _rows(bgra, 32), compression=3 if masks else 0, masks=masks,
                    header=124 if "v5" in case else (12 if case == "32-core" else 40))
    elif case == "bad-compression":
        data = _bmp(w, h, 24, _rows(bgr, 24), compression=5)
    else:
        bpp = 8 if case.startswith("rle8") else 4
        idx = rng.integers(0, 4, (h, w))
        if case in ("rle8", "rle4"):
            stream = _rle8(idx) if bpp == 8 else _rle4(idx)
        elif case == "rle8-short":
            stream = _rle8(idx)[:-4]
        elif case == "rle8-overrun":
            stream = bytes([w + 1, 3, 0, 1])
        else:  # a run, a delta (dx 1, dy 1), a run, end of line, a run, end of bitmap
            colour = 0x57 if bpp == 4 else 5
            stream = bytes([1, colour, 0, 2, 1, 1, 1, colour, 0, 0, 1, colour, 0, 1])
        data = _bmp(w, h, bpp, stream, palette[:1 << bpp], compression=1 if bpp == 8 else 2)
    _same(data)



# -- bad data under the sanitizers -----------------------------------------------------

_SANITIZED_DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" int cxr_open(const uint8_t*, size_t, int, void**, int*, int*, char*, int);
extern "C" int cxr_finish(void*, uint8_t*, char*, int);
extern "C" void cxr_close(void*);

// Each file decoded as a buffer and as a file, from a heap copy of exactly
// its size, into an output of exactly the image's size
int main(int argc, char** argv) {
  int decoded = 0;
  for (int i = 1; i < argc; ++i) {
    FILE* f = std::fopen(argv[i], "rb");
    if (!f) return 2;
    std::vector<uint8_t> bytes;
    for (int c; (c = std::fgetc(f)) != EOF;) bytes.push_back(static_cast<uint8_t>(c));
    std::fclose(f);
    for (int file = 0; file < 2; ++file) {
      std::vector<uint8_t> data(bytes);
      void* handle = nullptr;
      int h = 0, w = 0;
      char message[64];
      if (cxr_open(data.data(), data.size(), file, &handle, &h, &w, message, sizeof message))
        continue;
      size_t n = static_cast<size_t>(h) * w * 3;
      if (n > (size_t(64) << 20)) {  // a header that declares a huge image
        cxr_close(handle);
        continue;
      }
      std::vector<uint8_t> out(n);
      decoded += cxr_finish(handle, out.data(), message, sizeof message) == 0;
    }
  }
  std::printf("%d decodes\n", decoded);
  return 0;
}
"""


def _tiff_and_pnm_bases():
    """TIFFs of every layout, codec and photometric the decoder reads (and
    the headers of some it refuses), and Netpbm files of every kind."""
    from clip_for_dl_tpu_torch.testing.tiff import encode_tiff

    rng = np.random.default_rng(8)
    grey = _image(19, 37, 1, 3)
    grey16 = grey.astype(np.uint16) * 257 + rng.integers(0, 256, grey.shape)
    rgba = rng.integers(0, 256, (19, 37, 4))
    pal = rng.integers(0, 65536, (256, 3))
    out = [encode_tiff(grey16, bps=16, compression=5, predictor=2, rows_per_strip=5),
           encode_tiff(grey16, bps=16, compression=8, tile=(16, 32), order=">", big=True),
           encode_tiff(grey, compression=5, old_lzw=True, orientation=6, fill_order=2),
           encode_tiff(rgba, compression=32773, extra=(2,), planar=2, tile=(16, 16)),
           encode_tiff(rgba.astype(np.uint16) * 300, bps=16, compression=1, extra=(2,)),
           encode_tiff(grey, photometric=3, colormap=pal, compression=8, predictor=2),
           encode_tiff(grey > 128, bps=1, photometric=0, compression=32773, orientation=3),
           encode_tiff(grey, photometric=5, tags={332: (3, [1])}),  # CMYK, refused
           _pil(_image(40, 48, 3, 4), "TIFF", compression="jpeg"),
           _pil(_image(24, 32, 1, 5), "TIFF", compression="jpeg"),
           cv2.imencode(".pgm", grey16)[1].tobytes(), cv2.imencode(".ppm", _image(9, 11, 3, 6))[1].tobytes(),
           cv2.imencode(".pbm", grey)[1].tobytes(), cv2.imencode(".pam", rgba.astype(np.uint8))[1].tobytes(),
           b"P2\n# c\n5 3\n15\n" + b" ".join(b"%d" % v for v in rng.integers(0, 20, 15)) + b"\n",
           b"P1\n5 3\n" + bytes(rng.integers(48, 50, 15).astype(np.uint8)) + b"\n"]
    return out


def _bad_corpus():
    """JPEGs, BMPs, TIFFs and Netpbm files cut at many points and with bytes
    changed anywhere, headers included."""
    rng = np.random.default_rng(7)
    bases = [_cv2_jpeg(_image(33, 47, 1, 1), 75), _cv2_jpeg(_image(33, 47, 3, 2), 60, False, "420"),
             _cv2_jpeg(_image(40, 24, 3, 3), 90, False, "444", 2),
             _cv2_jpeg(_image(33, 47, 3, 4), 80, True, "422"),
             _cv2_jpeg(_image(26, 30, 1, 5), 50, True),
             _pil(_image(21, 35, 3, 6), "JPEG", quality=70, subsampling=2, optimize=True)]
    idx = rng.integers(0, 4, (9, 11))
    pal = [(10 * i, 15 * i, 16 * i) for i in range(16)]
    bases += [_bmp(11, 9, 4, _rows(idx, 4), pal), _bmp(11, 9, 8, _rle8(idx), pal, compression=1),
              _bmp(11, 9, 4, _rle4(idx), pal, compression=2),
              _bmp(11, 9, 16, _rows(rng.integers(0, 65536, (9, 11)).astype("<u2"), 16),
                   compression=3, masks=(0xF800, 0x7E0, 0x1F)),
              _bmp(11, 9, 32, _rows(rng.integers(0, 256, (9, 11, 4)).astype(np.uint8), 32),
                   compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), header=124),
              _bmp(11, 9, 24, _rows(rng.integers(0, 256, (9, 11, 3)).astype(np.uint8), 24, False),
                   top_down=True)]
    bases += _tiff_and_pnm_bases()
    corpus = []
    for data in bases:
        corpus += [data[:int(n)] for n in np.linspace(0, len(data) - 1, 24)]
        for _ in range(32):
            bad = bytearray(data)
            for at in rng.integers(0, len(data), int(rng.integers(1, 5))):
                bad[at] = int(rng.integers(0, 256))
            corpus.append(bytes(bad))
    return corpus


def test_bad_data_is_clean_under_address_and_undefined_sanitizers(tmp_path):
    """The decoder built with -fsanitize=address,undefined (every finding
    fatal) over the corpus above (JPEG, BMP, TIFF, Netpbm), each input as a
    buffer and as a file: no read or write out of bounds, no undefined
    behaviour, no leak."""
    import subprocess

    driver = tmp_path / "driver.cpp"
    driver.write_text(_SANITIZED_DRIVER)
    binary = tmp_path / "sanitized"
    build = subprocess.run([decoder._compiler(), "-O1", "-g", "-std=c++17",
                            "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                            "-fno-omit-frame-pointer", "-o", str(binary),
                            *map(str, decoder.SOURCES), str(driver), *decoder.LIBS],
                           capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr
    paths = []
    for i, data in enumerate(_bad_corpus()):
        paths.append(tmp_path / f"bad{i}")
        paths[-1].write_bytes(data)
    run = subprocess.run([str(binary), *map(str, paths)], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, ASAN_OPTIONS="detect_leaks=1"))
    assert run.returncode == 0, run.stderr[-4000:]
    assert int(run.stdout.split()[0]) > len(paths) // 4, run.stdout  # not all refused


# -- the paths, JAX against the port --------------------------------------------------


def _files(tmp_path, shape, seed=0):
    """A JPEG and a BMP of one grey image, as files."""
    img = _image(*shape, 1, seed)
    jpg, bmp = tmp_path / f"x{seed}.jpg", tmp_path / f"x{seed}.bmp"
    jpg.write_bytes(_cv2_jpeg(img, 92))
    bmp.write_bytes(cv2.imencode(".bmp", img)[1].tobytes())
    return [str(jpg), str(bmp)]


@pytest.mark.parametrize("fmt", [".jpg", ".bmp"])
@pytest.mark.parametrize("shape", [(300, 260, 3), (100, 90, 1), (24, 24, 3)])
@pytest.mark.parametrize("size", [32, 224])
def test_decode_request_image_is_byte_equal_to_jax(fmt, shape, size):
    ok, buf = cv2.imencode(fmt, _image(*shape[:2], shape[2], sum(shape)))
    assert ok
    np.testing.assert_array_equal(serving.decode_request_image(buf.tobytes(), "image/jpeg", size),
                                  jserving.decode_request_image(buf.tobytes(), "image/jpeg", size))


def _held(got, want, upscaling):
    """Byte for byte at downscaling, within 1 at upscaling (the cv2.resize
    split)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    if upscaling:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [((300, 260), 224), ((300, 260), None), ((100, 90), 224),
                                        ((300, 260), 512)])
def test_load_image_matches_jax(tmp_path, shape, size):
    """C11: the port gave the zero image for these files."""
    for path in _files(tmp_path, shape):
        got = datasets.load_image(path, size)
        assert got.any()
        _held(got, jdatasets.load_image(path, size), size is not None and size > min(shape))


def test_build_image_cache_matches_jax(tmp_path):
    paths = _files(tmp_path, (300, 260), 1) + _files(tmp_path, (100, 90), 2)
    (tmp_path / "text.jpg").write_bytes(b"not an image")
    paths.append(str(tmp_path / "text.jpg"))
    for size in (64, 224):
        got = build_image_cache(paths, size, str(tmp_path / f"port{size}"), workers=2)
        want = jcache.build_image_cache(paths, size, str(tmp_path / f"jax{size}"), workers=2)
        assert got.channels == want.channels
        for p in paths:
            _held(got.get(p), want.get(p), size > 90 and os.path.basename(p).startswith("x2"))
        assert not got.get(paths[-1]).any()


def test_live_reads_and_the_batch_loader_decode_jpeg_and_bmp(tmp_path):
    paths = _files(tmp_path, (300, 260), 3)
    batch, ok = native.batch_load_resize_u8(paths, 64, 64, threads=2)
    assert ok.all() and batch.any()
    for path, row in zip(paths, batch):
        np.testing.assert_array_equal(row, datasets.load_image(path, 64))
        np.testing.assert_array_equal(row, jnative.resize_u8(_cv2_rgb(open(path, "rb").read()),
                                                             64, 64))


def test_cache_images_over_a_jpeg_layout_is_not_zero(tmp_path, monkeypatch):
    """The CLI walks .jpg files; every row holds the decoded image, equal
    to the JAX CLI's cache at downscaling."""
    import importlib

    jcli = importlib.import_module("clip_for_dl_tpu.cli.main")
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    d = tmp_path / "images"
    d.mkdir()
    for i in range(4):
        (d / f"CXR{i}_IM-0001-1001.jpg").write_bytes(_cv2_jpeg(_image(120, 100, 1, i), 95))
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        assert main(["cache-images", "--image-dir", str(d), "--out", str(tmp_path / tag),
                     "--image-size", "64", "--workers", "2"]) == 0
    from clip_for_dl_tpu_torch.data import ImageCache

    got, want = ImageCache(str(tmp_path / "port")), jcache.ImageCache(str(tmp_path / "jax"))
    assert len(got) == 4 and got.channels == want.channels == 1
    for name in sorted(os.listdir(d)):
        row = got.get(str(d / name))
        assert row.any()
        np.testing.assert_array_equal(row, want.get(str(d / name)))


# -- what stays refused ----------------------------------------------------------------


def _refused_bodies():
    img = _image(24, 24, 3, 5)
    base = _cv2_jpeg(img, 80)
    sof = next(s for m, s, _ in _segments(base) if m == 0xC0)

    def patched(index, value):
        data = bytearray(base)
        data[sof + index] = value
        return bytes(data)

    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    out = {"arithmetic": patched(1, 0xC9), "lossless": patched(1, 0xC3),
           "12-bit": patched(4, 12), "CMYK": cmyk.getvalue()}
    big = _image(64, 64, 3, 5)  # OpenJPEG wants a few resolution levels
    for fmt in (".webp", ".jp2"):
        ok, buf = cv2.imencode(fmt, big if fmt == ".jp2" else img)
        assert ok
        out[fmt] = buf.tobytes()
    # the TIFF variants that stay refused (TIFF itself decodes)
    for name, mode, compression in (("tiff-group4", "1", "group4"), ("tiff-cmyk", "CMYK", None),
                                    ("tiff-ycbcr", "YCbCr", None)):
        tiff = io.BytesIO()
        Image.fromarray(img).convert(mode).save(tiff, "TIFF", compression=compression)
        out[name] = tiff.getvalue()
    gif = io.BytesIO()
    Image.fromarray(img).save(gif, "GIF")
    out["GIF"] = gif.getvalue()
    return out


REFUSED = _refused_bodies()


@pytest.mark.parametrize("kind", list(REFUSED))
def test_unported_variants_raise_naming_a2c_on_every_path(kind, tmp_path):
    data = REFUSED[kind]
    with pytest.raises(native.UnportedFormat, match="A2c"):
        native.decode_image(data)
    with pytest.raises(ValueError, match="A2c"):
        serving.decode_request_image(data, "application/octet-stream", 32)
    path = tmp_path / "x.img"
    path.write_bytes(data)
    with pytest.raises(native.UnportedFormat, match="A2c"):
        datasets.load_image(str(path), 32)
    with pytest.raises(native.UnportedFormat, match="A2c"):
        build_image_cache([str(path)], 32, str(tmp_path / "cache"), workers=1)
    # cv2, and so the JAX package, reads them (the lossless and 12-bit
    # headers patched onto an 8-bit DCT stream are no real such streams)
    if kind not in ("lossless", "12-bit"):
        assert jdatasets.load_image(str(path), 32).any()


def test_unknown_bytes_are_undecodable_not_refused():
    assert native.decode_image(b"not an image") is None
    assert native.unported_format(b"not an image") is None
    assert native.unported_format(b"P5 24 24 255\n") is None  # Netpbm decodes
    assert native.decode_image(b"P5 24 24 255\n") is None  # its data cut short
    assert native.unported_format(b"Pf 24 24 -1\n") == "PFM"


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """No compiler, or one that fails: the first decode raises; load_image
    lets it through instead of giving the zero image."""
    path = _files(tmp_path, (40, 40))[0]
    monkeypatch.setattr(decoder, "_lib", None)
    monkeypatch.setattr(decoder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the image decoder failed"):
        decoder.decode(b"\xff\xd8\xff")
    with pytest.raises(RuntimeError, match="building the image decoder failed"):
        datasets.load_image(path, 32)
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
        datasets.load_image(path, 32)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_is_named_by_its_source_and_flags():
    lib = decoder.library()
    name = os.path.basename(decoder.build_info["path"])
    assert name.startswith("libcxr_decode-") and name.endswith(".so")
    assert os.path.dirname(decoder.build_info["path"]) == str(decoder.BUILD_DIR)
    assert lib is decoder.library()
