"""TIFF and Netpbm decoding (ROADMAP A2c, second part): the port's decoder
(``native/src/tiff.cpp``, ``native/src/pnm.cpp``) against cv2 byte for
byte, as a buffer (``cv2.imdecode``) and as a file (``cv2.imread``), and
the paths that use it against the JAX package's.

- TIFF from cv2, PIL and ``testing/tiff.py`` (what neither writes: tiles,
  PlanarConfiguration 2, BigTIFF, big-endian, the old LZW bit order,
  Predictor 2, FillOrder 2, Orientation, a second page): none, PackBits,
  LZW, Deflate and JPEG (YCbCr, RGB and grey, JPEGTables); 1-, 8- and
  16-bit grey and MinIsWhite, palettes, RGB and RGBA (associated and
  unassociated alpha), grey with alpha; tolerance 0.
- What libtiff and OpenCV do that a plain reading of the format would not,
  each pinned against cv2 itself so that a repaired reference shows up.
- Netpbm P1-P6 at maxvals 1-65535, ASCII and binary, comments; P7 of each
  TUPLTYPE; the alpha PAMs, whose reference output is partly unwritten
  memory, pinned where it is defined.
- Files cut short; what cv2 gives no image for; what stays refused, on
  every path; ``decode_request_image``, ``load_image``,
  ``build_image_cache``, ``batch_load_resize_u8`` and ``cache-images``
  against the JAX package.
"""

import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from clip_for_dl_tpu import serving as jserving
from clip_for_dl_tpu.data import cache as jcache
from clip_for_dl_tpu.data import datasets as jdatasets
from clip_for_dl_tpu_torch import serving
from clip_for_dl_tpu_torch.data import build_image_cache, datasets
from clip_for_dl_tpu_torch.native import bindings as native
from clip_for_dl_tpu_torch.native import decoder
from clip_for_dl_tpu_torch.testing.tiff import build_tiff, encode_tiff

MIN_IS_WHITE, MIN_IS_BLACK, RGB, PALETTE = 0, 1, 2, 3
NONE, LZW, DEFLATE, OLD_DEFLATE, PACKBITS = 1, 5, 8, 32946, 32773


def _image(h, w, c, seed, top=255):
    """Noise blurred into something an encoder keeps detail of, 0..top."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, c) if c > 1 else (h, w)).astype(np.float32)
    if h > 8 and w > 8:
        img = cv2.GaussianBlur(img, (5, 5), 1.5)
    return np.round(img * top).astype(np.uint16 if top > 255 else np.uint8)


def _cv2_rgb(data: bytes, file_dir=None):
    """cv2's decode in RGB: imdecode of a buffer, or imread of the bytes
    written to a file under ``file_dir`` (its errors are no image)."""
    try:
        if file_dir is None:
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        else:
            path = os.path.join(file_dir, "image.img")
            with open(path, "wb") as f:
                f.write(data)
            img = cv2.imread(path)
    except cv2.error:
        img = None
    return None if img is None else img[..., ::-1]


def _same(data: bytes, file_dir):
    """The port's decode held against cv2's, as a buffer and as a file;
    returns the buffer's."""
    out = None
    for where in (None, file_dir):
        got = decoder.decode(data, file=where is not None)
        want = _cv2_rgb(data, where)
        assert (got is None) == (want is None), (where, got is None, want is None)
        if want is not None:
            assert got.dtype == np.uint8 and got.flags.c_contiguous
            np.testing.assert_array_equal(got, want)
        out = got if where is None else out
    return out


def _pil(img, fmt, **kw):
    out = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(out, fmt, **kw)
    return out.getvalue()


# -- TIFF: the matrix -----------------------------------------------------------------

# samples of each kind: (photometric, bits, samples, ExtraSamples, planar)
KINDS = {
    "grey1": (MIN_IS_BLACK, 1, 1, None, 1), "white1": (MIN_IS_WHITE, 1, 1, None, 1),
    "grey8": (MIN_IS_BLACK, 8, 1, None, 1), "white8": (MIN_IS_WHITE, 8, 1, None, 1),
    "grey16": (MIN_IS_BLACK, 16, 1, None, 1), "white16": (MIN_IS_WHITE, 16, 1, None, 1),
    "grey-alpha8": (MIN_IS_BLACK, 8, 2, (2,), 1), "grey-alpha16": (MIN_IS_BLACK, 16, 2, (1,), 1),
    "grey-alpha8-planar": (MIN_IS_BLACK, 8, 2, (2,), 2),
    "white16-alpha-planar": (MIN_IS_WHITE, 16, 2, (2,), 2),
    "palette1": (PALETTE, 1, 1, None, 1), "palette4": (PALETTE, 4, 1, None, 1),
    "palette8": (PALETTE, 8, 1, None, 1),
    "rgb8": (RGB, 8, 3, None, 1), "rgb16": (RGB, 16, 3, None, 1),
    "rgba8-unassociated": (RGB, 8, 4, (2,), 1), "rgba8-associated": (RGB, 8, 4, (1,), 1),
    "rgba8-untagged": (RGB, 8, 4, None, 1), "rgba16-unassociated": (RGB, 16, 4, (2,), 1),
    "rgb8-planar": (RGB, 8, 3, None, 2), "rgba16-planar": (RGB, 16, 4, (2,), 2),
}
CODECS = {"none": (NONE, False), "packbits": (PACKBITS, False), "lzw": (LZW, False),
          "lzw-old": (LZW, True), "deflate": (DEFLATE, False), "adobe-deflate": (OLD_DEFLATE, False)}


def _samples(kind, h, w, seed):
    photometric, bits, spp, _, _ = KINDS[kind]
    rng = np.random.default_rng(seed)
    if bits < 8 or photometric == PALETTE:
        return rng.integers(0, 1 << bits, (h, w, spp))
    smooth = _image(h, w, spp, seed, (1 << bits) - 1)
    return smooth.reshape(h, w, spp)


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_written_tiffs_decode_equal(kind, codec, layout, tmp_path):
    """Each kind of samples under each codec in strips (of 7 rows) and tiles
    (clipped at the right and the bottom), the byte order, BigTIFF and
    Predictor 2 varying with the case."""
    photometric, bits, spp, extra, planar = KINDS[kind]
    compression, old = CODECS[codec]
    n = list(KINDS).index(kind) + list(CODECS).index(codec)
    px = _samples(kind, 23, 37, n)
    colormap = (np.random.default_rng(n).integers(0, 65536, (1 << bits, 3))
                if photometric == PALETTE else None)
    data = encode_tiff(px, bps=bits, photometric=photometric, compression=compression,
                       old_lzw=old, planar=planar, extra=extra, colormap=colormap,
                       predictor=2 if bits >= 8 and compression in (LZW, DEFLATE) and n % 2 else 1,
                       order=">" if n % 3 == 0 else "<", big=n % 4 == 1,
                       **({"tile": (16, 32)} if layout == "tiles" else {"rows_per_strip": 7}))
    _same(data, str(tmp_path))  # a buffer refuses uncompressed tiles of this size
    assert decoder.decode(data, file=True).shape == (23, 37, 3)


@pytest.mark.parametrize("shape", [(24, 40), (32, 32)], ids=["wide", "square"])
@pytest.mark.parametrize("layout", ["strips", "tiles", "tiles-grey16"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_is_applied_as_cv2_applies_it(orientation, layout, shape, tmp_path):
    """Turned as cv::ExifTransform turns an image; a horizontal flip turns
    each tile in place (libtiff); a file turned by 90 degrees is no image
    unless square (cv2.imread sizes its output as the file's frame)."""
    h, w = shape
    px = _image(h, w, 1 if layout.endswith("grey16") else 3, orientation,
                65535 if layout.endswith("grey16") else 255)
    data = encode_tiff(px, bps=16 if layout.endswith("grey16") else 8, compression=LZW,
                       orientation=orientation,
                       **({"tile": (16, 16)} if layout.startswith("tiles") else {"rows_per_strip": 5}))
    got = _same(data, str(tmp_path))
    assert got.shape == ((w, h, 3) if orientation >= 5 else (h, w, 3))
    assert (decoder.decode(data, file=True) is None) == (orientation >= 5 and h != w)


PIL_MODES = ("L", "LA", "RGB", "RGBA", "P", "1", "I;16", "I;16B")


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                         "packbits"])
@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_written_tiffs_decode_equal(mode, compression, tmp_path):
    base = _image(31, 45, 3, PIL_MODES.index(mode))
    if mode.startswith("I;16"):
        im = Image.fromarray(_image(31, 45, 1, 3, 65535)).convert(mode)
    elif mode == "RGBA":
        im = Image.fromarray(np.dstack([base, _image(31, 45, 1, 9)]), "RGBA")
    else:
        im = Image.fromarray(base).convert(mode)
    assert _same(_pil(im, "TIFF", compression=compression), str(tmp_path)) is not None


@pytest.mark.parametrize("params", [[], [cv2.IMWRITE_TIFF_COMPRESSION, 1],
                                    [cv2.IMWRITE_TIFF_COMPRESSION, 8],
                                    [cv2.IMWRITE_TIFF_COMPRESSION, 32773]],
                         ids=["default", "none", "deflate", "packbits"])
@pytest.mark.parametrize("kind", ["grey8", "rgb8", "bgra8", "grey16", "rgb16", "bgra16"])
def test_cv2_written_tiffs_decode_equal(kind, params, tmp_path):
    c = {"grey": 1, "rgb": 3, "bgra": 4}[kind[:-1].rstrip("816")]
    img = _image(30, 50, c, len(kind), 65535 if kind.endswith("16") else 255)
    ok, buf = cv2.imencode(".tiff", img, params)
    assert ok
    assert _same(buf.tobytes(), str(tmp_path)) is not None


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", [LZW, DEFLATE, OLD_DEFLATE])
def test_16_bit_radiograph_tiffs_keep_the_high_byte(compression, predictor, order, tmp_path):
    """The usual export of a digital radiograph: 16-bit grey, LZW or
    Deflate, strips; cv2 keeps each sample's high byte (put16bitbwtile)."""
    px = _image(300, 260, 1, compression + predictor, 65535)
    data = encode_tiff(px, bps=16, compression=compression, predictor=predictor, order=order,
                       rows_per_strip=17)
    got = _same(data, str(tmp_path))
    np.testing.assert_array_equal(got, np.repeat((px >> 8).astype(np.uint8)[..., None], 3, 2))


def test_a_second_page_and_fill_order_2_decode_as_cv2(tmp_path):
    """cv2 reads the first page; FillOrder 2 reverses the bits of every
    byte before any codec (so LZW of FillOrder 1 bytes breaks, as there)."""
    px = _image(20, 30, 1, 4)
    np.testing.assert_array_equal(_same(encode_tiff(px, pages=2), str(tmp_path))[..., 0], px)
    for compression in (NONE, LZW, DEFLATE, PACKBITS):
        _same(encode_tiff(px, compression=compression, fill_order=2), str(tmp_path))
        _same(encode_tiff(px > 100, bps=1, compression=compression, fill_order=2), str(tmp_path))


# -- TIFF: JPEG ---------------------------------------------------------------------------


def _jpeg_parts(jpeg: bytes):
    """(the tables: SOI, DQT and DHT, EOI; the rest: SOI, SOF, SOS, data)."""
    segs, pos = [], 2
    while True:
        marker, length = jpeg[pos + 1], struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        segs.append((marker, jpeg[pos:pos + 2 + length]))
        pos += 2 + length
        if marker == 0xDA:
            break
    tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    rest = b"\xff\xd8" + b"".join(s for m, s in segs if m not in (0xDB, 0xC4, 0xE0)) + jpeg[pos:]
    return tables, rest


SAMPLING = {"420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, (2, 2)),
            "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (2, 1)),
            "444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, (1, 1))}


def _jpeg_tiff(img, sampling="420", tile=None, rows=None, tables=True, photometric=6,
               subsampling_tag=True):
    """A JPEG-compressed TIFF of cv2's JPEG streams, one a strip or tile."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    if tile:
        regions = []
        for y in range(0, h, tile[0]):
            for x in range(0, w, tile[1]):
                t = np.zeros(tile + img.shape[2:], np.uint8)
                part = img[y:y + tile[0], x:x + tile[1]]
                t[:part.shape[0], :part.shape[1]] = part
                regions.append(t)
    else:
        regions = [img[y:y + (rows or h)] for y in range(0, h, rows or h)]
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if spp == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling][0]]
    blocks, fields = [], {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]),
                          262: (3, [photometric if spp == 3 else 1]), 277: (3, [spp]),
                          284: (3, [1])}
    for region in regions:
        stream = cv2.imencode(".jpg", np.ascontiguousarray(region[..., ::-1]) if spp == 3
                              else region, params)[1].tobytes()
        if tables:
            table, stream = _jpeg_parts(stream)
            fields[347] = (7, list(table))
        blocks.append(stream)
    fields.update({322: (4, [tile[1]]), 323: (4, [tile[0]])} if tile else {278: (4, [rows or h])})
    if spp == 3 and photometric == 6 and subsampling_tag:
        fields[530] = (3, list(SAMPLING[sampling][1]))
    return build_tiff(fields, blocks, tile is not None)


@pytest.mark.parametrize("form", ["one-strip", "strips", "tiles", "no-tables",
                                  "no-subsampling-tag", "tiles-larger-than-the-image"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_ycbcr_jpeg_tiffs_decode_equal(sampling, form, tmp_path):
    """YCbCr under JPEG, converted by libjpeg as libtiff asks it to
    (JPEGCOLORMODE_RGB); a missing YCbCrSubsampling tag taken from the first
    strip's JPEG (JPEGFixupTags)."""
    shape = (16, 16) if form == "tiles-larger-than-the-image" else (37, 53)
    img = _image(*shape, 3, len(form))
    kw = {"one-strip": {}, "strips": {"rows": 16}, "tiles": {"tile": (16, 32)},
          "no-tables": {"tables": False}, "no-subsampling-tag": {"subsampling_tag": False},
          "tiles-larger-than-the-image": {"tile": (32, 32)}}[form]
    got = _same(_jpeg_tiff(img, sampling, **kw), str(tmp_path))
    assert got.shape == shape + (3,)


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("size", [(1, 1), (17, 33), (300, 260)])
def test_pil_jpeg_tiffs_decode_equal(mode, size, tmp_path):
    """PIL writes Photometric RGB (or grey) under JPEG: the components are
    taken as they are, no colour conversion."""
    img = _image(*size, 3 if mode == "RGB" else 1, size[0])
    _same(_pil(img, "TIFF", compression="jpeg", quality=85), str(tmp_path))
    _same(_pil(img, "TIFF", compression="jpeg", quality=85, tiffinfo={278: 16}), str(tmp_path))


def test_a_jpeg_tiff_in_separate_planes_decodes_equal(tmp_path):
    """Photometric RGB in PlanarConfiguration 2: a grey JPEG a plane."""
    img = _image(37, 53, 3, 5)
    planes = [cv2.imencode(".jpg", np.ascontiguousarray(img[..., k]))[1].tobytes()
              for k in range(3)]
    fields = {256: (4, [53]), 257: (4, [37]), 258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]),
              277: (3, [3]), 278: (4, [37]), 284: (3, [2])}
    assert _same(build_tiff(fields, planes), str(tmp_path)).shape == (37, 53, 3)


def test_a_jpeg_tiff_of_the_wrong_sampling_is_no_image(tmp_path):
    """Photometric RGB wants 1 x 1 sampling (JPEGPreDecode)."""
    assert _same(_jpeg_tiff(_image(20, 20, 3, 1), "420", photometric=2), str(tmp_path)) is None


# -- TIFF: what libtiff and OpenCV do, pinned against cv2 ----------------------------------


def test_16_bit_grey_keeps_its_high_byte_16_bit_rgb_rounds(tmp_path):
    v = np.array([[0, 255, 256, 41743, 65535, 32767]], np.uint16)
    grey = _same(encode_tiff(v, bps=16), str(tmp_path))[..., 0]
    rgb = _same(encode_tiff(np.dstack([v, v, v]), bps=16), str(tmp_path))[..., 0]
    assert grey.tolist() == [[0, 0, 1, 163, 255, 127]]  # v >> 8
    assert rgb.tolist() == [[0, 1, 1, 162, 255, 127]]  # (v + 128) // 257


def test_unassociated_alpha_is_premultiplied(tmp_path):
    px = np.array([[[217, 163, 130, 69]]], np.uint8)
    got = _same(_pil(Image.fromarray(px, "RGBA"), "TIFF"), str(tmp_path))
    assert got.tolist() == [[[59, 44, 35]]]  # (v * a + 127) // 255
    assert _same(encode_tiff(px, extra=(1,)), str(tmp_path)).tolist() == [[[217, 163, 130]]]


def test_clipped_grey_tiles_skip_too_few_bytes_a_row(tmp_path):
    """put16bitbwtile and putgreytile step over (tile width - clip) bytes
    after a row of a clipped tile, not as many pixels: the right column of
    tiles reads shifted rows."""
    for bits, spp in ((16, 1), (8, 2), (16, 2)):
        px = _image(20, 40, spp, bits + spp, (1 << bits) - 1).reshape(20, 40, spp)
        got = _same(encode_tiff(px, bps=bits, tile=(16, 32), compression=LZW,
                                extra=(0,) if spp == 2 else None), str(tmp_path))
        straight = px[..., 0] >> (bits - 8)
        np.testing.assert_array_equal(got[:, :32, 0], straight[:, :32])
        assert (got[1:16, 32:, 0] != straight[1:16, 32:]).any()


def test_a_horizontal_flip_turns_each_tile_in_place(tmp_path):
    px = _image(16, 64, 1, 2)
    got = _same(encode_tiff(px, tile=(16, 32), orientation=2, compression=LZW),
                str(tmp_path))[..., 0]
    np.testing.assert_array_equal(got, np.hstack([px[:, 31::-1], px[:, :31:-1]]))


def test_an_uncompressed_tile_of_a_buffer_wants_its_size_in_kilobytes(tmp_path):
    """cv2.imdecode gives no image for an uncompressed tile whose byte count
    rounded up to 1024 is not its size; cv2.imread reads it."""
    for tile, decodes in (((16, 16), False), ((32, 32), True), ((16, 48), False)):
        data = encode_tiff(_image(40, 50, 1, 5), tile=tile)
        _same(data, str(tmp_path))
        assert (decoder.decode(data) is not None) == decodes
        assert decoder.decode(data, file=True) is not None


def test_a_palette_without_its_colormap_reads_as_grey_or_rgb(tmp_path):
    """TIFFReadDirectory: a palette image of 8 bits or more whose colormap
    is missing (or of the wrong length) is grey, or RGB with 3 samples;
    samples past the colour ones become extra samples first (so 3 of them
    leave one colour: no image)."""
    px = _image(9, 11, 4, 7)
    for spp in (1, 2, 3, 4):
        got = _same(encode_tiff(px[..., :spp], photometric=PALETTE), str(tmp_path))
        if spp == 3:
            assert got is None
        else:
            np.testing.assert_array_equal(got[..., 0], px[..., 0])


def test_separate_planes_of_grey_are_not_inverted(tmp_path):
    """putRGBseparate*: MinIsWhite in separate planes comes out as stored,
    16-bit samples rounded."""
    px = _image(9, 11, 2, 1, 65535)
    got = _same(encode_tiff(px, bps=16, photometric=MIN_IS_WHITE, planar=2), str(tmp_path))
    np.testing.assert_array_equal(got[..., 0], ((px[..., 0].astype(np.int64) + 128) // 257))


# -- TIFF: cut short, no image, refused ----------------------------------------------------

CUT_BASES = {
    "pil-none": lambda: _pil(_image(60, 70, 1, 1), "TIFF", tiffinfo={278: 10}),
    "pil-lzw": lambda: _pil(_image(60, 70, 3, 2), "TIFF", compression="tiff_lzw"),
    "lzw-16": lambda: encode_tiff(_image(60, 70, 1, 3, 65535), bps=16, compression=LZW,
                                  rows_per_strip=9),
    "deflate-tiles": lambda: encode_tiff(_image(60, 70, 1, 4), compression=DEFLATE, tile=(16, 32)),
    "jpeg": lambda: _pil(_image(60, 70, 3, 5), "TIFF", compression="jpeg"),
}


@pytest.mark.parametrize("at", [0.1, 0.3, 0.5, 0.7, 0.9, 0.99])
@pytest.mark.parametrize("base", list(CUT_BASES))
def test_tiffs_cut_short_decode_as_cv2(base, at, tmp_path):
    data = CUT_BASES[base]()
    _same(data[:int(len(data) * at)], str(tmp_path))
    _same(data[:-1], str(tmp_path))


NO_IMAGE = {
    "32-bit": lambda: encode_tiff(_image(9, 11, 1, 1).astype(np.uint32) << 20, bps=32),
    "float": lambda: encode_tiff(_image(9, 11, 1, 1).astype(np.uint32), bps=32, sample_format=3),
    "2-bit": lambda: encode_tiff(_image(9, 11, 1, 1) >> 6, bps=2),
    "12-bit": lambda: encode_tiff(_image(9, 11, 1, 1), bps=12),
    "16-bit-palette": lambda: encode_tiff(_image(9, 11, 1, 1), bps=16, photometric=PALETTE,
                                          colormap=np.zeros((1 << 16, 3), np.uint16)),
    "old-style-jpeg": lambda: encode_tiff(_image(9, 11, 3, 1), photometric=6,
                                          tags={259: (3, [6])}),
    "lzma": lambda: encode_tiff(_image(9, 11, 1, 1), tags={259: (3, [34925])}),
    "no-photometric": lambda: build_tiff({256: (4, [4]), 257: (4, [4]), 258: (3, [8]),
                                          277: (3, [1]), 278: (4, [4])}, [bytes(16)]),
    "predictor-3": lambda: encode_tiff(_image(9, 11, 1, 1), compression=LZW,
                                       tags={317: (3, [3])}),
}


@pytest.mark.parametrize("case", list(NO_IMAGE))
def test_where_cv2_gives_no_image_the_port_gives_none(case, tmp_path):
    """load_image gives the zero image, as the JAX package's does, and the
    server a 400 that is not A2c's."""
    data = NO_IMAGE[case]()
    assert _same(data, str(tmp_path)) is None
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    np.testing.assert_array_equal(datasets.load_image(str(path), 32),
                                  jdatasets.load_image(str(path), 32))
    assert not datasets.load_image(str(path), 32).any()
    with pytest.raises(ValueError, match="could not decode"):
        serving.decode_request_image(data, "image/tiff", 32)


def test_a_compression_libtiff_has_no_codec_for_decodes_to_zeros(tmp_path):
    """libtiff's "strip decoding is not implemented" fails each strip after
    its buffer is zeroed, and OpenCV keeps the buffer."""
    data = encode_tiff(_image(9, 11, 1, 1), tags={259: (3, [99])})
    got = _same(data, str(tmp_path))
    assert got.shape == (9, 11, 3) and not got.any()


REFUSED = {
    "group3": lambda: _pil(Image.fromarray(_image(24, 24, 1, 1)).convert("1"), "TIFF",
                           compression="group3"),
    "group4": lambda: _pil(Image.fromarray(_image(24, 24, 1, 1)).convert("1"), "TIFF",
                           compression="group4"),
    "cmyk": lambda: _pil(Image.fromarray(_image(24, 24, 3, 2)).convert("CMYK"), "TIFF"),
    "cmyk-jpeg": lambda: _pil(Image.fromarray(_image(24, 24, 3, 2)).convert("CMYK"), "TIFF",
                              compression="jpeg"),
    "cielab": lambda: _pil(Image.fromarray(_image(24, 24, 3, 3)).convert("LAB"), "TIFF"),
    "ycbcr": lambda: _pil(Image.fromarray(_image(24, 24, 3, 4)).convert("YCbCr"), "TIFF",
                          compression="tiff_lzw"),
    "next": lambda: encode_tiff(_image(24, 24, 1, 5), tags={259: (3, [32766])}),
    "thunderscan": lambda: encode_tiff(_image(24, 24, 1, 5) >> 4, bps=4,
                                       tags={259: (3, [32809])}),
    "logluv": lambda: encode_tiff(_image(24, 24, 3, 5), photometric=32845),
}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_tiff_variants_raise_naming_a2c_on_every_path(kind, tmp_path):
    data = REFUSED[kind]()
    with pytest.raises(native.UnportedFormat, match="A2c"):
        native.decode_image(data)
    with pytest.raises(ValueError, match="A2c"):
        serving.decode_request_image(data, "image/tiff", 32)
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    with pytest.raises(native.UnportedFormat, match="A2c"):
        datasets.load_image(str(path), 32)
    with pytest.raises(native.UnportedFormat, match="A2c"):
        build_image_cache([str(path)], 32, str(tmp_path / "cache"), workers=1)
    if kind in ("group3", "group4", "cmyk", "cmyk-jpeg", "cielab", "ycbcr"):
        assert jdatasets.load_image(str(path), 32).any()  # cv2 reads it


def test_pfm_stays_refused():
    data = b"Pf\n4 2\n-1.0\n" + np.ones(8, "<f4").tobytes()
    assert native.unported_format(data) == "PFM"
    with pytest.raises(native.UnportedFormat, match="PFM.*A2c"):
        native.decode_image(data)


# -- Netpbm -------------------------------------------------------------------------------


def _pnm(kind, vals, maxval, comment=False):
    """P1-P6 bytes of ``vals`` ([h, w] or [h, w, 3] values)."""
    h, w = vals.shape[:2]
    head = f"P{kind}\n".encode() + (b"# written by the test\n" if comment else b"")
    head += f"{w} {h}\n".encode() + (b"" if kind in (1, 4) else f"{maxval}\n".encode())
    if kind in (1, 2, 3):
        return head + b"\n".join(b" ".join(b"%d" % v for v in row.reshape(-1)) for row in vals) + b"\n"
    if kind == 4:
        return head + np.packbits(vals.astype(np.uint8), axis=1).tobytes()
    return head + vals.astype(">u2" if maxval > 255 else np.uint8).tobytes()


@pytest.mark.parametrize("over", [False, True], ids=["within", "over-maxval"])
@pytest.mark.parametrize("kind,maxval", [(k, m) for k in range(1, 7) for m in (
    (1,) if k in (1, 4) else (1, 15, 100, 255, 256, 1000, 65535))])
def test_netpbm_decodes_equal(kind, maxval, over, tmp_path):
    """ASCII samples over maxval clamp to it; binary 8-bit ones stay as
    they are."""
    rng = np.random.default_rng(kind * 100 + maxval)
    top = 1 if kind in (1, 4) else min(maxval + 40 * over, 255 if kind in (5, 6) and maxval < 256
                                       else 65535)
    vals = rng.integers(0, top + 1, (5, 13, 3) if kind in (3, 6) else (5, 13))
    got = _same(_pnm(kind, vals, maxval, comment=over), str(tmp_path))
    assert got.shape == (5, 13, 3)


def test_netpbm_scaling_rules_as_cv2_has_them(tmp_path):
    """Binary 16-bit samples keep their high byte unscaled (maxval 1000:
    500 -> 1, 1000 -> 3); binary 8-bit ones are not scaled (maxval 100:
    50 -> 50); ASCII 8-bit ones are (P2, maxval 15: 5 -> 85)."""
    cases = [(_pnm(5, np.array([[500, 1000]]), 1000), [1, 3]),
             (_pnm(5, np.array([[50, 100]]), 100), [50, 100]),
             (_pnm(2, np.array([[5, 15]]), 15), [85, 255]),
             (_pnm(2, np.array([[500, 1000]]), 1000), [1, 3]),
             (_pnm(1, np.array([[0, 1]]), 1), [255, 0]), (_pnm(4, np.array([[0, 1]]), 1), [255, 0])]
    for data, want in cases:
        assert _same(data, str(tmp_path))[0, :, 0].tolist() == want


@pytest.mark.parametrize("data", [
    b"P1\n3 2\n010\n101\n", b"P1\n3 2\n0 2 9 1 0 0\n", b"P2\n2 1\n255\n10 20",
    b"P2\n2 1\n255\n10 20 ", b"P5\n4 4\n255\n" + bytes(15), b"P5\n4 4\n255\n" + bytes(range(20)),
    b"P5\n4 4\n0\n" + bytes(16), b"P5\n4 4 #c\n255\n" + bytes(range(16)),
    b"P5\r4\r4\r255\r" + bytes(range(16)), b"P6\t2\t1\t255\t" + bytes(range(6)),
    b"P5\n100000 100000\n255\n" + bytes(16), b"P3\n1 1\n255\n1 x 3\n", b"P5\n4 4\n70000\n",
], ids=["p1-packed", "p1-digits", "p2-no-end", "p2-end", "p5-short", "p5-long", "p5-maxval-0",
        "p5-comment", "p5-cr", "p6-tabs", "p5-huge", "p3-garbage", "p5-maxval-70000"])
def test_netpbm_edges_decode_as_cv2(data, tmp_path):
    _same(data, str(tmp_path))


def _pam(w, h, depth, maxval, tupltype, vals):
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
    head += f"TUPLTYPE {tupltype}\n" if tupltype else ""
    return (head + "ENDHDR\n").encode() + vals.astype(">u2" if maxval > 255 else np.uint8).tobytes()


@pytest.mark.parametrize("maxval", [1, 255, 1000])
@pytest.mark.parametrize("tupltype,depth", [("BLACKANDWHITE", 1), ("GRAYSCALE", 1), ("RGB", 3),
                                            (None, 1), (None, 3), ("GRAYSCALE", 3),
                                            ("RGB_ALPHA", 3)])
def test_pam_decodes_equal(tupltype, depth, maxval, tmp_path):
    """As OpenCV reads them: a maxval of 1 reads each row's bytes as packed
    bits; RGB comes out with its channels reversed; a DEPTH that is not its
    TUPLTYPE's is no image (copied: ROADMAP, "Reference behaviour copied")."""
    vals = np.random.default_rng(depth * maxval).integers(0, maxval + 1, (3, 20, depth))
    _same(_pam(20, 3, depth, maxval, tupltype, vals), str(tmp_path))


def test_pam_rgb_comes_out_reversed_and_black_and_white_as_bits(tmp_path):
    rgb = np.array([[[10, 20, 30]]])
    assert _same(_pam(1, 1, 3, 255, "RGB", rgb), str(tmp_path)).tolist() == [[[30, 20, 10]]]
    bits = np.zeros((1, 16, 1), np.uint8)
    bits[0, 1] = 1  # the byte of pixels 8-15 is 1: its last bit
    got = _same(_pam(16, 1, 1, 1, "BLACKANDWHITE", bits), str(tmp_path))[0, :, 0]
    assert got.tolist() == [0] * 15 + [255]


@pytest.mark.parametrize("maxval", [255, 1000])
@pytest.mark.parametrize("tupltype,depth", [("GRAYSCALE_ALPHA", 2), ("RGB_ALPHA", 4)])
def test_alpha_pams_are_converted_whole_not_as_cv2_leaves_them(tupltype, depth, maxval,
                                                               tmp_path):
    """Not copied (ROADMAP): OpenCV converts the first ceil(width / DEPTH)
    pixels of each row and leaves the rest of its output unwritten. The
    JAX package's output (load_image of the file, cv2.imread) is held where
    it is defined; the rest of it is whatever memory held, here a picture of
    90s cv2 decoded just before, which the port's pixels never all equal."""
    w, h = 11, 3
    vals = np.random.default_rng(depth).integers(1, maxval + 1, (h, w, depth))
    path = tmp_path / "alpha.pam"
    path.write_bytes(_pam(w, h, depth, maxval, tupltype, vals))
    got = native.decode_image(path.read_bytes())
    v8 = (vals >> 8 if maxval > 255 else vals).astype(np.uint8)
    np.testing.assert_array_equal(got, v8[..., :3] if depth == 4 else np.repeat(v8[..., :1], 3, 2))
    jaxs = []
    for _ in range(3):
        grey = cv2.imdecode(cv2.imencode(".bmp", np.full((h, w, 3), 90, np.uint8))[1],
                            cv2.IMREAD_COLOR)
        del grey
        jaxs.append(jdatasets.load_image(str(path)))
    n = -(-w // depth)
    for jax in jaxs:
        np.testing.assert_array_equal(jax[:, :n], got[:, :n])
    assert any(not np.array_equal(jax, got) for jax in jaxs)


# -- the paths, JAX against the port -------------------------------------------------------


def _bodies():
    """Bodies of each new format as cv2 and PIL write them (grey 16-bit LZW
    TIFF with Predictor 2 as a radiograph's export)."""
    grey16 = _image(300, 260, 1, 1, 65535)
    rgb = _image(100, 90, 3, 2)
    return {"tiff-lzw-16": encode_tiff(grey16, bps=16, compression=LZW, predictor=2,
                                       rows_per_strip=32),
            "tiff-deflate-rgb": cv2.imencode(".tiff", rgb, [cv2.IMWRITE_TIFF_COMPRESSION, 8])[1],
            "tiff-jpeg": _pil(rgb, "TIFF", compression="jpeg"),
            "pgm-16": cv2.imencode(".pgm", grey16)[1], "ppm": cv2.imencode(".ppm", rgb)[1],
            "pbm": cv2.imencode(".pbm", rgb[..., 0])[1], "pam": cv2.imencode(".pam", rgb)[1]}


BODIES = {k: bytes(v) for k, v in _bodies().items()}


@pytest.mark.parametrize("size", [32, 224])
@pytest.mark.parametrize("kind", list(BODIES))
def test_decode_request_image_is_byte_equal_to_jax(kind, size):
    np.testing.assert_array_equal(serving.decode_request_image(BODIES[kind], "image/tiff", size),
                                  jserving.decode_request_image(BODIES[kind], "image/tiff", size))


def _held(got, want, upscaling):
    """Byte for byte at downscaling, within 1 at upscaling (the cv2.resize
    split)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    if upscaling:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)


def _files(tmp_path):
    paths = []
    for kind, data in BODIES.items():
        paths.append(str(tmp_path / f"{kind}.img"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


@pytest.mark.parametrize("size", [None, 64, 224])
def test_load_image_matches_jax(tmp_path, size):
    for path in _files(tmp_path):
        got = datasets.load_image(path, size)
        assert got.any()
        upscaling = size is not None and size > min(jdatasets.load_image(path).shape[:2])
        _held(got, jdatasets.load_image(path, size), upscaling)


def test_build_image_cache_and_the_batch_loader_match_jax(tmp_path):
    """build_image_cache (and so cache-images) and the HostLoader's live
    reads (batch_load_resize_u8) at downscaling."""
    paths = _files(tmp_path)
    (tmp_path / "text.img").write_bytes(b"P5 not an image")
    paths.append(str(tmp_path / "text.img"))
    got = build_image_cache(paths, 64, str(tmp_path / "port"), workers=2)
    want = jcache.build_image_cache(paths, 64, str(tmp_path / "jax"), workers=2)
    assert got.channels == want.channels
    for p in paths:
        np.testing.assert_array_equal(got.get(p), want.get(p))
    assert not got.get(paths[-1]).any()
    batch, ok = native.batch_load_resize_u8(paths, 64, 64, threads=2)
    assert ok[:-1].all() and not ok[-1]
    for path, row in zip(paths, batch):
        np.testing.assert_array_equal(row, jdatasets.load_image(path, 64))


def test_cache_images_over_tiff_and_pgm_files_matches_jax(tmp_path, monkeypatch):
    """The CLI over the projections' 16-bit TIFFs and PGMs (it walks a
    directory for PNG and JPEG only): the cache equals the JAX CLI's."""
    import importlib

    jcli = importlib.import_module("clip_for_dl_tpu.cli.main")
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    d = tmp_path / "images"
    d.mkdir()
    names = []
    for i in range(2):
        img = _image(120, 100, 1, i, 65535)
        names += [f"{i}_IM-0001-1001.dcm.tif", f"{i}_IM-0001-2001.dcm.pgm"]
        (d / names[-2]).write_bytes(encode_tiff(img, bps=16, compression=LZW, predictor=2))
        (d / names[-1]).write_bytes(cv2.imencode(".pgm", img)[1].tobytes())
    csv = tmp_path / "projections.csv"
    csv.write_text("uid,filename,projection\n" + "".join(
        f"{n[0]},{n},{'Frontal' if '-1001' in n else 'Lateral'}\n" for n in names))
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        assert main(["cache-images", "--image-dir", str(d), "--out", str(tmp_path / tag),
                     "--projections-csv", str(csv), "--image-size", "64", "--workers", "2"]) == 0
    from clip_for_dl_tpu_torch.data import ImageCache

    got, want = ImageCache(str(tmp_path / "port")), jcache.ImageCache(str(tmp_path / "jax"))
    assert len(got) == len(want) == 4 and got.channels == want.channels == 1
    for name in names:
        row = got.get(str(d / name))
        assert row.any()
        np.testing.assert_array_equal(row, want.get(str(d / name)))
