"""The port's host decoder and resize (``native/bindings.py``) against the
JAX package's native runtime (``native/src/cxr_native.cpp`` on libpng),
byte for byte, on PNGs written by cv2, PIL and the port's own writer
(``testing/png.py``: every filter type, Adam7), and ``load_image``'s
failure rules.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from clip_for_dl_tpu.data import datasets as jdatasets
from clip_for_dl_tpu.native import bindings as jnative
from clip_for_dl_tpu_torch.data import datasets
from clip_for_dl_tpu_torch.native import bindings as native
from clip_for_dl_tpu_torch.testing.png import encode_png


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    if not jnative.is_available():
        pytest.skip("the JAX package's native library does not build here")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _smooth(shape, seed=0):
    """A gradient with noise, so that cv2/libpng picks every filter type."""
    rng = _rng(seed)
    h, w = shape[:2]
    base = np.add.outer(np.linspace(0, 200, h), np.linspace(0, 50, w))
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 10
    return np.clip(base + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)


def _same(data: bytes):
    got, want = native.decode_png(data), jnative.decode_png(data)
    assert want is not None
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    assert native.png_info(data) == want.shape[:2]


@pytest.mark.parametrize("shape", [(64, 48), (31, 17, 3), (20, 33, 4), (1, 1), (9, 1, 3)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_cv2_written_pngs_decode_equal(shape, dtype):
    img = _smooth(shape).astype(dtype) * (257 if dtype == np.uint16 else 1)
    _same(cv2.imencode(".png", img)[1].tobytes())


@pytest.mark.parametrize("mode,bits", [("L", None), ("LA", None), ("RGB", None),
                                       ("RGBA", None), ("P", None), ("1", None), ("I;16", None),
                                       ("P", 2), ("P", 4)])
def test_pil_written_pngs_decode_equal(mode, bits):
    """PIL's modes, palettes at 2 and 4 bits among them."""
    img = Image.fromarray(_smooth((23, 29, 3)))
    kw = {}
    if bits:
        img, kw["bits"] = img.quantize(colors=2 ** bits), bits
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    _same(buf.getvalue())


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "random"])
@pytest.mark.parametrize("interlace", [False, True])
def test_every_filter_and_adam7_decode_equal(channels, filters, interlace):
    rng = _rng(channels)
    for shape, dtype in (((37, 45), np.uint8), ((13, 8), np.uint16), ((1, 7), np.uint8)):
        img = rng.integers(0, np.iinfo(dtype).max + 1, (*shape, channels), dtype=dtype)
        _same(encode_png(img, filters=filters, interlace=interlace, rng=rng))


def test_decode_failures_return_none():
    data = encode_png(_smooth((16, 16)), filters=4)
    assert native.decode_png(b"not a png at all") is None
    assert native.decode_png(data[:-40]) is None and jnative.decode_png(data[:-40]) is None
    bad_crc = bytearray(data)
    bad_crc[29] ^= 1  # inside IHDR's CRC
    assert native.decode_png(bytes(bad_crc)) is None
    assert jnative.decode_png(bytes(bad_crc)) is None


@pytest.mark.parametrize("src,dst,c", [((512, 512), (224, 224), 1), ((600, 512), (224, 224), 3),
                                       ((100, 80), (224, 224), 3), ((224, 224), (224, 224), 1),
                                       ((7, 3), (5, 9), 3), ((1, 1), (4, 4), 1),
                                       ((333, 97), (40, 40), 4)])
def test_resize_is_byte_equal(src, dst, c):
    img = _rng(c).integers(0, 256, (*src, c), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_u8(img, *dst), jnative.resize_u8(img, *dst))
    batch = [img, img[: src[0] // 2 + 1]]
    np.testing.assert_array_equal(native.batch_resize_u8(batch, *dst, threads=2),
                                  jnative.batch_resize_u8(batch, *dst, threads=2))


def test_batch_load_matches_jax(tmp_path):
    paths = []
    for i, shape in enumerate([(40, 40), (50, 30, 3), (32, 32)]):
        p = tmp_path / f"{i}.png"
        p.write_bytes(encode_png(_smooth(shape, i), filters="random", rng=_rng(i)))
        paths.append(str(p))
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\ntruncated")
    paths += [str(tmp_path / "bad.png"), str(tmp_path / "missing.png")]
    got, ok = native.batch_load_resize_u8(paths, 32, 32, threads=3)
    want, jok = jnative.batch_load_resize_u8(paths, 32, 32, threads=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, jok)
    assert ok.tolist() == [True, True, True, False, False]


def test_load_image_matches_jax_and_keeps_decode_errors_apart(tmp_path, monkeypatch):
    """A PNG decodes to JAX's bytes; a file that is missing, not a PNG or
    does not decode gives the zero image; any other failure of the decoder
    propagates (JAX's ``except Exception: pass`` would hide it)."""
    png = tmp_path / "a.png"
    png.write_bytes(encode_png(_smooth((70, 50, 3)), filters="random"))
    for size in (None, 32):
        np.testing.assert_array_equal(datasets.load_image(str(png), size),
                                      jdatasets.load_image(str(png), size))
    (tmp_path / "text.png").write_text("not an image")
    for path in (tmp_path / "text.png", tmp_path / "missing.png"):
        for size in (None, 24):
            got = datasets.load_image(str(path), size)
            assert got.shape == (size or 224, size or 224, 3) and not got.any()
            np.testing.assert_array_equal(got, jdatasets.load_image(str(path), size))

    def broken(data):
        raise RuntimeError("decoder fault")

    # the PNG decoder's entry, which load_image reaches through decode_image
    monkeypatch.setattr(native, "_parse", broken)
    with pytest.raises(RuntimeError, match="decoder fault"):
        datasets.load_image(str(png), 32)


@pytest.mark.parametrize("stack_bytes", [1, 1 << 16, 96 << 20], ids=["one", "few", "all"])
def test_stacked_decode_equals_jax_image_by_image(monkeypatch, stack_bytes):
    """Images of mixed sizes, channel counts, depths, filters and
    interlacing decoded together (padded into stacks of one, a few, or all
    per bytes-per-pixel) give each image's bytes as JAX decodes it alone."""
    monkeypatch.setattr(native, "_STACK_BYTES", stack_bytes)
    rng = _rng(9)
    datas = []
    for i, (shape, dtype) in enumerate([((30, 41), np.uint8), ((45, 12, 3), np.uint8),
                                        ((31, 40), np.uint8), ((9, 9, 4), np.uint16),
                                        ((50, 50), np.uint8), ((17, 23, 2), np.uint8),
                                        ((30, 41, 3), np.uint8), ((1, 5), np.uint16)]):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
        datas.append(encode_png(img, filters="random" if i % 3 else 4, interlace=i == 4, rng=rng))
    datas.insert(3, b"not a png")
    got = native._decode_many(datas)
    for data, img in zip(datas, got):
        want = jnative.decode_png(data)
        assert (img is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(img, want)


def test_decode_threads_times_every_stage(tmp_path, capsys):
    import json

    from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout
    from clip_for_dl_tpu_torch.tools import decode_threads

    paths = write_kaggle_layout(str(tmp_path / "kaggle"), 3, sizes=((40, 32), (48, 40)),
                                not_png_uids=(2,))
    assert decode_threads.main([paths["image_dir"], "--size", "16", "--threads", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["files"] == 6 and out["threads"] == 2
    for run in ("1_thread", "2_threads"):
        assert set(out[run]) == {"read", "inflate", "unfilter", "resize", "whole",
                                 "whole_img_per_s"}
        assert all(v > 0 for v in out[run].values())
    assert decode_threads.main([str(tmp_path / "empty")]) == 2
