"""On-device image preprocessing: bilinear resize + channel normalization
(kernel B2, ``csrc/image_prep.cu``).

Counterpart of ``clip_for_dl_tpu.ops.image_prep``. A uint8 NHWC batch is
resized with OpenCV's half-pixel bilinear convention (edge-clamped,
coordinates in float64), normalized per channel as (x/255 − mean)/std and
cast, in one pass; a float batch the same with ``input_scale`` 1, (x −
mean)/std, as the JAX kernel takes it. Grey input (C = 1) with 3-channel
statistics broadcasts to 3 channels after the resize.

:func:`preprocess_reference` is the plain PyTorch version: the resize as
two matmuls with the dense :func:`_resize_weights` matrices, the JAX
package's own formulation. :func:`preprocess_images` launches the kernel
on CUDA tensors (every batch, an identity 224→224 resize included) and runs
the plain version on CPU tensors. :func:`band_plan` mirrors how the kernel's
C entry splits the work (bands of output rows, column chunks, the grid),
so that the CPU tests can hold it.

The kernel reads uint8 or fp32 sources (bf16 and fp16 images are widened
to fp32 by a copy first) and writes fp32, bf16 or fp16 (any other floating
``out_dtype`` through fp32 and a cast). Its staged body stages source rows
in shared memory; a row pair too wide for it at one output column (about
57 KB of source values) runs the direct body, which reads device memory
straight (:func:`band_plan`'s ``direct``). A view that is not contiguous is
copied first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build

KERNEL = "cxr_image_prep"  # uint8 images, the staged body
KERNEL_F32SRC = "cxr_image_prep_f32src"  # fp32 images, the staged body
KERNEL_DIRECT = "cxr_image_prep_direct"  # either, the direct body
# output type -> the C entries' out_type code
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# source types the kernel reads (others listed in SOURCE_TYPES are widened
# to fp32 first)
SOURCE_TYPES = (torch.uint8, torch.float32, torch.bfloat16, torch.float16)


def launch_key(entry: str, out_dtype: torch.dtype) -> str:
    """The name :data:`_build.LAUNCHES` counts a launch of ``entry`` under:
    the entry's name, with ``_fp16`` appended for fp16 output, so that the
    fp16-output instance counts apart."""
    return entry + "_fp16" if out_dtype == torch.float16 else entry

# csrc/image_prep.cu's constants: threads and blocks an SM, the most output
# rows of a band, pixels a thread owns in a row, bytes of one of the two
# staging buffers, and the dynamic shared memory a block may opt into
THREADS, BLOCKS_PER_SM, MAX_BAND, PIX = 256, 3, 16, 8
MAX_COLS = PIX * THREADS
BUF_BYTES = 22528
MAX_SMEM = 232448 - 4096


class BandPlan(NamedTuple):
    rows: int  # R, output rows of a band
    cols: int  # output columns of a chunk
    stride: int  # bytes of a staged source row
    bands: int  # bands of an image
    chunks: int  # column chunks of a row
    items: int  # (image, band, chunk) items
    grid: int  # blocks, a multiple of ``chunks``
    staging: int  # bytes of a block's two staging buffers
    # the direct body: ``grid`` rows of blocks, one an (image, output row),
    # each row's output values spread over blocks of THREADS
    direct: bool = False


def row_stride(cols: int, in_w: int, out_w: int, channels: int, elsize: int = 1) -> int:
    """Bytes a staged source row needs for ``cols`` output columns: the
    source columns they name span at most ⌊(cols - 1)·in_w/out_w⌋ + 3 (+ 1
    for the float64 taps' rounding; one column names at most 2), of
    ``channels`` values of ``elsize`` bytes, the window starts up to 15
    bytes past its 16-byte-aligned start, and whole 16-byte pieces are
    copied."""
    span = min(in_w, 2 if cols == 1 else (cols - 1) * in_w // out_w + 4)
    return (15 + span * channels * elsize + 15) // 16 * 16


@functools.lru_cache(maxsize=256)
def needs_direct(in_w: int, out_w: int, channels: int, elsize: int = 1) -> bool:
    """Whether the staged body refuses these rows, so the direct body runs
    them: at R = 1 one output column's row pair, in two buffers, outgrows
    MAX_SMEM (no SM count changes that)."""
    return 4 * row_stride(1, in_w, out_w, channels, elsize) > MAX_SMEM


def band_plan(batch: int, in_w: int, channels: int, out_h: int, out_w: int,
              n_sms: int, elsize: int = 1) -> BandPlan:
    """The kernel's work split for sources of ``elsize`` bytes a value, as
    ``cxr_image_prep`` makes it (make_plan in csrc/image_prep.cu; change
    both together). R starts at MAX_BAND and halves while ``batch`` images
    of ⌈out_h/R⌉ bands would leave SMs without an item. The column chunk is
    the whole row (at most MAX_COLS columns), else the widest run of whole
    PIX-column groups, else of columns, whose 2R staged rows fit BUF_BYTES;
    if no column fits, R halves, and at R = 1 one column's row pair gets a
    buffer of its own size. Past MAX_SMEM the plan is the direct body's
    (:func:`needs_direct`): a row of blocks an (image, output row). Raises
    where the kernel refuses: at 2^30 staged items, or 2^31 direct rows."""
    if needs_direct(in_w, out_w, channels, elsize):
        if batch * out_h >= 2 ** 31:
            raise ValueError(f"{batch * out_h} (image, output row) rows of blocks reach 2^31")
        n = batch * out_h
        return BandPlan(1, out_w, 0, out_h, 1, n, n, 0, True)
    R = MAX_BAND
    while R > 1 and batch * -(-out_h // R) < n_sms:
        R //= 2

    def stride(c):
        return row_stride(c, in_w, out_w, channels, elsize)

    while True:
        cap = BUF_BYTES // (2 * R)
        cols = min(-(-out_w // PIX) * PIX, MAX_COLS)
        while cols > PIX and stride(cols) > cap:
            cols -= PIX
        while cols > 0 and stride(cols) > cap:
            cols -= 1
        if cols > 0:
            buf = 2 * R * stride(cols)
            break
        if R == 1:
            cols, buf = 1, 2 * stride(1)
            break
        R //= 2
    bands, chunks = -(-out_h // R), -(-out_w // cols)
    items = batch * bands * chunks
    if items >= 2 ** 30:
        raise ValueError(f"{items} (image, band, chunk) items reach 2^30")
    blocks = n_sms * BLOCKS_PER_SM
    grid = items if items <= blocks else max(1, blocks // chunks) * chunks
    return BandPlan(R, cols, stride(cols), bands, chunks, items, grid, 2 * buf)


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] bilinear interpolation matrix, OpenCV convention:
    src = (dst + 0.5) * in/out - 0.5, edge-clamped, float64 coordinates."""
    w = np.zeros((out_size, in_size), np.float32)
    if in_size == out_size:
        np.fill_diagonal(w, 1.0)
        return w
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    lo = np.clip(i0, 0, in_size - 1)
    hi = np.clip(i0 + 1, 0, in_size - 1)
    np.add.at(w, (dst.astype(np.int64), lo), (1.0 - frac))
    np.add.at(w, (dst.astype(np.int64), hi), frac)
    return w


@functools.lru_cache(maxsize=64)
def _resize_taps(
    in_size: int, out_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The two taps of each output index and their fp32 weights, read off
    :func:`_resize_weights` so the kernel multiplies by the very entries of
    the matrix form. Where both taps clamp onto one index, that index
    carries the summed weight and the second weight is 0."""
    w = _resize_weights(in_size, out_size)
    dst = np.arange(out_size)
    src = (dst.astype(np.float64) + 0.5) * (in_size / out_size) - 0.5
    i0 = np.floor(src).astype(np.int64)
    lo = np.clip(i0, 0, in_size - 1)
    hi = np.clip(i0 + 1, 0, in_size - 1)
    w0 = w[dst, lo]
    w1 = np.where(hi != lo, w[dst, hi], np.float32(0.0)).astype(np.float32)
    return lo.astype(np.int32), hi.astype(np.int32), w0, w1


def _norm_scale_bias(
    mean: Sequence[float], std: Sequence[float], input_scale: float
) -> Tuple[np.ndarray, np.ndarray]:
    """y = x*scale + bias  ≡  (x*input_scale - mean)/std, per channel."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (np.float32(input_scale) / std, -mean / std)


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Batched NHWC bilinear resize as two fp32 contractions."""
    _, in_h, in_w, _ = images.shape
    x = images.to(torch.float32)
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = torch.from_numpy(_resize_weights(in_h, out_h)).to(images.device)
    ww = torch.from_numpy(_resize_weights(in_w, out_w)).to(images.device)
    x = torch.einsum("Hh,bhwc->bHwc", wh, x)
    return torch.einsum("Ww,bhwc->bhWc", ww, x)


def preprocess_reference(
    images: torch.Tensor,
    out_h: int = 224,
    out_w: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version: uint8/float NHWC → resized, normalized ``out_dtype``."""
    input_scale = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
    scale, bias = _norm_scale_bias(mean, std, input_scale)
    x = resize_bilinear(images, out_h, out_w)
    # C==1 → C==3: [b,H,W,1] broadcasts against the [3] scale/bias rows
    x = x * torch.from_numpy(scale).to(x.device) + torch.from_numpy(bias).to(x.device)
    return x.to(out_dtype)


@functools.lru_cache(maxsize=32)
def _device_taps(in_size: int, out_size: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _resize_taps(in_size, out_size))


@functools.lru_cache(maxsize=32)
def _device_scale_bias(mean, std, input_scale: float, device: torch.device):
    return tuple(
        torch.from_numpy(a).to(device) for a in _norm_scale_bias(mean, std, input_scale)
    )


def preprocess_images(
    images: torch.Tensor,
    out_h: int = 224,
    out_w: int = 224,
    mean: Tuple[float, ...] = (0.0, 0.0, 0.0),
    std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 (or float) NHWC batch → resized, normalized ``out_dtype`` NHWC
    batch in one pass (``.permute(0, 3, 1, 2)`` of the result is a
    channels_last NCHW tensor for the convolutions)."""
    if images.device.type == "cpu":
        return preprocess_reference(images, out_h, out_w, mean, std, out_dtype)
    return _kernel(images, out_h, out_w, tuple(mean), tuple(std), out_dtype)


def _kernel(images, out_h, out_w, mean, std, out_dtype):
    if images.dim() != 4:
        raise ValueError(f"images must be [B, H, W, C], got {tuple(images.shape)}")
    b, in_h, in_w, c = images.shape
    c_out = len(mean) if (c == 1 and len(mean) == 3) else c
    dev = images.device
    _build.check_device(images, "images")
    if images.dtype not in SOURCE_TYPES:
        raise TypeError(f"images: expected one of {', '.join(map(str, SOURCE_TYPES))}, "
                        f"got {images.dtype}")
    if len(mean) != c_out or len(std) != c_out:
        raise ValueError(f"{c}->{c_out} channels with {len(mean)} statistics")
    if not (out_dtype.is_floating_point and out_dtype.itemsize <= 8):
        raise TypeError(f"out_dtype must be a floating type, not {out_dtype}")
    if images.dtype in (torch.bfloat16, torch.float16):
        images = images.float()  # the kernel reads uint8 or fp32 values
    elif not images.is_contiguous():
        images = images.contiguous()
    written = out_dtype if out_dtype in OUT_TYPES else torch.float32
    out = torch.empty((b, out_h, out_w, c_out), dtype=written, device=dev)
    if b:
        uint8 = images.dtype == torch.uint8
        ty = _device_taps(in_h, out_h, dev)
        tx = _device_taps(in_w, out_w, dev)
        scale, bias = _device_scale_bias(mean, std, 1.0 / 255.0 if uint8 else 1.0, dev)
        args = (images.data_ptr(), *(t.data_ptr() for t in ty), *(t.data_ptr() for t in tx),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, in_h, in_w, c, out_h, out_w, c_out, OUT_TYPES[written])
        if needs_direct(in_w, out_w, c, images.element_size()):
            entry, args = KERNEL_DIRECT, args + (int(not uint8),)
        else:
            entry = KERNEL if uint8 else KERNEL_F32SRC
        _build.launch(entry, dev, *args, key=launch_key(entry, written))
    return out if written == out_dtype else out.to(out_dtype)
