"""The work split of the image-prep kernel B2
(``clip_for_dl_tpu_torch/csrc/image_prep.cu``), emulated with torch on the
CPU and held against the plain version and the JAX package's kernel.

The emulation follows the kernel's data movement, not its threads:

- the host's plan, :func:`image_prep.band_plan` (the mirror of the C entry's
  ``make_plan``): bands of R output rows, column chunks, the staged row
  stride and the grid, each block keeping one chunk;
- per (image, band, chunk) item, the distinct source rows that the band's
  row taps name, each staged from the 16-byte-aligned address at or below
  its window's first byte, in 16-byte pieces; a piece that would reach
  before the tensor or past its end copies only the tensor's own bytes
  (the emulated input lies at an unaligned address ``base`` to exercise
  this). Unstaged bytes are NaN, so reading one shows;
- each output row read from its two slots, (wy0·r0 + wy1·r1) at the two
  source columns, then wx0·t0 + wx1·t1, then ·scale + bias, in fp32;
- the stores: each thread's 8 pixels are written whole, as 16-byte pieces
  through its warp's store region, where their first byte is 16-byte
  aligned and all 8 lie in the chunk, else as scalar writes; the output
  starts as NaN, so a missing store shows.

Held in fp32 within 1e-5 of JAX ``fused_resize_normalize(interpret=True)``
and ``preprocess_images(fused="never")`` (the same two-pass sums, in
another order), and of the port's ``preprocess_reference``. Planted faults
must fail.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jprep = importlib.import_module("clip_for_dl_tpu.ops.image_prep")
from clip_for_dl_tpu_torch.ops import image_prep as prep

torch.set_num_threads(1)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
H100_SMS = 132
FAULTS = ("band_drops_last_tap_row", "window_short_at_end", "scalar_tail_dropped")


def staged_rows(lo, hi, y0, rows, fault=None):
    """The band's distinct source rows in ascending slots, and each output
    row's two slots."""
    taps = np.stack([lo[y0:y0 + rows], hi[y0:y0 + rows]], 1)  # [rows, 2]
    named = taps if fault != "band_drops_last_tap_row" else taps[:-1]
    slots = np.unique(named)
    assert len(slots) <= 2 * rows
    # a row missing from the slots falls to the slot below it, as a wrong
    # index would
    return slots, np.clip(np.searchsorted(slots, taps, side="right") - 1, 0, None)


def stage(flat, base, start, nbytes, stride, fault=None, last_row=None):
    """One slot: the window's bytes [start, start + nbytes) of the input,
    copied from the aligned address at or below it in 16-byte pieces; a
    piece that leaves the tensor copies its own bytes only. Returns the
    slot (NaN where nothing was copied) and the window's offset in it."""
    end = base + flat.numel()
    if fault == "window_short_at_end":
        end -= last_row  # the staging stops one source row short of the end
    addr = base + start
    aligned, shift = addr - addr % 16, addr % 16
    assert shift + nbytes <= stride, "the window outgrows the planned stride"
    slot = torch.full((stride,), float("nan"))
    for j in range(-(-(shift + nbytes) // 16)):
        a = aligned + 16 * j
        lo, hi = max(a, base), min(a + 16, end)  # the piece's bytes inside the tensor
        if lo < hi:
            slot[lo - aligned:hi - aligned] = flat[lo - base:hi - base].float()
    return slot, shift


def store(out, elem0, values, pix, c_out, x_begin, x_end, elsize, fault=None):
    """One output row of a chunk: groups of ``pix`` pixels, each written
    whole in 16-byte pieces where its first byte is 16-byte aligned and all
    lie in the chunk, else scalar writes of its valid pixels. Returns the
    count of vector and scalar group writes."""
    n_vec = n_scalar = 0
    for g0 in range(x_begin, x_end, pix):
        n = min(pix, x_end - g0)
        first = elem0 + g0 * c_out
        vals = values[(g0 - x_begin) * c_out:(g0 - x_begin + n) * c_out]
        if n == pix and (first * elsize) % 16 == 0:
            assert (pix * c_out * elsize) % 16 == 0
            out[first:first + n * c_out] = vals
            n_vec += 1
        elif fault != "scalar_tail_dropped":
            out[first:first + n * c_out] = vals
            n_scalar += 1
    return n_vec, n_scalar


def emulate(images, out_h, out_w, mean, std, elsize=2, base=0, n_sms=H100_SMS, fault=None,
            stats=None):
    """B2's output in fp32 from uint8 NHWC ``images`` (numpy), following the
    kernel's plan, staging and stores; ``elsize`` is the output type's bytes
    (which decides vector against scalar stores)."""
    B, H, W, C = images.shape
    c_out = len(mean) if C == 1 else C
    plan = prep.band_plan(B, W, C, out_h, out_w, n_sms)
    ylo, yhi, yw0, yw1 = prep._resize_taps(H, out_h)
    xlo, xhi, xw0, xw1 = prep._resize_taps(W, out_w)
    scale, bias = (torch.from_numpy(a) for a in prep._norm_scale_bias(mean, std, 1 / 255))
    flat = torch.from_numpy(np.ascontiguousarray(images)).reshape(-1)
    out = torch.full((B * out_h * out_w * c_out,), float("nan"))
    row_bytes = W * C
    stats = {} if stats is None else stats
    stats.update(vector=0, scalar=0, slots=0, chunks=set())
    for block in range(plan.grid):
        chunk = block % plan.chunks
        for item in range(block, plan.items, plan.grid):
            assert item % plan.chunks == chunk, "a block's chunk changed"
            band_idx = item // plan.chunks
            b, y0 = band_idx // plan.bands, (band_idx % plan.bands) * plan.rows
            rows = min(plan.rows, out_h - y0)
            x_begin = chunk * plan.cols
            x_end = min(x_begin + plan.cols, out_w)
            c_lo, c_hi = int(xlo[x_begin]), int(xhi[x_end - 1])
            slots, tap_slot = staged_rows(ylo, yhi, y0, rows, fault)
            staged = [stage(flat, base, (b * H + r) * row_bytes + c_lo * C,
                            (c_hi - c_lo + 1) * C, plan.stride, fault, row_bytes)
                      for r in slots]
            stats["slots"] = max(stats["slots"], len(slots))
            stats["chunks"].add((x_begin, x_end))
            xs = np.arange(x_begin, x_end)
            o0 = torch.from_numpy((xlo[xs] - c_lo) * C)[:, None] + torch.arange(C)
            o1 = torch.from_numpy((xhi[xs] - c_lo) * C)[:, None] + torch.arange(C)
            wx0, wx1 = torch.from_numpy(xw0[xs])[:, None], torch.from_numpy(xw1[xs])[:, None]
            for i in range(rows):
                (s0, sh0), (s1, sh1) = staged[tap_slot[i, 0]], staged[tap_slot[i, 1]]
                wy0, wy1 = float(yw0[y0 + i]), float(yw1[y0 + i])
                t0 = wy0 * s0[sh0 + o0] + wy1 * s1[sh1 + o0]
                t1 = wy0 * s0[sh0 + o1] + wy1 * s1[sh1 + o1]
                u = wx0 * t0 + wx1 * t1  # [cols, C]
                v = u * scale + bias  # grey broadcasts to c_out channels
                n_vec, n_scalar = store(out, ((b * out_h + y0 + i) * out_w) * c_out,
                                        v.reshape(-1), prep.PIX, c_out, x_begin, x_end,
                                        elsize, fault)
                stats["vector"] += n_vec
                stats["scalar"] += n_scalar
    return out.reshape(B, out_h, out_w, c_out)


def _jax(images, out_h, out_w):
    ref = jprep.preprocess_images(jnp.asarray(images), out_h, out_w, CLIP_MEAN, CLIP_STD,
                                  jnp.float32, fused="never")
    ker = jprep.fused_resize_normalize(jnp.asarray(images), out_h, out_w, CLIP_MEAN,
                                       CLIP_STD, jnp.float32, interpret=True)
    return np.asarray(ref), np.asarray(ker)


def _assert_matches(got, images, out_h, out_w, with_jax=True):
    assert torch.isfinite(got).all(), "an output was never written or read unstaged bytes"
    plain = prep.preprocess_reference(torch.from_numpy(images), out_h, out_w, CLIP_MEAN,
                                      CLIP_STD, torch.float32)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    if with_jax:
        for want in _jax(images, out_h, out_w):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# (B, H, W, C) -> (out_h, out_w), the emulated address's misalignment, SMs
CASES = {
    "down_grey": ((2, 40, 36, 1), (24, 20), 0, H100_SMS),
    "up_rgb": ((2, 10, 14, 3), (24, 30), 0, H100_SMS),
    "identity_rgb": ((2, 24, 24, 3), (24, 24), 0, H100_SMS),
    "odd_widths_rgb_unaligned": ((2, 33, 97, 3), (16, 21), 5, H100_SMS),
    "rows_not_a_multiple_of_r": ((2, 50, 30, 1), (20, 16), 0, 1),
    "seven_wide_out_rows": ((2, 50, 30, 3), (7, 7), 3, H100_SMS),
    "strong_downsampling": ((1, 200, 150, 1), (12, 11), 0, 1),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_emulated_kernel_matches_jax_and_plain(case):
    shape, (oh, ow), base, n_sms = CASES[case]
    images = np.random.default_rng(len(case)).integers(0, 256, shape, dtype=np.uint8)
    stats = {}
    got = emulate(images, oh, ow, CLIP_MEAN, CLIP_STD, base=base, n_sms=n_sms, stats=stats)
    _assert_matches(got, images, oh, ow)
    plan = prep.band_plan(shape[0], shape[2], shape[3], oh, ow, n_sms)
    assert stats["slots"] <= 2 * plan.rows


def test_bands_stop_short_of_r_at_the_last_row():
    """H_out = 20 at R = 16: the second band has 4 rows."""
    plan = prep.band_plan(2, 30, 1, 20, 16, 1)
    assert (plan.rows, plan.bands) == (16, 2)


@pytest.mark.parametrize("elsize", [2, 4], ids=["bf16", "fp32"])
def test_stores_are_vectors_but_for_ragged_groups(elsize):
    """224 wide rows take only vector stores; 7 wide rows (42 bytes in bf16,
    84 in fp32) only scalar ones; 21 wide rows both."""
    images = np.random.default_rng(1).integers(0, 256, (2, 30, 30, 3), dtype=np.uint8)
    for ow, vec, scalar in ((224, True, False), (7, False, True), (21, True, True)):
        stats = {}
        got = emulate(images, 9, ow, CLIP_MEAN, CLIP_STD, elsize=elsize, stats=stats)
        _assert_matches(got, images, 9, ow, with_jax=False)
        assert (stats["vector"] > 0, stats["scalar"] > 0) == (vec, scalar)


def test_wide_source_rows_are_staged_in_column_chunks():
    """At R = 16 a buffer holds 32 rows of 704 bytes: a 1024 x 3 source row
    resized to 224 is staged in 5 chunks of 48 output columns (672 bytes
    each), each block keeping one."""
    images = np.random.default_rng(2).integers(0, 256, (1, 20, 1024, 3), dtype=np.uint8)
    plan = prep.band_plan(1, 1024, 3, 18, 224, 1)
    assert (plan.rows, plan.cols, plan.chunks) == (16, 48, 5)
    stats = {}
    got = emulate(images, 18, 224, CLIP_MEAN, CLIP_STD, n_sms=1, stats=stats)
    assert len(stats["chunks"]) == plan.chunks
    _assert_matches(got, images, 18, 224)


def test_chunks_narrower_than_a_thread_when_no_group_fits():
    """At 4096 -> 8 even 8 output columns span 3585 source columns, more
    than a 704-byte row of the buffer at R = 16: chunks of 2 columns."""
    images = np.random.default_rng(3).integers(0, 256, (1, 6, 4096, 1), dtype=np.uint8)
    plan = prep.band_plan(1, 4096, 1, 5, 8, 1)
    assert (plan.rows, plan.cols, plan.chunks) == (16, 2, 4)
    got = emulate(images, 5, 8, CLIP_MEAN, CLIP_STD, n_sms=1)
    _assert_matches(got, images, 5, 8, with_jax=False)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail(fault):
    """Each fault must leave a NaN or move an output beyond 1e-5: the
    unaligned, odd-width case ends on a partial 16-byte piece and has
    ragged 21-wide output rows; one band of R = 16 rows an image."""
    shape, (oh, ow), base, _ = CASES["odd_widths_rgb_unaligned"]
    images = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    got = emulate(images, oh, ow, CLIP_MEAN, CLIP_STD, base=base, n_sms=1, fault=fault)
    with pytest.raises(AssertionError):
        _assert_matches(got, images, oh, ow, with_jax=False)


@pytest.mark.parametrize("batch,out_h", [(1, 224), (8, 224), (256, 224), (1, 7), (3, 100),
                                         (65537, 8)])
def test_band_plan_covers_every_row_once_and_fills_the_card(batch, out_h):
    """Every (image, output row) falls in exactly one band; items reach the
    SM count where the rows allow it (one 224-row request: 224 bands of one
    row); the grid is a multiple of the chunks and at most 4 blocks an SM."""
    plan = prep.band_plan(batch, 512, 1, out_h, 224, H100_SMS)
    assert plan.bands * plan.rows >= out_h > (plan.bands - 1) * plan.rows
    covered = np.zeros(out_h, int)
    for band in range(plan.bands):
        covered[band * plan.rows:min((band + 1) * plan.rows, out_h)] += 1
    assert (covered == 1).all()
    assert plan.items == batch * plan.bands * plan.chunks
    assert plan.items >= min(H100_SMS, batch * out_h)
    assert plan.grid % plan.chunks == 0 and plan.grid <= max(plan.items, 1)
    assert plan.grid <= prep.BLOCKS_PER_SM * H100_SMS
    if batch * -(-out_h // prep.MAX_BAND) >= H100_SMS:
        assert plan.rows == prep.MAX_BAND


def test_band_plan_at_the_main_paths_shapes():
    """The serving batch: R = 16, one chunk, 3,584 items on 396 blocks of
    two 16.5 KB buffers; one request: 224 bands of one row."""
    assert prep.band_plan(256, 512, 1, 224, 224, H100_SMS) == prep.BandPlan(
        16, 224, 528, 14, 1, 3584, 396, 2 * 32 * 528)
    assert prep.band_plan(1, 224, 3, 224, 224, H100_SMS)[:6] == (1, 224, 688, 224, 1, 224)


def test_planned_stride_holds_every_window():
    """Over in and out widths 1..48 and a few wide ones, at every chunk the
    plan makes (64 channels force chunks), the window's bytes plus its
    misalignment fit the stride."""
    pairs = [(i, o) for i in range(1, 49) for o in range(1, 49)]
    pairs += [(512, 224), (4096, 224), (333, 224), (97, 224), (224, 97), (1536, 224)]
    for in_w, out_w in pairs:
        lo, hi, _, _ = prep._resize_taps(in_w, out_w)
        for channels in (1, 3, 64):
            plan = prep.band_plan(1, in_w, channels, 16, out_w, 1)
            for x0 in range(0, out_w, plan.cols):
                x1 = min(x0 + plan.cols, out_w) - 1
                assert 15 + (int(hi[x1]) - int(lo[x0]) + 1) * channels <= plan.stride, (
                    in_w, out_w, channels, plan)


def test_band_plan_refuses_only_past_shared_memory():
    """The staged body takes a row pair up to shared memory; past it the
    plan is the direct body's (a row of blocks an (image, output row)),
    not a refusal."""
    staged = prep.band_plan(1, 4, 20000, 4, 4, H100_SMS)
    assert staged.cols == 1 and not staged.direct
    assert prep.band_plan(1, 4, 40000, 4, 4, H100_SMS) == prep.BandPlan(
        1, 4, 0, 4, 1, 4, 4, 0, True)
