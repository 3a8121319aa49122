#!/usr/bin/env python3
"""Drive the PyTorch port's zero-shot serving paths (ResNet-50 and ViT-B/16),
its phase-A train step, its split-q/k/v attention entry point, the chain
pretrain -> adapter (phase B) and the fp32 parity mode once on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

0. Card: name and power limit from nvidia-smi. Without CUDA, exit at once.
1. Build: compile the port's kernels (clip_for_dl_tpu_torch/csrc/*.cu) with
   nvcc for sm_90a, one nvcc per source, all at once; print the build time,
   ptxas' per-kernel summary and, from cuobjdump's SASS of the library, the
   tensor-core instructions (HMMA, HGMMA) of each attention kernel (the
   forward, and the backward's rows and columns pass, at D = 32, 64 and 128
   and in the sliced form over 128; fails if one has none), the HGMMA of
   B8's two kernels (fails if either has none) and the HGMMA and HMMA of
   the GEMM pair of B4 and of B9 (mlp_fwd_gelu_kernel, mlp_fwd_out_kernel;
   fails at no HGMMA or any HMMA).
2. Kernels: each of B1-B9 against its plain PyTorch version on the card at
   the main paths' shapes (B3 also with dropout 0.1 at the train shape, its
   dropout mask compared bit for bit, and at the ViT shape; B6 at rates 0
   and 0.1; B9 with exact and tanh GELU and at one request's 197 rows); then
   the widths ROADMAP C1-C3 repaired: B3 and B6 at head dim 128 and N = 512,
   B4 and B8 at hidden 256; then the split form: B5 and B7 at the BERT shape
   (128, 200, 12, 64) in both layouts at rates 0 and 0.1 (dropout masks bit
   for bit), bit-equal to B3 and B6 on the same heads, and at D = 128,
   N = 512; the split entry point with autograd (the split_attention path);
   and the layout probe P1 (tools/probe_bwd_layouts.py: B6, B7 "bnhd" and B7
   "bhnd" bit-equal; the layout_probe path); then the limits ROADMAP C4-C6
   lifted: B3/B5/B6/B7 at head dim 32 (built) and 96 (zero-padded to 128)
   against their plain versions (B5/B7 bit-equal to B3/B6), B1 at D = 64
   and 96 with C = 200 prompts, and B2, B3 and B6 at a batch of 65537; and
   head dims over 128 (C4 closed): B3/B5/B6/B7 at D = 160, 256 and 320,
   rates 0 and 0.1, B5/B7 bit-equal to B3/B6, the dropout masks bit for
   bit. B2 also runs at one request ([1, 224, 224, 3]), and is timed with
   its device time (torch.profiler), its GB/s and a Tensor.copy_ of its
   output's size beside it; B1 beside one F.cosine_similarity call (its
   library_ms). B8 is also timed beside its three products alone in cuBLAS (a
   yardstick the port never calls), B4 and B9 beside their two, each with
   its kernels' device times from torch.profiler; B4, B8 and B9 are held at
   H = 1280 (F = 5120) and H = 192 (F = 768).
   Max abs/rel difference against
   the tolerance below (B6 and B7 per (batch row, head) slice of each
   gradient), both times the median of five CUDA-event timings after
   warm-up, the bound (the larger of the bytes each call must move over
   3.35 TB/s and its operations over the dense peak of their type), and for
   attention the time of F.scaled_dot_product_attention (forward, or its
   backward) on contiguous head-major copies of the same inputs at rate 0,
   with the backend it picked. Shapes off the kernels line (other rates,
   layouts and widths) print the same figures.
3. Slice: the full-width CXRClip (ResNet-50, BERT-base at vocab 28996,
   512-d heads; random weights from --seed) in bf16 with flash attention and
   the fused BERT MLP, wrapped in ZeroShotEngine: prompt bank ("prediction"
   family, the synthetic dev vocabulary, 200 tokens), batches of 512x512
   grey uint8 images through probs and stream_logits, single 224x224x3
   requests through ZeroShotService.predict_one. Checks shapes, finite
   probabilities in [0, 1], service answers equal to engine.probs, every
   kernel launched by the main path, and the engine's probabilities against
   the same model with each kernel replaced by its plain version. Prints
   img/s.
4. Train: the ``pretrain_clip`` preset at full width (flash attention and the
   fused MLP on, dropout 0.1) with fp32 master weights and bf16 compute,
   random weights from --seed, through ``make_clip_pretrain_step``: first one
   step with dropout 0 against the same step with every kernel (forward and
   backward) replaced by its plain version, from the same weights (loss and
   per-group gradient cosine); then TRAIN_STEPS steps on one batch of
   TRAIN_BATCH 512x512 grey uint8 images and 200-token reports of mixed
   lengths, each synced and timed, and one eval step. Checks finite, falling
   losses, every parameter group and the BatchNorm statistics moved, and
   B2, B3, B4, B6 and B8 launched by the train path. Prints samples/s and
   the peak device memory.
5. ViT slice: phase 3 over the ``vit`` preset's model (ViT-B/16 at 224,
   patch 16, 12 x 768, 12 heads, MLP 3072, and the same BERT-base) with the
   fused ViT MLP block (B9), flash attention in both towers and the fused
   BERT MLP, bf16, random weights from --seed; the same checks, B9 among the
   kernels the path must launch.
6. Chain: phase A, the ``pretrain_clip`` model of phase 4 through ``fit``
   for one epoch of CHAIN_STEPS steps at TRAIN_BATCH with a one-batch
   validation and a CheckpointManager in a temporary directory (the
   pretrain_fit path); then phase B, ``restore_variables`` of that epoch into
   the ``adapter`` preset's model and ``fit`` with the adapter steps for 2
   epochs of CHAIN_STEPS steps on one fixed batch with 16-label multi-hot
   targets from --seed, eval each epoch and best-1 retention, a
   PreemptionGuard triggered after step 2 of a third epoch (the adapter
   path). Checks the towers and BatchNorm statistics bit-equal, the adapter
   moved, finite losses falling on the fixed batch, the retained epoch the
   best by val loss, the preemption slot, ``resume_or_init`` bit-equal at
   the JAX rule's epoch, a finite macro AUROC from ``run_eval``'s
   probabilities, and B2 launched. Prints adapter samples/s, checkpoint save
   ms and the peak device memory.

Phase 2 also holds ROADMAP C7 and C8: the fp32 and fp16 instances of
B3/B5/B6/B7 at head dims 32, 64, 128 and 160 and N = 512, rates 0 and 0.1
(fp32 within 1e-5, gradients within 1e-4 of each slice's largest entry;
fp16 two fp16 steps; masks bit for bit; split bit-equal to packed), timed
beside SDPA in their type, and the autograd entry points in fp16 and fp32
split (path typed_attention); B1 on bf16, fp16 and mixed features, B2 on
fp32 and bf16 images, writing fp16 and fp64, on rows too wide to stage
(the direct body, bit-equal to the staged one) and on views (path
c8_cases).
7. Parity mode (the JAX CLI's --fp32 --flash-attention): the ``zero_shot``
   model in fp32 encodes the prompt bank and scores a batch through the fp32
   attention kernels, and one fp32 phase-A step of ``pretrain_clip`` at its
   B = 16, each against the same model on the plain route (B2 kept): text
   features and probabilities within 1e-5, the loss within 1e-5 relative,
   each group's gradient cosine >= 0.9999. Then tools/launch_times.py times
   the wrappers from the host.

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# Tolerances (max abs difference) of each kernel against its plain version
# on the card, with the reason for each.
TOL = {
    # fp32 in and out, sums in another order; logits are bounded by 1/T = 2
    "similarity": 1e-5,
    # fp32 output: 2-tap lerp vs the dense-matrix matmul, values ≤ 2.2
    "image_prep_f32": 1e-4,
    # bf16 output: a 1e-6 fp32 difference can flip one bf16 rounding step,
    # 2^-7 at values up to 2.2
    "image_prep": 1.6e-2,
    # bf16 output |o| ≤ ~3: summation order may flip the bf16 rounding of a
    # probability or of the output, each ≤ one bf16 step (2^-7 · 2)
    "flash_attention": 2e-2,
    # bf16 output |y| ≲ 2: accumulation order may flip the bf16 rounding of
    # the GELU output or of y, each ≤ one bf16 step
    "mlp": 2e-2,
    # B8, relative to each output's largest entry: two bf16 steps (2^-6);
    # the kernel rounds the same intermediates (g, dh) to bf16 as the plain
    # version, and summation order can flip one rounding of an intermediate
    # and one of the output. B6 and B7 are held the same way per (batch row,
    # head) slice of each gradient (fa.grad_slice_error, in compare_grads)
    "bwd_rel": 2.0 ** -6,
    # B9, on the MLP branch out - x and relative to its largest entry: two
    # bf16 steps (2^-6); a summation-order flip of the GELU or o rounding
    # moves out by one step of o, and the residual's rounding by one step of
    # out, which at x ~ N(0, 1) (|out| < 8) is within one more step of the
    # branch's largest entry (|o| ~ 4)
    "mlp_block_rel": 2.0 ** -6,
    # phase 4, kernels vs plain versions from the same weights and inputs,
    # dropout 0: the cosine of each parameter group's gradient with the
    # plain one, for the backward of one fixed random cotangent on both
    # towers' features and for one whole step (the kernels round the same
    # intermediates as their plain versions; only rounding flips and
    # summation order differ); and the step's loss (≈ 7 at B = 128) within
    # 2%: bf16 features carry ~3 significant digits, and the self-distill
    # loss on raw 512-d features (norm ≈ 22) at T = 2 has logits up to ~20
    "grad_cos": 0.99,
    "train_loss_rel": 2e-2,
    # engine probabilities, kernels vs plain versions through the whole bf16
    # model (phases 3 and 5): the kernel differences above move cosines by
    # ~1e-3
    "probs_vs_plain": 5e-3,
    # service answer vs engine.probs on the same image at batch 1: the same
    # kernels on the same shapes; host vs device sigmoid
    "service": 1e-6,
    # fp16 output |x| ≤ 2.2: a 1e-6 fp32 difference can flip one fp16
    # rounding step, 2^-9 there
    "image_prep_f16": 2.0 ** -9,
    # the parity mode (fp32 compute, flash attention) against the plain
    # route from the same weights and images: only the attention kernels'
    # summation order differs, ~1e-7 relative a layer. The unit text
    # features within 1e-5, the probabilities within 1e-5; one step's loss
    # within 1e-5 relative and each group's gradient cosine ≥ 0.9999
    "fp32_features": 1e-5,
    "fp32_probs": 1e-5,
    "fp32_loss_rel": 1e-5,
    "fp32_grad_cos": 0.9999,
}

SRC = "clip_for_dl_tpu_torch/csrc/"
TPU = "clip_for_dl_tpu/ops/"
# name -> (the key its launches count under in _build.LAUNCHES, CUDA source,
# TPU kernel it replaces): one row per instance of the kernels line. The
# attention kernels have a C entry per operand type (fp16 "_f16", fp32
# "_f32"); B1 counts each pair of feature types apart, B2 its fp16 output
KERNELS = {
    "similarity": ("cxr_similarity", SRC + "similarity.cu", TPU + "similarity.py:45"),
    "similarity_bf16": ("cxr_similarity_bf16_bf16", SRC + "similarity.cu",
                        TPU + "similarity.py:45"),
    "similarity_fp16": ("cxr_similarity_fp16_fp16", SRC + "similarity.cu",
                        TPU + "similarity.py:45"),
    "image_prep": ("cxr_image_prep", SRC + "image_prep.cu", TPU + "image_prep.py:185"),
    "image_prep_f32src": ("cxr_image_prep_f32src", SRC + "image_prep.cu",
                          TPU + "image_prep.py:185"),
    "image_prep_fp16": ("cxr_image_prep_fp16", SRC + "image_prep.cu", TPU + "image_prep.py:185"),
    "image_prep_direct": ("cxr_image_prep_direct", SRC + "image_prep.cu",
                          TPU + "image_prep.py:185"),
    **{f"flash_attention{tag}": (f"cxr_flash_fwd_packed{x}", SRC + "flash_attention.cu",
                                 TPU + "flash_attention.py:309")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
    **{f"flash_attention_bwd{tag}": (f"cxr_flash_bwd_packed{x}", SRC + "flash_attention_bwd.cu",
                                     TPU + "flash_attention.py:375")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
    "mlp": ("cxr_mlp_fwd", SRC + "mlp_train.cu", TPU + "mlp_train.py:99"),
    "mlp_bwd": ("cxr_mlp_bwd", SRC + "mlp_train_bwd.cu", TPU + "mlp_train.py:112"),
    "mlp_block": ("cxr_mlp_block", SRC + "mlp_block.cu", TPU + "mlp_block.py:78"),
    **{f"flash_attention_split{tag}": (f"cxr_flash_fwd{x}", SRC + "flash_attention.cu",
                                       TPU + "flash_attention.py:278")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
    **{f"flash_attention_split_bwd{tag}": (f"cxr_flash_bwd{x}", SRC + "flash_attention_bwd.cu",
                                           TPU + "flash_attention.py:343")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
}
TRAIN_KERNELS = ("image_prep", "flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd")
PATHS = {  # main path -> the kernels it must launch
    "serve": ("similarity", "image_prep", "flash_attention", "mlp"),
    "train": TRAIN_KERNELS,
    "serve_vit": ("similarity", "image_prep", "flash_attention", "mlp", "mlp_block"),
    "split_attention": ("flash_attention_split", "flash_attention_split_bwd"),
    "layout_probe": ("flash_attention_bwd", "flash_attention_split_bwd"),
    "pretrain_fit": TRAIN_KERNELS,
    "adapter": ("image_prep",),
    # the parity mode (--fp32 --flash-attention): zero-shot serving and a
    # phase-A step in fp32
    "serve_fp32": ("similarity", "image_prep", "flash_attention_fp32"),
    "train_fp32": ("image_prep", "flash_attention_fp32", "flash_attention_bwd_fp32"),
    # the attention entry points with autograd in the types no preset runs
    "typed_attention": ("flash_attention_fp16", "flash_attention_bwd_fp16",
                        "flash_attention_split_fp16", "flash_attention_split_bwd_fp16",
                        "flash_attention_split_fp32", "flash_attention_split_bwd_fp32"),
    # B1 and B2 on the inputs C8 opened to them, through the public functions
    "c8_cases": ("similarity_bf16", "similarity_fp16", "image_prep_f32src", "image_prep_fp16",
                 "image_prep_direct"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 and fp16 on the tensor
# cores and fp32 on the CUDA cores, in operations a second; HBM3 in bytes a
# second
PEAK = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
VIT_TOKENS = 197  # ViT-B/16 at 224: 14 x 14 patches and the class token
BATCH = 256  # images per zero-shot batch (512x512 grey uint8)
N_BATCHES = 6  # batches per streamed run
TRAIN_BATCH = 128  # image-report pairs per train step
TRAIN_STEPS = 10  # steps on one fixed batch
TRAIN_LEN = 200  # report tokens (the preset's max_text_length)
CHAIN_STEPS = 4  # steps per epoch of phase 6's fits


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def import_port():
    """The port package from this checkout (not from anywhere else)."""
    sys.path.insert(0, str(ROOT))
    try:
        import clip_for_dl_tpu_torch
    except ImportError as exc:
        raise SmokeFailure(f"the port package is not beside this script: {exc}")
    check(Path(clip_for_dl_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"imported the port from {clip_for_dl_tpu_torch.__file__}, not from {ROOT}")
    from clip_for_dl_tpu_torch.ops import (
        _build, flash_attention, image_prep, mlp_block, mlp_train, similarity,
    )

    return _build, {"similarity": similarity, "image_prep": image_prep,
                    "flash_attention": flash_attention, "mlp_train": mlp_train,
                    "mlp_block": mlp_block}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not measured"


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """ms of one call of ``fn``: the median of five CUDA-event timings of
    ``iters`` calls each, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(flops: float, tensors, peak: str = "bf16"):
    """The least time the card could take for one call: the larger of the
    bytes it must move (each input read once, each output written once) over
    the HBM rate and its operations over the dense peak of ``peak``. Returns
    (ms, what bounds it, a description of the work)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / PEAK[peak], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            f"{flops / 1e9:.2f} G{peak} operations, {nbytes / 1e6:.1f} MB")


def set_bound(results: dict, name: str, flops: float, tensors, peak: str = "bf16") -> None:
    ms, by, work = bound(flops, tensors, peak)
    results[name].update(bound_ms=ms, bound_by=by)
    print(f"  {name} bound: {ms:.4f} ms by {by} ({work})")


def sdpa_backend(q, k, v, mask) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs
    (its own dispatch rule, torch._fused_sdp_choice), or "not measured"
    where this torch does not say."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask)).name
    except (AttributeError, ImportError, RuntimeError, TypeError, ValueError):
        return "not measured"


def sdpa_ms(q, k, v, bias, do=None) -> float:
    """Time of one PyTorch call for the same attention at rate 0:
    F.scaled_dot_product_attention on contiguous head-major [B, H, N, D]
    copies of q, k, v with the key bias as a [B, 1, 1, N] mask in their
    dtype; with ``do`` (made contiguous too), the time of its backward alone.
    Prints the backend it picked. A yardstick only: the port never calls
    it."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    xs = [t.detach().contiguous().requires_grad_(do is not None) for t in (q, k, v)]
    backend = sdpa_backend(*xs, mask)
    if do is None:
        ms = cuda_ms(lambda: sdpa(*xs, attn_mask=mask), iters=10)
    else:
        out, do = sdpa(*xs, attn_mask=mask), do.contiguous()
        ms = cuda_ms(lambda: torch.autograd.grad(out, xs, do, retain_graph=True), iters=10)
    print(f"  F.scaled_dot_product_attention{' backward' if do is not None else ''} at "
          f"{tuple(q.shape)}, rate 0 ({backend}): {ms:.4f} ms")
    return ms


def kernel_device_ms(fn, names, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` spent in the kernels whose names contain
    each of ``names`` (torch.profiler over ``calls`` calls after one), as
    strings; "not measured" where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(names, 0.0)
    for avg in prof.key_averages():
        for name in names:
            if name in avg.key:
                totals[name] += getattr(avg, "device_time_total", 0.0)
    return {k: f"{v / 1e3 / calls:.4f}" if v > 0 else "not measured" for k, v in totals.items()}


def heads_of(qkv, H: int):
    """Head-major [B, H, N, D] views of a packed qkv's q, k and v."""
    B, N, _ = qkv.shape
    return qkv.view(B, N, 3, H, -1).permute(2, 0, 3, 1, 4).unbind(0)


def compare(name, got, want, tol, results):
    import torch

    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-3)).max())
    print(f"  {name}: max_abs {max_abs:.3e}  max_rel {max_rel:.3e}  tol {tol:.1e}")
    check(max_abs <= tol, f"{name}: max_abs {max_abs} > tol {tol}")
    results.setdefault(name, {})["max_abs_err"] = max(
        max_abs, results.get(name, {}).get("max_abs_err", 0.0))


def compare_grads(name, got, want, layout, results, heads=None):
    """An attention backward kernel's gradient against its plain version's,
    per (batch row, head) slice (fa.grad_slice_error): finite, and each slice
    within two bf16 steps of that slice's own largest entry."""
    import torch

    from clip_for_dl_tpu_torch.ops.flash_attention import grad_slice_error

    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    max_abs, worst = grad_slice_error(got, want, layout, heads)
    print(f"  {name}: max_abs {max_abs:.3e}  worst (batch row, head) slice at {worst:.3f} "
          "of its tolerance")
    check(worst <= 1.0, f"{name}: a slice is off by {worst} of its tolerance")
    results.setdefault(name, {})["max_abs_err"] = max(
        max_abs, results.get(name, {}).get("max_abs_err", 0.0))


def phase2(mods, dev, seed: int, batch: int, results: dict) -> None:
    import torch

    sim, prep = mods["similarity"], mods["image_prep"]
    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)

    print(f"B1 similarity: img [{batch}, 512] x txt [16, 512] fp32, T = 0.5")
    img = torch.randn(batch, 512, device=dev, generator=g)
    img[-1] = 0.0  # a padded bucket row
    txt = torch.randn(16, 512, device=dev, generator=g)
    compare("similarity", sim.similarity(img, txt, 0.5),
            sim.similarity_reference(img, txt, 0.5), TOL["similarity"], results)
    results["similarity"]["ms"] = cuda_ms(lambda: sim.similarity(img, txt, 0.5))
    results["similarity"]["plain_ms"] = cuda_ms(lambda: sim.similarity_reference(img, txt, 0.5))
    # one PyTorch call of B1's function, each norm clamped at eps; a yardstick
    # the port never calls
    cos = torch.nn.functional.cosine_similarity
    results["similarity"]["library_ms"] = cuda_ms(
        lambda: cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5)
    lib_err = float((cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5
                     - sim.similarity(img, txt, 0.5)).abs().max())
    print(f"  F.cosine_similarity / T: {results['similarity']['library_ms']:.4f} ms, "
          f"max_abs {lib_err:.3e} from the kernel; B1's device ms a call (torch.profiler) "
          f"{kernel_device_ms(lambda: sim.similarity(img, txt, 0.5), ('similarity',))}")
    # the product, and a square, a sum and a scale per input value
    set_bound(results, "similarity", 2 * batch * 16 * 512 + 3 * (batch + 16) * 512,
              (img, txt, sim.similarity(img, txt, 0.5)), "fp32")

    print(f"B2 image prep: [{batch}, 512, 512, 1] uint8 -> [{batch}, 224, 224, 3] bf16; "
          "and [8, 224, 224, 3] and [1, 224, 224, 3] identity")
    grey = torch.randint(0, 256, (batch, 512, 512, 1), device=dev, generator=g,
                         dtype=torch.uint8)
    rgb = torch.randint(0, 256, (8, 224, 224, 3), device=dev, generator=g, dtype=torch.uint8)
    for images in (grey, rgb, rgb[:1]):
        compare("image_prep", prep.preprocess_images(images, 224, 224, mean, std),
                prep.preprocess_reference(images, 224, 224, mean, std),
                TOL["image_prep"], results)
        compare("image_prep_f32",
                prep.preprocess_images(images, 224, 224, mean, std, torch.float32),
                prep.preprocess_reference(images, 224, 224, mean, std, torch.float32),
                TOL["image_prep_f32"], results)
    results.pop("image_prep_f32")
    results["image_prep"]["ms"] = cuda_ms(
        lambda: prep.preprocess_images(grey, 224, 224, mean, std))
    results["image_prep"]["plain_ms"] = cuda_ms(
        lambda: prep.preprocess_reference(grey, 224, 224, mean, std))
    out = prep.preprocess_images(grey, 224, 224, mean, std)
    # per output value: a 2x2 bilinear blend (4 multiply-adds) and a scale
    # and shift
    set_bound(results, "image_prep", 10 * out.numel(), (grey, out), "fp32")
    prep_yardstick(prep, grey, out, mean, std, results["image_prep"]["ms"])
    one = rgb[:1]
    one_out = prep.preprocess_images(one, 224, 224, mean, std)
    extra_times("B2 at one request [1, 224, 224, 3]",
                lambda: prep.preprocess_images(one, 224, 224, mean, std),
                lambda: prep.preprocess_reference(one, 224, 224, mean, std),
                10 * one_out.numel(), (one, one_out), peak="fp32")
    prep_yardstick(prep, one, one_out, mean, std, None)

    print("B3 attention: qkv [64, 200, 2304] bf16, 12 heads of 64, padded keys")
    qkv = torch.randn(64, 200, 3 * 768, device=dev, generator=g).bfloat16()
    lengths = torch.randint(3, 201, (64, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(200, device=dev)[None] < lengths, 0.0, -1e10)
    compare("flash_attention", fa.flash_attention_packed(qkv, 12, bias),
            fa.flash_attention_packed_reference(qkv, 12, bias), TOL["flash_attention"],
            results)
    results["flash_attention"]["ms"] = cuda_ms(lambda: fa.flash_attention_packed(qkv, 12, bias))
    results["flash_attention"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_packed_reference(qkv, 12, bias))
    set_bound(results, "flash_attention", 4 * 64 * 12 * 200 * 200 * 64,
              (qkv, bias, fa.flash_attention_packed(qkv, 12, bias)))
    results["flash_attention"]["library_ms"] = sdpa_ms(*heads_of(qkv, 12), bias)

    print("B4 MLP: x [12800, 768] bf16, W1 [3072, 768], W2 [768, 3072]")
    x = torch.randn(12800, 768, device=dev, generator=g).bfloat16()
    w1 = (torch.randn(3072, 768, device=dev, generator=g) * 0.02).bfloat16()
    b1 = (torch.randn(3072, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(768, 3072, device=dev, generator=g) * 0.02).bfloat16()
    b2 = (torch.randn(768, device=dev, generator=g) * 0.02).bfloat16()
    compare("mlp", mlp.dense_gelu_dense(x, w1, b1, w2, b2),
            mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), TOL["mlp"], results)
    results["mlp"]["ms"] = cuda_ms(lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2), iters=10)
    results["mlp"]["plain_ms"] = cuda_ms(
        lambda: mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), iters=10)
    set_bound(results, "mlp", 4 * 12800 * 768 * 3072,
              (x, w1, b1, w2, b2, mlp.dense_gelu_dense(x, w1, b1, w2, b2)))
    mlp_fwd_yardstick("B4", lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2), x, w1, w2)
    del x

    print(f"B3 attention at the ViT shape: qkv [{batch}, {VIT_TOKENS}, 2304] bf16, no key bias")
    qkv = torch.randn(batch, VIT_TOKENS, 3 * 768, device=dev, generator=g).bfloat16()
    compare("flash_attention", fa.flash_attention_packed(qkv, 12),
            fa.flash_attention_packed_reference(qkv, 12), TOL["flash_attention"], results)
    extra_times("B3 at the ViT shape", lambda: fa.flash_attention_packed(qkv, 12),
                lambda: fa.flash_attention_packed_reference(qkv, 12),
                4 * batch * 12 * VIT_TOKENS ** 2 * 64, (qkv, fa.flash_attention_packed(qkv, 12)),
                sdpa_ms(*heads_of(qkv, 12), None))
    del qkv

    check_mlp_block(mods["mlp_block"], dev, seed, batch * VIT_TOKENS, results)
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")


def check_mlp_block(blk, dev, seed: int, rows: int, results: dict) -> None:
    """B9 against its plain version at ``rows`` x 768 x 3072 (exact and tanh
    GELU) and at one request's 197 rows, then both times. x at std 1,
    weights at std fan_in^-1/2 and every LayerNorm parameter and bias at std
    0.1 in fp32, so that each input moves the output by more than the
    tolerance. The MLP branch out - x is held, not out: the residual, which
    both sides add, would set the scale of a tolerance on out."""
    import torch

    g = torch.Generator(dev).manual_seed(seed + 5)
    H, F = 768, 3072
    print(f"B9 MLP block: x [{rows}, {H}] bf16, W1 [{F}, {H}], W2 [{H}, {F}], fp32 "
          f"LayerNorm parameters and biases; exact and tanh GELU; one request's "
          f"{VIT_TOKENS} rows")
    x = torch.randn(rows, H, device=dev, generator=g).bfloat16()
    ls = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g)
    lb = 0.1 * torch.randn(H, device=dev, generator=g)
    w1 = (torch.randn(F, H, device=dev, generator=g) * H ** -0.5).bfloat16()
    b1 = 0.1 * torch.randn(F, device=dev, generator=g)
    w2 = (torch.randn(H, F, device=dev, generator=g) * F ** -0.5).bfloat16()
    b2 = 0.1 * torch.randn(H, device=dev, generator=g)
    args = (x, ls, lb, w1, b1, w2, b2)
    one = (x[:VIT_TOKENS],) + args[1:]
    for a, approximate in ((args, False), (args, True), (one, False)):
        xf = a[0].float()
        want = blk.fused_mlp_block_reference(*a, gelu_approximate=approximate).float() - xf
        got = blk.fused_mlp_block(*a, gelu_approximate=approximate).float() - xf
        compare("mlp_block", got, want,
                TOL["mlp_block_rel"] * float(want.abs().max()), results)
    del xf, want, got
    results["mlp_block"]["ms"] = cuda_ms(lambda: blk.fused_mlp_block(*args), iters=10)
    results["mlp_block"]["plain_ms"] = cuda_ms(
        lambda: blk.fused_mlp_block_reference(*args), iters=10)
    set_bound(results, "mlp_block", 4 * rows * H * F, args + (blk.fused_mlp_block(*args),))
    mlp_fwd_yardstick("B9", lambda: blk.fused_mlp_block(*args), x, w1, w2)
    extra_times(f"B9 at one request ({VIT_TOKENS} rows)", lambda: blk.fused_mlp_block(*one),
                lambda: blk.fused_mlp_block_reference(*one), 4 * VIT_TOKENS * H * F,
                one + (blk.fused_mlp_block(*one),))
    mlp_fwd_yardstick(f"B9 at one request ({VIT_TOKENS} rows)",
                      lambda: blk.fused_mlp_block(*one), one[0], w1, w2)


def mlp_fwd_yardstick(what: str, kernel, x, w1, w2) -> None:
    """Print the device time of each kernel of an MLP forward call (B4: the
    GEMM pair; B9: also its LayerNorm pass) and, as a yardstick the port
    never calls, the time of its two products alone in cuBLAS (torch.matmul,
    bf16: x·W1ᵀ, then g·W2ᵀ on a bf16 g of the same shape)."""
    import torch

    g = torch.empty(x.shape[0], w1.shape[0], dtype=torch.bfloat16, device=x.device).normal_()
    products = cuda_ms(lambda: (torch.matmul(x, w1.T), torch.matmul(g, w2.T)), iters=10)
    split = kernel_device_ms(kernel, ("mlp_block_ln_kernel", "mlp_fwd_gelu_kernel",
                                      "mlp_fwd_out_kernel"))
    print(f"  {what}: its two products alone in cuBLAS {products:.4f} ms (a yardstick, never "
          "called by the port); device ms a call (torch.profiler): "
          + ", ".join(f"{k} {v}" for k, v in split.items()))


def prep_yardstick(prep, images, out, mean, std, event_ms) -> None:
    """Print B2's device time (torch.profiler) beside its event time, the
    GB/s it reaches on the bytes it must move (input read once, output
    written once), and as a bandwidth yardstick the port never calls, one
    ``Tensor.copy_`` of a tensor of the output's size (bytes read and
    written)."""
    import torch

    dev_ms = kernel_device_ms(
        lambda: prep.preprocess_images(images, 224, 224, mean, std), ("image_prep",),
        calls=20)["image_prep"]
    nbytes = images.numel() * images.element_size() + out.numel() * out.element_size()
    src = torch.empty_like(out).normal_()
    dst = torch.empty_like(out)
    copy_ms = cuda_ms(lambda: dst.copy_(src))
    copy_bytes = 2 * out.numel() * out.element_size()
    rate = "not measured" if dev_ms == "not measured" else \
        f"{nbytes / float(dev_ms) / 1e6:.1f} GB/s"
    event = "" if event_ms is None else f"events {event_ms:.4f} ms, "
    print(f"  B2 at {list(images.shape)}: {event}device {dev_ms} ms a call (torch.profiler), "
          f"{rate} on {nbytes / 1e6:.1f} MB; Tensor.copy_ of {list(out.shape)} "
          f"{out.dtype}: {copy_ms:.4f} ms, {copy_bytes / copy_ms / 1e6:.1f} GB/s on "
          f"{copy_bytes / 1e6:.1f} MB (a yardstick, never called by the port)")


def extra_times(what: str, kernel, plain, flops: float, io, library_ms=None,
                peak: str = "bf16") -> None:
    """Print the figures of a shape off the kernels line: kernel and plain
    times, the bound of ``flops`` over the tensors ``io`` (as set_bound) and,
    for attention, the SDPA time measured on the same inputs at rate 0."""
    ms, by, work = bound(flops, io, peak)
    sdpa = "" if library_ms is None else f"  SDPA {library_ms:.4f} ms"
    print(f"  {what}: kernel {cuda_ms(kernel, iters=10):.4f} ms  "
          f"plain {cuda_ms(plain, iters=10):.4f} ms  bound {ms:.4f} ms by {by} ({work}){sdpa}")


def dropout_probe(B: int, N: int, H: int, D: int, dev):
    """Attention inputs whose outputs show the dropout mask: q = k = 0, so
    every kept probability of a row is the same nonzero constant; batch row b
    attends only to the keys of window w = b mod ceil(N / D), [wD, wD + D),
    where v_j is one-hot at dim j - wD; and d(out) is one-hot at dim i - w'D
    for the query rows of window w' = (b // ceil(N / D)) mod ceil(N / D), zero
    elsewhere. Then out[b, i, h, j - wD] and dv[b, j, h, i - w'D] are nonzero
    exactly where (i, j) is kept, so a zero pattern compared between the
    kernel and the plain version compares the masks bit for bit."""
    import torch

    nwin = -(-N // D)
    pos = torch.arange(N, device=dev)
    win = torch.arange(B, device=dev) % nwin
    in_key = (pos[None] // D) == win[:, None]  # [B, N]
    in_row = (pos[None] // D) == ((torch.arange(B, device=dev) // nwin) % nwin)[:, None]
    onehot = torch.nn.functional.one_hot(pos % D, D).float()  # [N, D]
    qkv = torch.zeros(B, N, 3, H, D, device=dev)
    qkv[:, :, 2] = (onehot[None] * in_key[..., None])[:, :, None, :]
    do = (onehot[None] * in_row[..., None])[:, :, None, :].expand(B, N, H, D)
    bias = torch.where(in_key, 0.0, -1e10)
    return (qkv.reshape(B, N, 3 * H * D).bfloat16(), do.reshape(B, N, H * D).bfloat16(),
            bias)


def phase2_train(mods, dev, seed: int, results: dict) -> None:
    """B3 with dropout, B6 and B8 at the train path's shapes."""
    import torch

    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed + 1)
    B, N, H, D = TRAIN_BATCH, TRAIN_LEN, 12, 64

    print(f"B3 attention with dropout 0.1: qkv [{B}, {N}, {3 * H * D}] bf16, padded keys")
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    compare("flash_attention", fa.flash_attention_packed(qkv, H, bias, **drop),
            fa.flash_attention_packed_reference(qkv, H, bias, **drop),
            TOL["flash_attention"], results)
    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    got = fa.flash_attention_packed(pq, H, pbias, **drop)
    want = fa.flash_attention_packed_reference(pq, H, pbias, **drop)
    kept = want != 0
    check(torch.equal(got != 0, kept), "B3 dropout mask differs from the plain version's")
    probed = int((pbias == 0).sum()) * N * H  # (row, key, head) triples in the windows
    gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
    wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
        B, N, 3, H, D)[:, :, 2]
    check(torch.equal(gdv != 0, wdv != 0), "B6 dropout mask differs from the plain version's")
    print(f"  dropout masks equal bit for bit over {probed} (row, key, head) triples, "
          f"in B3's output and B6's dv; kept share {float(kept.sum()) / probed:.4f}")
    extra_times("B3 with dropout 0.1 at the train shape",
                lambda: fa.flash_attention_packed(qkv, H, bias, **drop),
                lambda: fa.flash_attention_packed_reference(qkv, H, bias, **drop),
                4 * B * H * N * N * D,
                (qkv, bias, drop["dropout_seeds"], fa.flash_attention_packed(qkv, H, bias, **drop)),
                sdpa_ms(*heads_of(qkv, H), bias))

    print(f"B6 attention backward: qkv [{B}, {N}, {3 * H * D}], d(out) [{B}, {N}, {H * D}] "
          "bf16, rates 0 and 0.1")
    do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
    for rate in (0.0, 0.1):
        kw = drop if rate else {}
        want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw)
        compare_grads("flash_attention_bwd", fa._kernel_bwd(qkv, do, H, bias, **kw), want,
                      "packed", results, H)
    results["flash_attention_bwd"]["ms"] = cuda_ms(
        lambda: fa._kernel_bwd(qkv, do, H, bias, **drop), iters=10)
    results["flash_attention_bwd"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop), iters=10)
    # five products of 2·N²·D a head: s, dp, dv, dq, dk
    set_bound(results, "flash_attention_bwd", 10 * B * H * N * N * D,
              (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias, **drop)))
    results["flash_attention_bwd"]["library_ms"] = sdpa_ms(
        *heads_of(qkv, H), bias, do.view(B, N, H, D).transpose(1, 2))
    # also P1's shape: its plain version at rate 0
    extra_times("B6 at rate 0 at the train shape", lambda: fa._kernel_bwd(qkv, do, H, bias),
                lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias),
                10 * B * H * N * N * D, (qkv, do, bias, fa._kernel_bwd(qkv, do, H, bias)),
                results["flash_attention_bwd"]["library_ms"])

    R, HID, F = B * N, 768, 3072
    print(f"B8 MLP backward: x, dy [{R}, {HID}] bf16, W1 [{F}, {HID}], W2 [{HID}, {F}]")
    x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
    dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
    w1 = (torch.randn(F, HID, device=dev, generator=g) * 0.02).bfloat16()
    b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(HID, F, device=dev, generator=g) * 0.02).bfloat16()
    got = mlp._kernel_bwd(x, w1, b1, w2, dy)
    want = mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)
    for name, a_, b_ in zip(("dx", "g", "dh"), got, want):
        print(f"  {name}:", end="")
        compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
    # the kernel recomputes h = x·W1ᵀ, then g = dy·W2 and dx = dh·W1
    set_bound(results, "mlp_bwd", 6 * R * HID * F, (x, w1, b1, w2, dy) + tuple(got))
    del got, want
    results["mlp_bwd"]["ms"] = cuda_ms(lambda: mlp._kernel_bwd(x, w1, b1, w2, dy), iters=5)
    results["mlp_bwd"]["plain_ms"] = cuda_ms(
        lambda: mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy), iters=5)
    dh = mlp._kernel_bwd(x, w1, b1, w2, dy)[2]
    products = cuda_ms(lambda: (torch.matmul(x, w1.T), torch.matmul(dy, w2),
                                torch.matmul(dh, w1)), iters=5)
    print(f"  yardstick, never called by the port: B8's three products alone in cuBLAS "
          f"(torch.matmul, bf16: x·W1ᵀ, dy·W2, dh·W1) {products:.4f} ms")
    del dh
    split = kernel_device_ms(lambda: mlp._kernel_bwd(x, w1, b1, w2, dy),
                             ("mlp_bwd_gelu_kernel", "mlp_bwd_dx_kernel"))
    print("  B8's two kernels, device ms a call (torch.profiler): "
          + ", ".join(f"{k} {v}" for k, v in split.items()))
    for name in ("flash_attention_bwd", "mlp_bwd"):
        r = results[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")


def phase2_repairs(mods, dev, seed: int, results: dict) -> None:
    """The widths ROADMAP C1-C3 repaired: B3 and B6 at head dim 128 and
    N = 512 (with padded keys; B6 at rates 0 and 0.1, its dropout mask
    compared bit for bit), B4 and B8 at hidden 256."""
    import torch

    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed + 4)
    B, N, H, D = 2, 512, 2, 128
    print(f"C1/C2: B3 and B6 at (B, N, H, D) = ({B}, {N}, {H}, {D}), padded keys")
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
    lengths = torch.randint(N // 2, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    compare("flash_attention", fa.flash_attention_packed(qkv, H, bias),
            fa.flash_attention_packed_reference(qkv, H, bias), TOL["flash_attention"], results)
    extra_times("C1: B3 at D = 128, N = 512", lambda: fa.flash_attention_packed(qkv, H, bias),
                lambda: fa.flash_attention_packed_reference(qkv, H, bias),
                4 * B * H * N * N * D, (qkv, bias, fa.flash_attention_packed(qkv, H, bias)),
                sdpa_ms(*heads_of(qkv, H), bias))
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    for kw in ({}, drop):
        want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw)
        compare_grads("flash_attention_bwd", fa._kernel_bwd(qkv, do, H, bias, **kw), want,
                      "packed", results, H)
    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
    wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
        B, N, 3, H, D)[:, :, 2]
    check(torch.equal(gdv != 0, wdv != 0), "B6 dropout mask at D = 128 differs")
    print(f"  B6 dropout mask at D = 128 equal bit for bit; kept share "
          f"{float((wdv != 0).sum()) / (int((pbias == 0).sum()) * D * H):.4f}")
    extra_times("C2: B6 at D = 128, N = 512, rate 0.1",
                lambda: fa._kernel_bwd(qkv, do, H, bias, **drop),
                lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop),
                10 * B * H * N * N * D,
                (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias, **drop)),
                sdpa_ms(*heads_of(qkv, H), bias, do.view(B, N, H, D).transpose(1, 2)))

    R, HID, F = 12800, 256, 1024
    print(f"C3: B4 and B8 at hidden {HID}: x, dy [{R}, {HID}] bf16, F = {F}")
    x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
    dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
    w1 = (torch.randn(F, HID, device=dev, generator=g) * HID ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(HID, F, device=dev, generator=g) * F ** -0.5).bfloat16()
    b2 = (torch.randn(HID, device=dev, generator=g) * 0.02).bfloat16()
    compare("mlp", mlp.dense_gelu_dense(x, w1, b1, w2, b2),
            mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), TOL["mlp"], results)
    for a_, b_ in zip(mlp._kernel_bwd(x, w1, b1, w2, dy),
                      mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)):
        compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
    extra_times("C3: B4 at hidden 256", lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2),
                lambda: mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), 4 * R * HID * F,
                (x, w1, b1, w2, b2, mlp.dense_gelu_dense(x, w1, b1, w2, b2)))
    extra_times("C3: B8 at hidden 256", lambda: mlp._kernel_bwd(x, w1, b1, w2, dy),
                lambda: mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy), 6 * R * HID * F,
                (x, w1, b1, w2, dy) + tuple(mlp._kernel_bwd(x, w1, b1, w2, dy)))
    blk = mods["mlp_block"]
    for HID, F in ((1280, 5120), (192, 768)):
        print(f"B4, B8 and B9 past the old width bounds: x, dy [{R}, {HID}] bf16, F = {F}")
        x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
        dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
        w1 = (torch.randn(F, HID, device=dev, generator=g) * HID ** -0.5).bfloat16()
        b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
        w2 = (torch.randn(HID, F, device=dev, generator=g) * F ** -0.5).bfloat16()
        b2 = (torch.randn(HID, device=dev, generator=g) * 0.02).bfloat16()
        got = mlp._kernel_bwd(x, w1, b1, w2, dy)
        for a_, b_ in zip(got, mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)):
            compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
        extra_times(f"B8 at hidden {HID}, F = {F}", lambda: mlp._kernel_bwd(x, w1, b1, w2, dy),
                    lambda: mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy),
                    6 * R * HID * F, (x, w1, b1, w2, dy) + tuple(got))
        del got
        compare("mlp", mlp._kernel(x, w1, b1, w2, b2),
                mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), TOL["mlp"], results)
        extra_times(f"B4 at hidden {HID}, F = {F}", lambda: mlp._kernel(x, w1, b1, w2, b2),
                    lambda: mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2),
                    4 * R * HID * F, (x, w1, b1, w2, b2, mlp._kernel(x, w1, b1, w2, b2)))
        mlp_fwd_yardstick(f"B4 at hidden {HID}", lambda: mlp._kernel(x, w1, b1, w2, b2),
                          x, w1, w2)
        # B9 through its wrapper's kernel entry: the public function keeps
        # JAX's rule (multiples of 128), which 192 breaks
        ls = 1.0 + 0.1 * torch.randn(HID, device=dev, generator=g)
        lb, fb2 = (0.1 * torch.randn(HID, device=dev, generator=g) for _ in range(2))
        fb1 = 0.1 * torch.randn(F, device=dev, generator=g)
        args = (x, ls, lb, w1, fb1, w2, fb2)
        for approximate in (False, True):
            kw = dict(eps=1e-6, gelu_approximate=approximate)
            want = blk.fused_mlp_block_reference(*args, **kw).float() - x.float()
            compare("mlp_block", blk._kernel(*args, **kw).float() - x.float(), want,
                    TOL["mlp_block_rel"] * float(want.abs().max()), results)
        del want
        kw = dict(eps=1e-6, gelu_approximate=False)
        extra_times(f"B9 at hidden {HID}, F = {F}", lambda: blk._kernel(*args, **kw),
                    lambda: blk.fused_mlp_block_reference(*args, **kw), 4 * R * HID * F,
                    args + (blk._kernel(*args, **kw),))
        mlp_fwd_yardstick(f"B9 at hidden {HID}", lambda: blk._kernel(*args, **kw), x, w1, w2)


def phase2_limits(mods, dev, seed: int, results: dict) -> None:
    """The limits ROADMAP C4-C6 lifted: head dims 32, 96, 160, 256 and 320
    in B3/B5/B6/B7 (held to the plain versions, B5/B7 bit-equal to B3/B6 in
    both layouts, over 128 the dropout masks bit for bit, timed beside
    SDPA), B1 at any width with 200 prompts, and a batch of 65537 through
    B2, B3 and B6."""
    import torch

    fa, sim, prep = mods["flash_attention"], mods["similarity"], mods["image_prep"]
    g = torch.Generator(dev).manual_seed(seed + 8)

    def inputs(B, N, H, D):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
        do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
        lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        return qkv, do, bias, dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))

    B, N = TRAIN_BATCH, TRAIN_LEN
    for D, H, how in ((32, 24, "built"), (96, 8, "zero-padded to 128 by the wrappers"),
                      (160, 8, "zero-padded to 192, in 64-column slices"),
                      (256, 6, "in 64-column slices"), (320, 6, "in 64-column slices")):
        print(f"C4: B3/B5/B6/B7 at head dim {D} ({how}): (B, N, H, D) = {(B, N, H, D)}, "
              "padded keys, rates 0 and 0.1")
        qkv, do, bias, drop = inputs(B, N, H, D)
        for kw in ({}, drop):
            out = fa.flash_attention_packed(qkv, H, bias, **kw)
            compare("flash_attention", out, fa.flash_attention_packed_reference(
                qkv, H, bias, **kw), TOL["flash_attention"], results)
            dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
            compare_grads("flash_attention_bwd", dqkv, fa.flash_attention_packed_bwd_reference(
                qkv, do, H, bias, **kw), "packed", results, H)
            for layout in ("bnhd", "bhnd"):
                q, k, v = split_operands(qkv, H, layout)
                dos = as_bnhd(do.view(B, N, H, D), layout).contiguous()
                split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
                compare("flash_attention_split", split, head_major(fa.flash_attention_reference(
                    *(head_major(t, layout) for t in (q, k, v)), bias, **kw), layout),
                    TOL["flash_attention"], results)
                check(torch.equal(as_bnhd(split, layout).reshape(B, N, H * D), out),
                      f"B5 ({layout}) differs from B3 at D = {D}")
                grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
                for i, (a_, b_) in enumerate(zip(grads, fa.flash_attention_bwd_reference(
                        *(head_major(t, layout) for t in (q, k, v, dos)), bias, **kw))):
                    compare_grads("flash_attention_split_bwd", a_, head_major(b_, layout),
                                  layout, results)
                    check(torch.equal(as_bnhd(a_, layout), dqkv.view(B, N, 3, H, D)[:, :, i]),
                          f"B7 ({layout}) differs from B6 at D = {D}")
        print(f"  B5 and B7 bit-equal to B3 and B6 at D = {D}, both layouts, rates 0 and 0.1")
        if D > 128:  # every slice draws the same mask
            pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
            want = fa.flash_attention_packed_reference(pq, H, pbias, **drop)
            check(torch.equal(fa.flash_attention_packed(pq, H, pbias, **drop) != 0, want != 0),
                  f"B3 dropout mask at D = {D} differs from the plain version's")
            gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
            wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
                B, N, 3, H, D)[:, :, 2]
            check(torch.equal(gdv != 0, wdv != 0),
                  f"B6 dropout mask at D = {D} differs from the plain version's")
            print(f"  dropout masks at D = {D} equal bit for bit in B3's output and B6's dv; "
                  f"kept share {float((want != 0).sum()) / (int((pbias == 0).sum()) * N * H):.4f}")
            del pq, pdo, want, gdv, wdv
        heads = heads_of(qkv, H)
        extra_times(f"C4: B3 at D = {D}, rate 0.1",
                    lambda: fa.flash_attention_packed(qkv, H, bias, **drop),
                    lambda: fa.flash_attention_packed_reference(qkv, H, bias, **drop),
                    4 * B * H * N * N * D,
                    (qkv, bias, drop["dropout_seeds"], fa.flash_attention_packed(qkv, H, bias)),
                    sdpa_ms(*heads, bias))
        extra_times(f"C4: B6 at D = {D}, rate 0.1",
                    lambda: fa._kernel_bwd(qkv, do, H, bias, **drop),
                    lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop),
                    10 * B * H * N * N * D,
                    (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias)),
                    sdpa_ms(*heads, bias, do.view(B, N, H, D).transpose(1, 2)))
        del qkv, do, heads

    for D in (64, 96):
        print(f"C5: B1 at D = {D}: img [{BATCH}, {D}] x txt [200, {D}] fp32, T = 0.5")
        img = torch.randn(BATCH, D, device=dev, generator=g)
        img[-1] = 0.0
        txt = torch.randn(200, D, device=dev, generator=g)
        compare("similarity", sim.similarity(img, txt, 0.5),
                sim.similarity_reference(img, txt, 0.5), TOL["similarity"], results)
        extra_times(f"C5: B1 at D = {D}, C = 200", lambda: sim.similarity(img, txt, 0.5),
                    lambda: sim.similarity_reference(img, txt, 0.5),
                    2 * BATCH * 200 * D + 3 * (BATCH + 200) * D,
                    (img, txt, sim.similarity(img, txt, 0.5)), peak="fp32")

    B = 65537
    print(f"C6: a batch of {B}: B2 [{B}, 12, 10, 1] uint8 -> [{B}, 8, 8, 3] bf16; B3 and B6 at "
          f"(B, N, H, D) = ({B}, 5, 2, 32), rate 0.1")
    imgs = torch.randint(0, 256, (B, 12, 10, 1), device=dev, generator=g, dtype=torch.uint8)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    compare("image_prep", prep.preprocess_images(imgs, 8, 8, mean, std),
            prep.preprocess_reference(imgs, 8, 8, mean, std), TOL["image_prep"], results)
    qkv, do, bias, drop = inputs(B, 5, 2, 32)
    compare("flash_attention", fa.flash_attention_packed(qkv, 2, bias, **drop),
            fa.flash_attention_packed_reference(qkv, 2, bias, **drop), TOL["flash_attention"],
            results)
    compare_grads("flash_attention_bwd", fa._kernel_bwd(qkv, do, 2, bias, **drop),
                  fa.flash_attention_packed_bwd_reference(qkv, do, 2, bias, **drop), "packed",
                  results, 2)


def split_operands(qkv, H: int, layout: str):
    """q, k, v of a packed qkv in ``layout``: "bnhd" views of its column
    blocks, or "bhnd" head-major contiguous copies."""
    B, N, _ = qkv.shape
    q, k, v = qkv.view(B, N, 3, H, -1).unbind(2)
    if layout == "bhnd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return q, k, v


def as_bnhd(t, layout: str):
    return t if layout == "bnhd" else t.transpose(1, 2)


def head_major(t, layout: str):
    """A split operand as [B, H, N, D] for the plain versions, and their
    [B, H, N, D] results back in ``layout``."""
    return t if layout == "bhnd" else t.transpose(1, 2)


def phase2_split(_build, mods, dev, seed: int, results: dict) -> dict:
    """B5 and B7 (the split form) against their plain versions and bit-equal
    to B3 and B6, then the split entry point's main path and the layout
    probe P1; returns the launches of both paths."""
    import torch

    from clip_for_dl_tpu_torch.tools import probe_bwd_layouts

    fa = mods["flash_attention"]
    g = torch.Generator(dev).manual_seed(seed + 6)

    def check_shape(B, N, H, D, min_len):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
        do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
        lengths = torch.randint(min_len, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
        for layout in ("bnhd", "bhnd"):
            q, k, v = split_operands(qkv, H, layout)
            dos = as_bnhd(do.view(B, N, H, D), layout).contiguous()
            for kw in ({}, drop):
                out = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
                want = fa.flash_attention_reference(
                    *(head_major(t, layout) for t in (q, k, v)), bias, **kw)
                compare("flash_attention_split", out, head_major(want, layout),
                        TOL["flash_attention"], results)
                check(torch.equal(as_bnhd(out, layout).reshape(B, N, H * D),
                                  fa.flash_attention_packed(qkv, H, bias, **kw)),
                      f"B5 ({layout}) differs from B3 on the same heads")
                grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
                plain = fa.flash_attention_bwd_reference(
                    *(head_major(t, layout) for t in (q, k, v, dos)), bias, **kw)
                packed = fa._kernel_bwd(qkv, do, H, bias, **kw).view(B, N, 3, H, D)
                for i, (a_, b_) in enumerate(zip(grads, plain)):
                    compare_grads("flash_attention_split_bwd", a_, head_major(b_, layout),
                                  layout, results)
                    check(torch.equal(as_bnhd(a_, layout), packed[:, :, i]),
                          f"B7 ({layout}) differs from B6 on the same heads")
        print(f"  B5 and B7 bit-equal to B3 and B6 at {(B, N, H, D)}, both layouts, "
              "rates 0 and 0.1")
        return qkv, do, bias, drop

    B, N, H, D = TRAIN_BATCH, TRAIN_LEN, 12, 64
    print(f"B5/B7 split attention: (B, N, H, D) = {(B, N, H, D)} bf16, padded keys, "
          "layouts bnhd and bhnd, rates 0 and 0.1")
    qkv, do, bias, drop = check_shape(B, N, H, D, 3)

    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    for layout in ("bnhd", "bhnd"):
        q, k, v = split_operands(pq, H, layout)
        dos = as_bnhd(pdo.view(B, N, H, D), layout).contiguous()
        out = as_bnhd(fa.flash_attention(q, k, v, pbias, layout=layout, **drop), layout)
        want = fa.flash_attention_packed_reference(pq, H, pbias, **drop).view(B, N, H, D)
        check(torch.equal(out != 0, want != 0), f"B5 ({layout}) dropout mask differs")
        dv = as_bnhd(fa.flash_attention_bwd(q, k, v, dos, pbias, layout=layout, **drop)[2],
                     layout)
        wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
            B, N, 3, H, D)[:, :, 2]
        check(torch.equal(dv != 0, wdv != 0), f"B7 ({layout}) dropout mask differs")
    print("  B5 and B7 dropout masks equal bit for bit in both layouts")

    q, k, v = split_operands(qkv, H, "bnhd")
    dos = do.view(B, N, H, D)
    out = fa.flash_attention(q, k, v, bias, layout="bnhd", **drop)
    grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop)
    for name, kernel, plain, flops, io in (
        ("flash_attention_split",
         lambda: fa.flash_attention(q, k, v, bias, layout="bnhd", **drop),
         lambda: fa.flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)), bias,
                                              **drop),
         4 * B * H * N * N * D, (q, k, v, bias, drop["dropout_seeds"], out)),
        ("flash_attention_split_bwd",
         lambda: fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop),
         lambda: fa.flash_attention_bwd_reference(
             *(t.transpose(1, 2) for t in (q, k, v, dos)), bias, **drop),
         10 * B * H * N * N * D, (q, k, v, dos, bias, drop["dropout_seeds"]) + tuple(grads)),
    ):
        results[name]["ms"] = cuda_ms(kernel, iters=10)
        results[name]["plain_ms"] = cuda_ms(plain, iters=10)
        set_bound(results, name, flops, io)
        print(f"  {name} (bnhd, rate 0.1): kernel {results[name]['ms']:.4f} ms  "
              f"plain {results[name]['plain_ms']:.4f} ms")
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    results["flash_attention_split"]["library_ms"] = sdpa_ms(*heads, bias)
    results["flash_attention_split_bwd"]["library_ms"] = sdpa_ms(*heads, bias,
                                                                 dos.transpose(1, 2))
    qh, kh, vh = split_operands(qkv, H, "bhnd")
    doh = dos.transpose(1, 2).contiguous()
    fwd_io = (qh, kh, vh, bias, drop["dropout_seeds"], out)
    bwd_io = (qh, kh, vh, doh, bias, drop["dropout_seeds"]) + tuple(grads)
    extra_times("B5 (bhnd, rate 0.1)",
                lambda: fa.flash_attention(qh, kh, vh, bias, layout="bhnd", **drop),
                lambda: fa.flash_attention_reference(qh, kh, vh, bias, **drop),
                4 * B * H * N * N * D, fwd_io, results["flash_attention_split"]["library_ms"])
    extra_times("B7 (bhnd, rate 0.1)",
                lambda: fa.flash_attention_bwd(qh, kh, vh, doh, bias, layout="bhnd", **drop),
                lambda: fa.flash_attention_bwd_reference(qh, kh, vh, doh, bias, **drop),
                10 * B * H * N * N * D, bwd_io, results["flash_attention_split_bwd"]["library_ms"])
    extra_times("B7 (bnhd, rate 0)",
                lambda: fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd"),
                lambda: fa.flash_attention_bwd_reference(
                    *(t.transpose(1, 2) for t in (q, k, v, dos)), bias),
                10 * B * H * N * N * D, (q, k, v, dos, bias) + tuple(grads),
                results["flash_attention_split_bwd"]["library_ms"])
    del qkv, do, pq, pdo, grads, out

    print("B5/B7 at (B, N, H, D) = (2, 512, 2, 128), padded keys")
    check_shape(2, 512, 2, 128, 256)

    by_path = {}
    # -- the split entry point with autograd, counted ------------------------
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    ct = torch.randn(B, N, H, D, device=dev, generator=g).bfloat16()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    for layout in ("bnhd", "bhnd"):
        xs = [t.detach().clone().requires_grad_() for t in split_operands(qkv, H, layout)]
        out = fa.flash_attention(*xs, bias, layout=layout, **drop)
        out.backward(as_bnhd(ct, layout))
        check(all(torch.isfinite(x.grad.float()).all() for x in xs),
              f"non-finite split gradients ({layout})")
    torch.cuda.synchronize(dev)
    by_path["split_attention"] = dict(_build.LAUNCHES)
    print(f"launches on the split_attention path: {by_path['split_attention']}")
    check_launched(mods, by_path["split_attention"], "split_attention")

    # -- the layout probe P1, counted ----------------------------------------
    print("P1 layout probe (tools/probe_bwd_layouts.py, dropout off):")
    _build.reset_launches()
    code = probe_bwd_layouts.main(["--batch", str(B), "--seq", str(N), "--heads", str(H),
                                   "--dim", str(D), "--iters", "30"])
    torch.cuda.synchronize(dev)
    by_path["layout_probe"] = dict(_build.LAUNCHES)
    check(code == 0, "the layout probe found a MISMATCH between B6 and B7's layouts")
    print(f"launches on the layout_probe path: {by_path['layout_probe']}")
    check_launched(mods, by_path["layout_probe"], "layout_probe")
    return by_path

def typed_grads(name, got, want, layout, dtype, results, heads=None):
    """compare_grads at ``dtype``'s per-slice rule (fa.GRAD_TOL)."""
    import torch

    from clip_for_dl_tpu_torch.ops.flash_attention import grad_slice_error

    check(got.dtype == dtype, f"{name}: {got.dtype}, not {dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    max_abs, worst = grad_slice_error(got, want, layout, heads, dtype)
    print(f"  {name}: max_abs {max_abs:.3e}  worst (batch row, head) slice at {worst:.3f} "
          "of its tolerance")
    check(worst <= 1.0, f"{name}: a slice is off by {worst} of its tolerance")
    results.setdefault(name, {})["max_abs_err"] = max(
        max_abs, results.get(name, {}).get("max_abs_err", 0.0))


def phase2_types(mods, dev, seed: int, results: dict) -> None:
    """ROADMAP C7: the fp32 and fp16 instances of B3, B5, B6 and B7 against
    their plain versions (the plain fp32 products in full fp32) at rates 0
    and 0.1 and head dims 32, 64, 128 and 160 (N = 200, padded keys), and
    at N = 512; B5/B7 bit-equal to B3/B6 in both layouts; the dropout masks
    bit for bit; then each instance's times at its main shape beside SDPA
    in its type."""
    import torch

    fa = mods["flash_attention"]
    g = torch.Generator(dev).manual_seed(seed + 9)
    torch.backends.cuda.matmul.allow_tf32 = False

    def inputs(B, N, H, D, dt, min_len=3):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).to(dt)
        do = torch.randn(B, N, H * D, device=dev, generator=g).to(dt)
        lengths = torch.randint(min_len, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        return qkv, do, bias, dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))

    for tag, dt in (("fp32", torch.float32), ("fp16", torch.float16)):
        fwd, bwd = f"flash_attention_{tag}", f"flash_attention_bwd_{tag}"
        sfwd, sbwd = f"flash_attention_split_{tag}", f"flash_attention_split_bwd_{tag}"
        for B, N, H, D in ((4, 200, 4, 32), (4, 200, 4, 64), (4, 200, 4, 128), (4, 200, 4, 160),
                           (2, 512, 2, 64)):
            print(f"C7: B3/B5/B6/B7 in {tag} at (B, N, H, D) = {(B, N, H, D)}, padded keys, "
                  "rates 0 and 0.1")
            qkv, do, bias, drop = inputs(B, N, H, D, dt)
            for kw in ({}, drop):
                out = fa.flash_attention_packed(qkv, H, bias, **kw)
                want = fa.flash_attention_packed_reference(qkv, H, bias, **kw)
                check(out.dtype == dt, f"B3 {tag} wrote {out.dtype}")
                compare(fwd, out, want, fa.fwd_tolerance(want), results)
                dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
                typed_grads(bwd, dqkv, fa.flash_attention_packed_bwd_reference(
                    qkv, do, H, bias, **kw), "packed", dt, results, H)
                for layout in ("bnhd", "bhnd"):
                    q, k, v = split_operands(qkv, H, layout)
                    dos = as_bnhd(do.view(B, N, H, D), layout).contiguous()
                    split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
                    want = head_major(fa.flash_attention_reference(
                        *(head_major(t, layout) for t in (q, k, v)), bias, **kw), layout)
                    compare(sfwd, split, want, fa.fwd_tolerance(want), results)
                    check(torch.equal(as_bnhd(split, layout).reshape(B, N, H * D), out),
                          f"B5 {tag} ({layout}) differs from B3 at {(B, N, H, D)}")
                    grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
                    plain = fa.flash_attention_bwd_reference(
                        *(head_major(t, layout) for t in (q, k, v, dos)), bias, **kw)
                    for i, (a_, b_) in enumerate(zip(grads, plain)):
                        typed_grads(sbwd, a_, head_major(b_, layout), layout, dt, results)
                        check(torch.equal(as_bnhd(a_, layout), dqkv.view(B, N, 3, H, D)[:, :, i]),
                              f"B7 {tag} ({layout}) differs from B6 at {(B, N, H, D)}")
            print(f"  B5 and B7 bit-equal to B3 and B6 in {tag}, both layouts, rates 0 and 0.1")
            if N == 200 and D in (64, 160):
                pq, pdo, pbias = (t.to(dt) if t.is_floating_point() and t.dim() == 3 else t
                                  for t in dropout_probe(B, N, H, D, dev))
                want = fa.flash_attention_packed_reference(pq, H, pbias, **drop)
                check(torch.equal(fa.flash_attention_packed(pq, H, pbias, **drop) != 0, want != 0),
                      f"B3 {tag} dropout mask at D = {D} differs from the plain version's")
                gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
                wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
                    B, N, 3, H, D)[:, :, 2]
                check(torch.equal(gdv != 0, wdv != 0),
                      f"B6 {tag} dropout mask at D = {D} differs from the plain version's")
                q, k, v = split_operands(pq, H, "bnhd")
                sp = fa.flash_attention(q, k, v, pbias, layout="bnhd", **drop)
                check(torch.equal(sp.reshape(want.shape) != 0, want != 0),
                      f"B5 {tag} dropout mask at D = {D} differs")
                print(f"  dropout masks in {tag} at D = {D} equal bit for bit in B3's and B5's "
                      f"output and B6's dv; kept share "
                      f"{float((want != 0).sum()) / (int((pbias == 0).sum()) * N * H):.4f}")

        # the main shapes: fp32 the parity mode's prompt bank and its
        # phase-A batch (16); fp16 those of bf16's rows
        peak = tag
        fB, bB = (64, 16) if tag == "fp32" else (64, TRAIN_BATCH)
        N, H, D = TRAIN_LEN, 12, 64
        qkv, _, bias, _ = inputs(fB, N, H, D, dt)
        results[fwd]["ms"] = cuda_ms(lambda: fa.flash_attention_packed(qkv, H, bias), iters=10)
        results[fwd]["plain_ms"] = cuda_ms(
            lambda: fa.flash_attention_packed_reference(qkv, H, bias), iters=10)
        set_bound(results, fwd, 4 * fB * H * N * N * D,
                  (qkv, bias, fa.flash_attention_packed(qkv, H, bias)), peak)
        results[fwd]["library_ms"] = sdpa_ms(*heads_of(qkv, H), bias)
        qkv, do, bias, drop = inputs(bB, N, H, D, dt)
        results[bwd]["ms"] = cuda_ms(lambda: fa._kernel_bwd(qkv, do, H, bias, **drop), iters=5)
        results[bwd]["plain_ms"] = cuda_ms(
            lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop), iters=5)
        set_bound(results, bwd, 10 * bB * H * N * N * D,
                  (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias, **drop)),
                  peak)
        heads = heads_of(qkv, H)
        results[bwd]["library_ms"] = sdpa_ms(*heads, bias, do.view(bB, N, H, D).transpose(1, 2))
        q, k, v = split_operands(qkv, H, "bnhd")
        dos = do.view(bB, N, H, D)
        out = fa.flash_attention(q, k, v, bias, layout="bnhd", **drop)
        grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop)
        for name, kernel, plain, flops, io in (
            (sfwd, lambda: fa.flash_attention(q, k, v, bias, layout="bnhd", **drop),
             lambda: fa.flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)), bias,
                                                  **drop),
             4 * bB * H * N * N * D, (q, k, v, bias, drop["dropout_seeds"], out)),
            (sbwd, lambda: fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop),
             lambda: fa.flash_attention_bwd_reference(
                 *(t.transpose(1, 2) for t in (q, k, v, dos)), bias, **drop),
             10 * bB * H * N * N * D, (q, k, v, dos, bias, drop["dropout_seeds"]) + tuple(grads)),
        ):
            results[name]["ms"] = cuda_ms(kernel, iters=5)
            results[name]["plain_ms"] = cuda_ms(plain, iters=5)
            set_bound(results, name, flops, io, peak)
        results[sfwd]["library_ms"] = sdpa_ms(*heads, bias)
        results[sbwd]["library_ms"] = results[bwd]["library_ms"]
        for name in (fwd, bwd, sfwd, sbwd):
            r = results[name]
            print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                  f"bound {r['bound_ms']:.4f} ms  SDPA {r['library_ms']:.4f} ms")
        del qkv, do, q, k, v, dos, out, grads, heads


def direct_equals_staged(prep, dev, g) -> None:
    """The direct body gives the staged body's bits where both run: both C
    entries on the same uint8 and fp32 images, each output type."""
    import torch

    from clip_for_dl_tpu_torch.ops import _build

    for src, staged in ((torch.uint8, prep.KERNEL), (torch.float32, prep.KERNEL_F32SRC)):
        for shape in ((2, 333, 97, 3), (3, 512, 512, 1)):
            imgs = (torch.randint(0, 256, shape, device=dev, generator=g, dtype=torch.uint8)
                    if src == torch.uint8 else torch.rand(shape, device=dev, generator=g))
            B, H, W, C = shape
            ty, tx = prep._device_taps(H, 224, dev), prep._device_taps(W, 224, dev)
            scale, bias = prep._device_scale_bias(
                (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711),
                1 / 255 if src == torch.uint8 else 1.0, dev)
            for out_t in (torch.float32, torch.bfloat16, torch.float16):
                outs = [torch.empty(B, 224, 224, 3, dtype=out_t, device=dev) for _ in range(2)]
                for o, entry, extra in ((outs[0], staged, ()),
                                        (outs[1], prep.KERNEL_DIRECT,
                                         (int(src != torch.uint8),))):
                    _build.launch(entry, dev, imgs.data_ptr(), *(t.data_ptr() for t in ty + tx),
                                  scale.data_ptr(), bias.data_ptr(), o.data_ptr(), B, H, W, C,
                                  224, 224, 3, prep.OUT_TYPES[out_t], *extra)
                check(torch.equal(outs[0], outs[1]),
                      f"B2's direct body differs from the staged body at {shape} {src} -> {out_t}")
    print("  B2's direct body bit-equal to the staged body (uint8 and fp32 sources, fp32, bf16 "
          "and fp16 outputs)")


def phase2_c8(_build, mods, dev, seed: int, results: dict) -> dict:
    """ROADMAP C8: B1 on bf16, fp16 and mixed features; B2 on fp32 and bf16
    images, writing fp16 and fp64, on rows too wide to stage (the direct
    body, bit-equal to the staged one where both run), and on views; each
    against its plain version, timed at the serving shapes; then the
    c8_cases path (the public functions on those inputs), counted."""
    import torch

    sim, prep = mods["similarity"], mods["image_prep"]
    g = torch.Generator(dev).manual_seed(seed + 10)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    cos = torch.nn.functional.cosine_similarity

    print(f"C8: B1 on bf16 and fp16 features: img [{BATCH}, 512] x txt [16, 512], T = 0.5")
    img32 = torch.randn(BATCH, 512, device=dev, generator=g)
    img32[-1] = 0.0
    txt32 = torch.randn(16, 512, device=dev, generator=g)
    for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
        name = f"similarity_{tag}"
        img, txt = img32.to(dt), txt32.to(dt)
        compare(name, sim.similarity(img, txt, 0.5), sim.similarity_reference(img, txt, 0.5),
                TOL["similarity"], results)
        for a, b in ((img32, txt), (img, txt32)):  # each side on its own
            compare(name, sim.similarity(a, b, 0.5), sim.similarity_reference(a, b, 0.5),
                    TOL["similarity"], results)
        r = results[name]
        r["ms"] = cuda_ms(lambda: sim.similarity(img, txt, 0.5))
        r["plain_ms"] = cuda_ms(lambda: sim.similarity_reference(img, txt, 0.5))
        r["library_ms"] = cuda_ms(lambda: cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5)
        set_bound(results, name, 2 * BATCH * 16 * 512 + 3 * (BATCH + 16) * 512,
                  (img, txt, sim.similarity(img, txt, 0.5)), "fp32")
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"F.cosine_similarity in {tag} {r['library_ms']:.4f} ms; device ms a call "
              f"(torch.profiler) "
              f"{kernel_device_ms(lambda: sim.similarity(img, txt, 0.5), ('similarity',))}")
    views = (img32.T.contiguous().T, txt32[:, ::1].T.contiguous().T)
    check(not views[0].is_contiguous(), "the B1 view case is contiguous")
    compare("similarity", sim.similarity(*views, 0.5), sim.similarity_reference(*views, 0.5),
            TOL["similarity"], results)
    print("  B1 on transposed (non-contiguous) views: copied, matches")

    print(f"C8: B2 on fp32 and bf16 images [{BATCH}, 512, 512, 1] in [0, 1] -> bf16 and fp32; "
          "fp16 output of the uint8 batch; rows too wide to stage; views")
    grey = torch.randint(0, 256, (BATCH, 512, 512, 1), device=dev, generator=g,
                         dtype=torch.uint8)
    fimgs = torch.rand(BATCH, 512, 512, 1, device=dev, generator=g)
    for imgs in (fimgs, fimgs.bfloat16()):
        compare("image_prep_f32src", prep.preprocess_images(imgs, 224, 224, mean, std),
                prep.preprocess_reference(imgs, 224, 224, mean, std), TOL["image_prep"],
                results)
        compare("image_prep_f32src",
                prep.preprocess_images(imgs, 224, 224, mean, std, torch.float32),
                prep.preprocess_reference(imgs, 224, 224, mean, std, torch.float32),
                TOL["image_prep_f32"], results)
    r = results["image_prep_f32src"]
    r["ms"] = cuda_ms(lambda: prep.preprocess_images(fimgs, 224, 224, mean, std))
    r["plain_ms"] = cuda_ms(lambda: prep.preprocess_reference(fimgs, 224, 224, mean, std))
    out = prep.preprocess_images(fimgs, 224, 224, mean, std)
    set_bound(results, "image_prep_f32src", 10 * out.numel(), (fimgs, out), "fp32")
    prep_yardstick(prep, fimgs, out, mean, std, r["ms"])
    for imgs in (grey, fimgs):
        compare("image_prep_fp16",
                prep.preprocess_images(imgs, 224, 224, mean, std, torch.float16),
                prep.preprocess_reference(imgs, 224, 224, mean, std, torch.float16),
                TOL["image_prep_f16"], results)
    wide64 = prep.preprocess_images(grey[:8], 224, 224, mean, std, torch.float64)
    check(wide64.dtype == torch.float64 and torch.equal(
        wide64, prep.preprocess_images(grey[:8], 224, 224, mean, std, torch.float32).double()),
        "B2's fp64 output is not its fp32 output cast")
    r = results["image_prep_fp16"]
    r["ms"] = cuda_ms(lambda: prep.preprocess_images(grey, 224, 224, mean, std, torch.float16))
    r["plain_ms"] = cuda_ms(
        lambda: prep.preprocess_reference(grey, 224, 224, mean, std, torch.float16))
    out = prep.preprocess_images(grey, 224, 224, mean, std, torch.float16)
    set_bound(results, "image_prep_fp16", 10 * out.numel(), (grey, out), "fp32")
    del fimgs, out

    # a row pair past shared memory at one output column: 30000 uint8
    # channels (60 KB), and 8000 fp32 ones (64 KB)
    wstats = tuple(0.1 + 0.8 * (i % 7) / 7 for i in range(30000))
    wstd = tuple(0.2 + 0.1 * (i % 3) for i in range(30000))
    wide = torch.randint(0, 256, (4, 12, 10, 30000), device=dev, generator=g, dtype=torch.uint8)
    wide32 = torch.rand(4, 12, 10, 8000, device=dev, generator=g)
    check(prep.needs_direct(10, 6, 30000, 1) and prep.needs_direct(10, 6, 8000, 4),
          "the wide rows would be staged")
    for imgs, c in ((wide, 30000), (wide32, 8000)):
        for out_t, tol in ((torch.bfloat16, TOL["image_prep"]),
                           (torch.float32, TOL["image_prep_f32"])):
            compare("image_prep_direct",
                    prep.preprocess_images(imgs, 6, 6, wstats[:c], wstd[:c], out_t),
                    prep.preprocess_reference(imgs, 6, 6, wstats[:c], wstd[:c], out_t), tol,
                    results)
    r = results["image_prep_direct"]
    print("  B2's direct body at [4, 12, 10, 30000] uint8 -> [4, 6, 6, 30000] bf16, device ms a "
          "call (torch.profiler) " + str(kernel_device_ms(
              lambda: prep.preprocess_images(wide, 6, 6, wstats, wstd), ("image_prep",))))
    r["ms"] = cuda_ms(lambda: prep.preprocess_images(wide, 6, 6, wstats, wstd))
    r["plain_ms"] = cuda_ms(lambda: prep.preprocess_reference(wide, 6, 6, wstats, wstd))
    out = prep.preprocess_images(wide, 6, 6, wstats, wstd)
    set_bound(results, "image_prep_direct", 10 * out.numel(), (wide, out), "fp32")
    direct_equals_staged(prep, dev, g)
    crop = grey[:16, 20:500, 10:490]
    perm = torch.rand(8, 3, 240, 200, device=dev, generator=g).permute(0, 2, 3, 1)
    for imgs in (crop, perm):
        check(not imgs.is_contiguous(), "the B2 view case is contiguous")
        compare("image_prep", prep.preprocess_images(imgs, 224, 224, mean, std),
                prep.preprocess_reference(imgs, 224, 224, mean, std), TOL["image_prep"],
                results)
    print("  B2 on a cropped uint8 view and a permuted fp32 NCHW tensor: copied, matches")
    for name in ("image_prep_f32src", "image_prep_fp16", "image_prep_direct"):
        r = results[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms")

    # -- the c8_cases path: the public functions on those inputs, counted ----
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    for dt in (torch.bfloat16, torch.float16):
        sim.similarity(img32.to(dt), txt32.to(dt), 0.5)
    prep.preprocess_images(grey[:8].float() / 255.0, 224, 224, mean, std)
    prep.preprocess_images(grey[:8], 224, 224, mean, std, torch.float16)
    prep.preprocess_images(wide, 6, 6, wstats, wstd)
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    print(f"launches on the c8_cases path: {launches}")
    check_launched(mods, launches, "c8_cases")
    return launches


def typed_attention_path(_build, mods, dev, seed: int) -> dict:
    """The attention entry points with autograd in the types no preset runs:
    packed and split (both layouts) in fp16, split in fp32; counted."""
    import torch

    fa = mods["flash_attention"]
    g = torch.Generator(dev).manual_seed(seed + 11)
    B, N, H, D = 16, TRAIN_LEN, 12, 64
    lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    for dt in (torch.float16, torch.float32):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).to(dt)
        ct = torch.randn(B, N, H, D, device=dev, generator=g).to(dt)
        if dt == torch.float16:
            x = qkv.clone().requires_grad_()
            fa.flash_attention_packed(x, H, bias, **drop).backward(ct.reshape(B, N, H * D))
            check(bool(torch.isfinite(x.grad.float()).all()), "non-finite fp16 packed gradient")
        for layout in ("bnhd", "bhnd"):
            xs = [t.detach().clone().requires_grad_() for t in split_operands(qkv, H, layout)]
            fa.flash_attention(*xs, bias, layout=layout, **drop).backward(as_bnhd(ct, layout))
            check(all(torch.isfinite(t.grad.float()).all() for t in xs),
                  f"non-finite {dt} split gradients ({layout})")
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    print(f"launches on the typed_attention path: {launches}")
    check_launched(mods, launches, "typed_attention")
    return launches


def serve_fp32_phase(_build, mods, dev, seed: int, card: str) -> dict:
    """The parity mode's zero-shot path (--fp32 --flash-attention): the
    zero_shot model in fp32 with flash attention encodes the prompt bank and
    scores a batch through the fp32 attention kernels, held against the
    same model on the plain route (B2 kept, so the images are the same)."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        cfg, engine = build_engine(dev, seed, "serve_fp32")
        print(f"model: {describe(cfg)}; fp32 weights and compute, flash attention; built in "
              f"{time.perf_counter() - t0:.1f} s")
        prompts = prompts_for_family("prediction", DISEASE_LABELS)
        images = grey_images(np.random.default_rng(seed + 12), BATCH)
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t = time.perf_counter()
        engine.build_text_features(prompts)
        probs = engine.probs(images)
        torch.cuda.synchronize(dev)
        launches = dict(_build.LAUNCHES)
        print(f"  prompt bank and a batch of {BATCH} in {time.perf_counter() - t:.2f} s on "
              f"{card}; launches {launches}")
        check(probs.shape == (BATCH, 16) and bool(np.isfinite(probs).all()),
              "fp32 probabilities")
        check_launched(mods, launches, "serve_fp32")
        with plain_kernels(mods, keep=("image_prep",)):
            before = dict(_build.LAUNCHES)
            plain = ZeroShotEngine(engine.model, engine.tokenizer, engine.disease_list,
                                   engine.config, engine.mean, engine.std, engine.image_size,
                                   engine.max_text_length, engine.compute_dtype)
            plain.build_text_features(prompts)
            plain_probs = plain.probs(images)
            check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL),
                  "a kernel other than B2 ran during the plain run")
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    feat_err = float((engine.text_features - plain.text_features).abs().max())
    probs_err = float(np.abs(probs - plain_probs).max())
    print(f"  kernels vs plain route in fp32: text features max_abs {feat_err:.3e} (tol "
          f"{TOL['fp32_features']:.0e}); probs max_abs {probs_err:.3e} (tol "
          f"{TOL['fp32_probs']:.0e}); probs std over images {float(probs.std(0).mean()):.3e}")
    check(feat_err <= TOL["fp32_features"], "fp32 text features differ from the plain route")
    check(probs_err <= TOL["fp32_probs"], "fp32 probabilities differ from the plain route")
    return launches


def train_fp32_phase(_build, mods, dev, seed: int) -> dict:
    """One phase-A step of pretrain_clip in fp32 with flash attention at the
    preset's own batch (16), dropout 0, against the same step on the plain
    route from the same weights: the loss within 1e-5 relative, each
    parameter group's gradient cosine ≥ 0.9999."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    preset, cfg, model = train_model(dev, seed, "pretrain_clip", torch.float32)
    B = preset.data.batch_size
    groups = [g.name for g in preset.train.groups]
    label_fn = make_label_fn(groups)
    batch = train_batch(np.random.default_rng(seed + 13), tokenizer(), dev, B, TRAIN_LEN)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step():
        model.load_state_dict(init)
        opt, step = pretrain_step(model, preset, cfg, torch.float32)
        loss = float(step(TrainState(model, opt), batch, base_lrs(preset))[1]["loss"])
        return loss, group_grads(model, label_fn)

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        loss_k, grads_k = one_step()
        torch.cuda.synchronize(dev)
        launches = dict(_build.LAUNCHES)
        with plain_kernels(mods, keep=("image_prep",)):
            loss_p, grads_p = one_step()
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  one fp32 step at B = {B}: loss {loss_k:.8f} with the kernels, {loss_p:.8f} on the "
          f"plain route (rel {rel:.2e}, tol {TOL['fp32_loss_rel']:.0e}); launches {launches}")
    check(np.isfinite(loss_k) and rel <= TOL["fp32_loss_rel"],
          "the fp32 step's loss differs from the plain route's")
    compare_groups("fp32 step", grads_k, grads_p, groups, TOL["fp32_grad_cos"])
    check_launched(mods, launches, "train_fp32")
    return launches


def plain_kernels(mods, keep=()):
    """Test-only substitution: every kernel entry, forward and backward,
    replaced by its plain version, as phase 2 calls it (the wrappers' own
    dispatch is untouched); the modules named in ``keep`` keep theirs."""
    stack = ExitStack()
    for module, entry, plain in (
            ("similarity", "_kernel", "similarity_reference"),
            ("image_prep", "_kernel", "preprocess_reference"),
            ("flash_attention", "_kernel", "flash_attention_packed_reference"),
            ("flash_attention", "_kernel_bwd", "flash_attention_packed_bwd_reference"),
            ("mlp_train", "_kernel", "dense_gelu_dense_reference"),
            ("mlp_train", "_kernel_bwd", "dense_gelu_dense_bwd_reference"),
            ("mlp_block", "_kernel", "fused_mlp_block_reference")):
        if module not in keep:
            stack.enter_context(mock.patch.object(mods[module], entry,
                                                  getattr(mods[module], plain)))
    return stack


def describe(cfg) -> str:
    if cfg.image_tower == "vit_b16":
        image = (f"ViT-B/{cfg.vit_patch} {cfg.vit_layers}x{cfg.vit_hidden}, {cfg.vit_heads} "
                 f"heads, MLP {cfg.vit_mlp_dim} (fused block: {cfg.vit_fused_mlp})")
    else:
        image = f"ResNet-50 {cfg.resnet_stages}"
    return (f"{image} + BERT {cfg.text_layers}x{cfg.text_embedding_dim} vocab "
            f"{cfg.vocab_size} + heads {cfg.shared_embedding_dim}")


def serve_phase(_build, mods, dev, seed: int, batch: int, n_batches: int, card: str,
                path: str) -> dict:
    """Phases 3 and 5: the zero-shot engine and service over ``path``'s
    model (``tools/main_paths.py`` SERVE_MODELS)."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.serving import ZeroShotService
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t0 = time.perf_counter()
    cfg, engine = build_engine(dev, seed, path)
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"model: {describe(cfg)}; {n_params / 1e6:.1f} M params, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = prompts_for_family("prediction", DISEASE_LABELS)
    rng = np.random.default_rng(seed)
    host_batches = [grey_images(rng, batch) for _ in range(2)]
    requests = rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)

    # -- the main path, counted ------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    engine.build_text_features(prompts)
    probs = engine.probs(host_batches[0])
    streamed = list(engine.stream_logits(
        {"images": host_batches[i % 2], "i": i} for i in range(n_batches)))
    service = ZeroShotService(engine, DISEASE_LABELS)
    try:
        answers = [service.predict_one(im, timeout_s=120.0) for im in requests]
    finally:
        service.close()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the main path: {launches}")
    print(f"peak device memory on the main path: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; single requests "
          f"answered in {[a['latency_ms'] for a in answers]} ms")

    check(engine.text_features.shape == (16, cfg.shared_embedding_dim),
          f"text features {tuple(engine.text_features.shape)}")
    check(probs.shape == (batch, 16), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()) and probs.min() >= 0.0 and probs.max() <= 1.0,
          "probabilities not finite in [0, 1]")
    check([b["i"] for b, _ in streamed] == list(range(n_batches)), "stream order")
    for b, logits in streamed:
        check(logits.shape == (batch, 16) and bool(np.isfinite(logits).all()),
              "streamed logits")
    np.testing.assert_allclose(streamed[0][1], engine.logits(host_batches[0]), atol=1e-6)
    service_err = 0.0
    for im, ans in zip(requests, answers):
        want = engine.probs(im[None])[0]
        got = np.array([ans["probs"][d] for d in DISEASE_LABELS])
        service_err = max(service_err, float(np.abs(got - want).max()))
    print(f"service vs engine.probs: max_abs {service_err:.3e}  tol {TOL['service']:.1e}")
    check(service_err <= TOL["service"], "service answers differ from engine.probs")
    check_launched(mods, launches, path)

    # -- the same model with every kernel replaced by its plain version -------
    with plain_kernels(mods):
        before = dict(_build.LAUNCHES)
        plain_engine = ZeroShotEngine(
            engine.model, engine.tokenizer, engine.disease_list, engine.config,
            engine.mean, engine.std, engine.image_size, engine.max_text_length,
            engine.compute_dtype,
        )
        plain_engine.build_text_features(prompts)
        plain_probs = plain_engine.probs(host_batches[0])
        check(dict(_build.LAUNCHES) == before, "a kernel ran during the plain run")
    cos = torch.nn.functional.cosine_similarity(
        engine.text_features, plain_engine.text_features, dim=-1)
    probs_err = float(np.abs(probs - plain_probs).max())
    print(f"kernels vs plain versions: text-feature cosine min {float(cos.min()):.6f}; "
          f"probs max_abs {probs_err:.3e}  tol {TOL['probs_vs_plain']:.1e}; "
          f"probs std over images {float(probs.std(0).mean()):.3e}, "
          f"over classes {float(probs.std(1).mean()):.3e}")
    check(probs_err <= TOL["probs_vs_plain"], "engine probabilities differ from plain")

    # -- rates -----------------------------------------------------------------
    def e2e():
        for _ in engine.stream_logits({"images": host_batches[i % 2]} for i in range(n_batches)):
            pass

    e2e()
    torch.cuda.synchronize()
    t = time.perf_counter()
    e2e()
    torch.cuda.synchronize()
    e2e_rate = n_batches * batch / (time.perf_counter() - t)
    dev_images = torch.from_numpy(host_batches[0]).to(dev)
    ms = cuda_ms(lambda: engine._logits(dev_images), warmup=2, iters=10)
    device_rate = batch / (ms / 1e3)
    print(f"image path, batch {batch} of 512x512 grey uint8, on {card}: "
          f"{e2e_rate:.1f} img/s host uint8 -> logits (stream_logits); "
          f"{device_rate:.1f} img/s uint8 on the card -> logits ({ms:.3f} ms/batch)")
    return launches


def tensor_core_counts(_build) -> dict:
    """Kernel (mangled name) -> [its HMMA, its HGMMA instructions] in the
    built library's SASS, from the cuobjdump beside nvcc."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", _build.build_info["path"]], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "HMMA" in line
            counts[name][1] += "HGMMA" in line
    return counts


def check_launched(mods, launches: dict, path: str) -> None:
    for name in PATHS[path]:
        key = KERNELS[name][0]
        check(launches.get(key, 0) > 0, f"kernel {name} ({key}) never launched by the "
              f"{path} path")


def group_grads(model, label_fn) -> dict:
    """label -> every gradient of the group (zeros where there is none),
    flattened into one fp32 vector."""
    import torch

    parts: dict = {}
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        parts.setdefault(label_fn(tuple(name.split("."))), []).append(g.float().flatten())
    return {k: torch.cat(v) for k, v in parts.items()}


def compare_groups(what: str, got: dict, want: dict, groups, tol: float) -> None:
    import torch

    for label in sorted(want):
        gk, gp = got[label], want[label]
        if label not in groups:  # heads the pretrain forward skips
            check(not gk.any() and not gp.any(), f"{what}: {label} gradients not zero")
            print(f"  {label}: zero gradients in both ({gk.numel()} parameters)")
            continue
        cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
        print(f"  {label}: gradient cosine {cos:.6f}  norms {float(gk.norm()):.4e} / "
              f"{float(gp.norm()):.4e}  tol {tol}")
        check(cos >= tol, f"{what}: {label} gradient differs from the plain version's")


def phase4(_build, mods, dev, seed: int, card: str) -> dict:
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_clip_eval_step, make_label_fn

    t0 = time.perf_counter()
    preset, cfg, model = train_model(dev, seed, "pretrain_clip")
    groups = [g.name for g in preset.train.groups]
    lrs = base_lrs(preset)
    label_fn = make_label_fn(groups)
    batch = train_batch(np.random.default_rng(seed + 2), tokenizer(), dev, TRAIN_BATCH,
                        TRAIN_LEN)
    lengths = batch["attention_mask"].sum(1)
    print(f"model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M fp32 master "
          f"parameters, bf16 compute, dropout {cfg.dropout}; built in "
          f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x 512x512 grey uint8, "
          f"reports of {int(lengths.min())}-{int(lengths.max())} tokens "
          f"({int((lengths == TRAIN_LEN).sum())} full)")
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def fresh(dropout: float):
        """The initial weights, a new optimizer and step, the given dropout."""
        model.load_state_dict(init)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = dropout
        opt, step = pretrain_step(model, preset, cfg)
        return TrainState(model, opt), step

    # -- kernels vs plain versions from the same weights, dropout 0 ------------
    # B2's output is shared: phase 2 holds it to its plain version, and at
    # random init the image tower turns a one-bf16-step change of its input
    # into another gradient direction; cuDNN runs deterministically here, so
    # only the kernels B3, B4, B6 and B8 differ between the two runs
    images = mods["image_prep"].preprocess_images(
        batch["images"], cfg.image_size, cfg.image_size, preset.augment.mean,
        preset.augment.std)
    g = torch.Generator(dev).manual_seed(seed + 3)
    cot = [torch.randn(TRAIN_BATCH, cfg.shared_embedding_dim, device=dev, generator=g)
           for _ in range(2)]

    def fixed_cotangent():
        """Features and the gradient of <features, cot> through both towers."""
        fresh(0.0)
        feats = [f.float() for f in model.train()(images, batch["input_ids"],
                                                   batch["attention_mask"])]
        sum((f * c).sum() for f, c in zip(feats, cot)).backward()
        return [f.detach() for f in feats], group_grads(model, label_fn)

    def one_step():
        state, step = fresh(0.0)
        loss = float(step(state, batch, lrs)[1]["loss"])
        return loss, group_grads(model, label_fn)

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        feats_k, cot_k = fixed_cotangent()
        loss_k, step_k = one_step()
        with plain_kernels(mods, keep=("image_prep",)):
            before = dict(_build.LAUNCHES)
            feats_p, cot_p = fixed_cotangent()
            loss_p, step_p = one_step()
            check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL),
                  "a kernel other than B2 ran during the plain run")
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    for name, a_, b_ in zip(("image", "text"), feats_k, feats_p):
        cos = torch.nn.functional.cosine_similarity(a_, b_, dim=-1)
        print(f"  {name} features, kernels vs plain: row cosine min {float(cos.min()):.6f}, "
              f"norm {float(b_.norm(dim=-1).mean()):.2f}")
    logits_k = feats_k[1] @ feats_k[0].T / cfg.temperature
    logits_p = feats_p[1] @ feats_p[0].T / cfg.temperature
    print(f"  loss logits: max |difference| {float((logits_k - logits_p).abs().max()):.3f} "
          f"at max |logit| {float(logits_p.abs().max()):.1f}")
    print("backward of one fixed cotangent on both towers' features, dropout 0:")
    compare_groups("fixed cotangent", cot_k, cot_p, groups, TOL["grad_cos"])
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"one step, dropout 0: loss {loss_k:.6f} with the kernels, {loss_p:.6f} with the "
          f"plain versions (rel {loss_err:.2e}, tol {TOL['train_loss_rel']:.0e})")
    check(loss_err <= TOL["train_loss_rel"], "train loss differs from the plain step's")
    compare_groups("one step", step_k, step_p, groups, TOL["grad_cos"])
    del cot_k, cot_p, step_k, step_p

    # -- the main path, counted ------------------------------------------------
    state, step = fresh(cfg.dropout)
    eval_step = make_clip_eval_step(
        model, temperature=cfg.temperature, image_size=cfg.image_size,
        mean=preset.augment.mean, std=preset.augment.std, compute_dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(seed)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss = float(step(state, batch, lrs, gen)[1]["loss"])  # syncs the step
        times.append(time.perf_counter() - t)
        losses.append(loss)
        print(f"  step {i}: loss {loss:.6f}  {times[-1] * 1e3:.1f} ms  "
              f"{TRAIN_BATCH / times[-1]:.1f} samples/s")
    eval_loss = float(eval_step(state, batch)["loss"])
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    steady = times[1:]
    print(f"train path on {card}: {TRAIN_BATCH * len(steady) / sum(steady):.1f} samples/s "
          f"over steps 1-{TRAIN_STEPS - 1} ({1e3 * sum(steady) / len(steady):.1f} ms/step; "
          f"step 0 {times[0] * 1e3:.1f} ms); eval loss {eval_loss:.6f}")
    print(f"launches on the train path: {launches}")
    print(f"peak device memory on the train path: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    check(all(np.isfinite(losses)) and np.isfinite(eval_loss), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(state.step == TRAIN_STEPS, f"step counter {state.step}")
    after = model.state_dict()
    moved = {}
    for name, _ in model.named_parameters():
        label = label_fn(tuple(name.split(".")))
        moved[label] = moved.get(label, False) or not torch.equal(after[name], init[name])
    print(f"parameter groups moved: {moved}")
    check(all(moved.values()), "a parameter group did not move")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    n_moved = sum(not torch.equal(after[k], init[k]) for k in stats)
    print(f"BatchNorm running statistics moved: {n_moved} of {len(stats)}")
    check(n_moved == len(stats), "BatchNorm running statistics did not all move")
    check_launched(mods, launches, "train")
    return launches


def states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch_equal(a[k], b[k]) for k in a)


def torch_equal(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and states_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(torch_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase6(_build, mods, dev, seed: int, card: str) -> dict:
    """The chain pretrain -> adapter through fit and CheckpointManager;
    returns the launches of the pretrain_fit and adapter paths."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.evals import multilabel_metrics
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import (
        CheckpointManager, PreemptionGuard, TrainState, fit, make_adapter_eval_step,
        make_adapter_train_step, make_clip_eval_step, make_label_fn, make_optimizer,
        resume_or_init, run_eval,
    )
    from clip_for_dl_tpu_torch.train.checkpoint import model_state

    rng = np.random.default_rng(seed + 7)
    tok = tokenizer()
    batches = [train_batch(rng, tok, dev, TRAIN_BATCH, TRAIN_LEN) for _ in range(2)]
    by_path = {}
    save_ms = []

    def timed_saves(mgr):
        for name in ("save", "save_preempt"):
            original = getattr(mgr, name)

            def timed(*a, _original=original, **kw):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                _original(*a, **kw)
                save_ms.append((time.perf_counter() - t) * 1e3)

            setattr(mgr, name, timed)
        return mgr

    with tempfile.TemporaryDirectory(prefix="chain_") as tmp:
        # -- phase A: pretrain through fit, one epoch ---------------------------
        preset, cfg, model = train_model(dev, seed, "pretrain_clip")
        opt, step = pretrain_step(model, preset, cfg)
        eval_step = make_clip_eval_step(
            model, temperature=cfg.temperature, image_size=cfg.image_size,
            mean=preset.augment.mean, std=preset.augment.std, compute_dtype=torch.bfloat16)
        ckpt_a = timed_saves(CheckpointManager(f"{tmp}/pretrain", max_to_keep=1))
        lrs = base_lrs(preset)
        print(f"phase A: pretrain_clip, fit for 1 epoch of {CHAIN_STEPS} steps at "
              f"B = {TRAIN_BATCH}, scheduler {preset.train.scheduler}")
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t = time.perf_counter()
        state_a, hist_a = fit(
            TrainState(model, opt), step, eval_step,
            lambda: (batches[i % 2] for i in range(CHAIN_STEPS)), lambda: iter(batches[1:]),
            base_lrs=lrs, num_epochs=1,
            rng_stream=itertools.repeat(torch.Generator(dev).manual_seed(seed)),
            scheduler=preset.train.scheduler, early_stop_patience=None, checkpointer=ckpt_a,
            log_every=1)
        torch.cuda.synchronize(dev)
        by_path["pretrain_fit"] = dict(_build.LAUNCHES)
        print(f"  history {hist_a.rows} in {time.perf_counter() - t:.1f} s; checkpoint save "
              f"{[round(x, 1) for x in save_ms]} ms; launches {by_path['pretrain_fit']}")
        check(len(hist_a.rows) == 1 and all(np.isfinite([hist_a.rows[0]["train_loss"],
                                                         hist_a.rows[0]["val_loss"]])),
              f"phase A history {hist_a.rows}")
        check(ckpt_a.all_epochs() == [0] and state_a.step == CHAIN_STEPS,
              f"phase A checkpoints {ckpt_a.all_epochs()}, step {state_a.step}")
        check_launched(mods, by_path["pretrain_fit"], "pretrain_fit")
        pretrained = {k: v.clone() for k, v in model_state(model).items()}
        del model, opt, step, eval_step, state_a
        torch.cuda.empty_cache()

        # -- phase B: the adapter from the phase-A epoch --------------------------
        preset_b, cfg_b, model_b = train_model(dev, seed + 1, "adapter")
        check(ckpt_a.restore_variables(model_b) is model_b, "no phase-A checkpoint to restore")
        check(states_equal(model_state(model_b), pretrained),
              "restore_variables did not give the phase-A weights")
        del pretrained
        label_b = make_label_fn([g.name for g in preset_b.train.groups])
        opt_b = make_optimizer(model_b, label_b, weight_decay=preset_b.train.weight_decay)
        prep_b = dict(image_size=cfg_b.image_size, mean=preset_b.augment.mean,
                      std=preset_b.augment.std, compute_dtype=torch.bfloat16)
        step_b = make_adapter_train_step(model_b, opt_b, label_b, **prep_b)
        eval_b = make_adapter_eval_step(model_b, **prep_b)
        labels = rng.random((TRAIN_BATCH, cfg_b.num_classes)) < 0.3
        labels[0], labels[1] = True, False  # every class has both outcomes
        batch = {"images": batches[0]["images"],
                 "labels": torch.from_numpy(labels.astype(np.float32)).to(dev)}
        before = model_state(model_b)
        frozen = {k: v.clone() for k, v in before.items() if not k.startswith("adapter.")}
        adapter0 = {k: v.clone() for k, v in before.items() if k.startswith("adapter.")}
        guard = PreemptionGuard(signals=())
        preempt_after = 2 * CHAIN_STEPS + 2
        times, losses = [], []

        def timed_step(state, b, lrs_, gen):
            t0 = time.perf_counter()
            state, metrics = step_b(state, b, lrs_, gen)
            losses.append(float(metrics["loss"]))  # syncs the step
            times.append(time.perf_counter() - t0)
            if len(times) == preempt_after:
                guard.trigger()
            return state, metrics

        ckpt_b = timed_saves(CheckpointManager(f"{tmp}/adapter", max_to_keep=1))
        base_b = {"adapter": preset_b.train.lr, "default": 0.0}
        print(f"phase B: adapter, fit for 2 epochs of {CHAIN_STEPS} steps at B = "
              f"{TRAIN_BATCH}, best-1 retention, preemption after step 2 of epoch 2")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        save_ms.clear()
        _build.reset_launches()
        state_b, hist_b = fit(
            TrainState(model_b, opt_b), timed_step, eval_b,
            lambda: itertools.repeat(batch, CHAIN_STEPS), lambda: iter([batch]),
            base_lrs=base_b, num_epochs=3, rng_stream=itertools.repeat(None),
            scheduler=preset_b.train.scheduler,
            early_stop_patience=preset_b.train.early_stop_patience, checkpointer=ckpt_b,
            preemption_guard=guard, log_every=1)
        torch.cuda.synchronize(dev)
        by_path["adapter"] = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        steady = times[1:]
        print(f"  history {hist_b.rows}")
        print(f"  step losses {[round(x, 6) for x in losses]}")
        print(f"adapter path on {card}: {TRAIN_BATCH * len(steady) / sum(steady):.1f} "
              f"samples/s over steps 1-{len(times) - 1} (each synced; step 0 "
              f"{times[0] * 1e3:.1f} ms); checkpoint saves {[round(x, 1) for x in save_ms]} ms; "
              f"peak device memory {peak:.2f} GiB; launches {by_path['adapter']}")

        after = model_state(model_b)
        check(all(torch.equal(after[k], v) for k, v in frozen.items()),
              "a tower parameter or BatchNorm statistic changed in phase B")
        check(all(not torch.equal(after[k], v) for k, v in adapter0.items()),
              "the adapter did not move")
        check(len(losses) == preempt_after and all(np.isfinite(losses)),
              f"phase B step losses {losses}")
        val = [r["val_loss"] for r in hist_b.rows]
        # Adam at the preset's lr 1e-3 overshoots on the fixed batch within
        # an epoch, so the check is against the first step's loss
        check(len(val) == 2 and losses[-1] < losses[0] and min(val) < losses[0],
              f"phase B losses did not fall on the fixed batch: {losses}, val {val}")
        best = 1 if val[1] <= val[0] else 0  # ties rank the newest best
        check(ckpt_b.all_epochs() == [best] and ckpt_b.best_epoch() == best,
              f"retained {ckpt_b.all_epochs()}, best {ckpt_b.best_epoch()}; val {val}")
        check(ckpt_b.preempt_latest() == 2, f"preemption slot {ckpt_b.preempt_latest()}")
        _, _, fresh = train_model(dev, seed + 2, "adapter")
        fresh_opt = make_optimizer(fresh, label_b, weight_decay=preset_b.train.weight_decay)
        resumed, start = resume_or_init(ckpt_b, TrainState(fresh, fresh_opt))
        # JAX's rule: a mid-epoch save newer than every kept epoch, no loader
        # to replay into -> the next epoch
        check(start == 3, f"resume_or_init started at epoch {start}, not 3")
        check(resumed.step == state_b.step == preempt_after, f"step {resumed.step}")
        check(states_equal(model_state(fresh), after), "resumed weights differ")
        check(torch_equal(fresh_opt.state_dict(), opt_b.state_dict()),
              "resumed optimizer state differs")
        print(f"  retained epoch {ckpt_b.all_epochs()} (val {val}); preemption slot at "
              f"epoch {ckpt_b.preempt_latest()}; resume_or_init -> epoch {start}, "
              "state bit-equal")
        del fresh, fresh_opt, resumed
        ev = run_eval(eval_b, state_b, [batch])
        metrics = multilabel_metrics(ev["probs"], ev["labels"], class_names=DISEASE_LABELS)
        check(ev["probs"].shape == (TRAIN_BATCH, cfg_b.num_classes)
              and np.isfinite(metrics["auroc_macro"]), f"run_eval metrics {metrics}")
        print(f"  run_eval: loss {ev['loss']:.6f}, macro AUROC {metrics['auroc_macro']:.4f}, "
              f"mAP {metrics['mAP']:.4f}")
        check_launched(mods, by_path["adapter"], "adapter")
    return by_path

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = ap.parse_args(argv)

    _build, mods = import_port()
    import torch

    from clip_for_dl_tpu_torch.core.device import require_cuda

    try:
        dev = require_cuda("cuda:0")
    except RuntimeError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn tf32 {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")
    counts = tensor_core_counts(_build)
    # the 16-bit attention bodies, templated on their type (the mangled
    # names' "13__nv_bfloat16" and "6__half")
    for t, mangled in (("bf16", "I13__nv_bfloat16"), ("fp16", "I6__half")):
        for kernel in ("flash_fwd_kernel", "flash_bwd_rows_kernel", "flash_bwd_cols_kernel"):
            for d in (32, 64, 128):
                n = sum(c[0] + c[1] for name, c in counts.items()
                        if kernel in name and f"{mangled}Li{d}E" in name)
                print(f"tensor-core instructions (HMMA/HGMMA) in {kernel}<{t}, {d}>: {n}")
                check(n > 0, f"{kernel}<{t}, {d}> has no tensor-core instruction")
        for kernel in ("flash_fwd_sliced_kernel", "flash_bwd_rows_sliced_kernel",
                       "flash_bwd_cols_sliced_kernel"):
            n = sum(c[0] + c[1] for name, c in counts.items()
                    if kernel in name and f"{mangled}E" in name)
            print(f"tensor-core instructions (HMMA/HGMMA) in {kernel}<{t}>: {n}")
            check(n > 0, f"{kernel}<{t}> has no tensor-core instruction")
    # the fp32 attention bodies run on the CUDA cores
    for kernel in ("flash_fwd_f32_kernel", "flash_bwd_rows_f32_kernel",
                   "flash_bwd_cols_f32_kernel"):
        found = [name for name in counts if kernel in name]
        check(len(found) == 1, f"{kernel}: {len(found)} instances in the library")
    for kernel in ("mlp_bwd_gelu_kernel", "mlp_bwd_dx_kernel"):
        hmma, hgmma = (sum(c[i] for name, c in counts.items() if kernel in name)
                       for i in (0, 1))
        print(f"B8 {kernel}: HGMMA {hgmma}, HMMA {hmma}")
        check(hgmma > 0, f"{kernel} has no HGMMA instruction")
    for which, epilogue in (("B4", "Dense"), ("B9", "MlpBlock")):
        for kernel in ("mlp_fwd_gelu_kernel", "mlp_fwd_out_kernel"):
            found = [c for name, c in counts.items() if kernel in name and epilogue in name]
            hmma, hgmma = (sum(c[i] for c in found) for i in (0, 1))
            print(f"{which} {kernel}: HGMMA {hgmma}, HMMA {hmma}")
            check(len(found) == 1 and hgmma > 0 and hmma == 0,
                  f"{which} {kernel}: {len(found)} instances, HGMMA {hgmma}, HMMA {hmma}")

    results: dict = {}
    phase2(mods, dev, args.seed, BATCH, results)
    phase2_train(mods, dev, args.seed, results)
    phase2_repairs(mods, dev, args.seed, results)
    by_path = phase2_split(_build, mods, dev, args.seed, results)
    phase2_limits(mods, dev, args.seed, results)
    print("== phase 2, C7: attention in fp32 and fp16")
    phase2_types(mods, dev, args.seed, results)
    by_path["typed_attention"] = typed_attention_path(_build, mods, dev, args.seed)
    print("== phase 2, C8: B1 and B2 on every input the JAX kernels take")
    by_path["c8_cases"] = phase2_c8(_build, mods, dev, args.seed, results)
    print("== phase 3: zero-shot serving, ResNet-50")
    by_path["serve"] = serve_phase(_build, mods, dev, args.seed, BATCH, N_BATCHES, card, "serve")
    print("== phase 4: the phase-A train step")
    by_path["train"] = phase4(_build, mods, dev, args.seed, card)
    print("== phase 5: zero-shot serving, ViT-B/16")
    by_path["serve_vit"] = serve_phase(_build, mods, dev, args.seed, BATCH, N_BATCHES, card,
                                       "serve_vit")
    print("== phase 6: the chain pretrain -> adapter")
    by_path.update(phase6(_build, mods, dev, args.seed, card))
    print("== phase 7: the parity mode, --fp32 --flash-attention")
    by_path["serve_fp32"] = serve_fp32_phase(_build, mods, dev, args.seed, card)
    by_path["train_fp32"] = train_fp32_phase(_build, mods, dev, args.seed)
    print("== the wrappers' host time (tools/launch_times.py)")
    from clip_for_dl_tpu_torch.tools import launch_times

    check(launch_times.main(["--root", str(ROOT), "--requests", "10"]) == 0,
          "launch_times failed")

    kernels = []
    for name, (key, src, tpu) in KERNELS.items():
        counts = {path: launches.get(key, 0) for path, launches in by_path.items()}
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": tpu,
                        "launches": sum(counts.values()), "launches_by_path": counts,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.exit(code)
