"""Where the time goes on the card: a torch.profiler breakdown of two main
paths of the port, kernels bucketed by name.

- ``vit``: one ViT-B/16 zero-shot batch of ``chip_smoke.py``'s phase 5
  (the ``vit`` preset's model with the fused MLP block and flash attention
  in both towers, bf16, random weights): ``ZeroShotEngine._logits`` on 256
  grey uint8 512x512 images already on the card, the prompt bank encoded
  once before;
- ``train``: one phase-A step of phase 4 (the ``pretrain_clip`` preset, flash
  attention and the fused BERT MLP, dropout 0.1, fp32 master weights, bf16
  compute) at B = 128, on one batch of images and 200-token reports of
  random dev-vocabulary words.

Both are set up by ``tools/main_paths.py``, as the smoke sets them up. For
each path, per unit (batch or step) over UNITS units after warm-up: the
time without the profiler (CUDA events); then, under the profiler, the
window (the profiler's own clock around the units and the final sync), the
device's busy time (the union of its kernel, copy and set intervals), its
idle share of the window, and each bucket's device time and share of the
buckets' sum, largest first; one JSON line per path at the end. Ranges
that the profiler projects from a ``record_function`` onto the device
(torch.optim's ``Optimizer.step#...`` among them) span other kernels and
their gaps; they are left out, and their time is printed apart. A reading
that cannot be right fails the run (exit 1): device time outside the
window, or a buckets' sum above the busy time (device events overlapping),
each past TOL of the window.

Run on the card, from the root of a checkout:

    python3 -m clip_for_dl_tpu_torch.tools.profile_paths [--other CHECKOUT]

``--other`` runs the paths on another checkout's kernels: its library is
built by its own ``ops/_build.py`` and loaded as ``compare_builds --other``
loads it (with that checkout's C signatures, called as this checkout's
wrappers call theirs), and everything above the kernels is this
checkout's. For a before/after, run other, this, this, other in one
call.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

UNITS = 5  # profiled batches or steps of each path
SEED = 0
VIT_BATCH = 256  # images of a zero-shot batch, as phase 5
TRAIN_BATCH = 128  # image-report pairs of a step, as phase 4
WINDOW = "profile_paths.window"
TOL = 1e-3  # of the window: device time outside it, or buckets over the busy time

# (bucket, substrings of a lower-cased kernel name), the first match wins.
# B4 and B9 share their two GEMM kernels (mlp_fwd_gelu_kernel,
# mlp_fwd_out_kernel), told apart by their epilogue types: B9's are
# MlpBlockGelu and MlpBlockOut, and its LayerNorm pass counts as B9 (as
# does the single mlp_block_kernel of builds before the pair).
BUCKETS = (
    ("B3/B5 attention forward", ("flash_fwd_",)),
    ("B6/B7 attention backward", ("flash_bwd_",)),
    ("B9 MLP block", ("mlp_block", "mlpblock")),
    ("B8 MLP backward", ("mlp_bwd_",)),
    ("B4 MLP forward", ("mlp_fwd_",)),
    ("B2 image prep", ("image_prep_kernel",)),
    ("B1 similarity", ("similarity_kernel",)),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "cublas", "splitk")),
    ("cuDNN convolutions", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad",
                            "wgrad")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("optimizer", ("adam", "foreach", "multi_tensor")),
    ("copies and casts", ("copy", "memcpy", "memset", "cast")),
    ("reductions", ("reduce",)),
    ("other elementwise", ("elementwise", "vectorized")),
)


def bucket_of(name: str) -> str:
    low = name.lower()
    for bucket, keys in BUCKETS:
        if any(k in low for k in keys):
            return bucket
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def account(events, window, units: int) -> dict:
    """Per unit, from device ``events`` (name, start us, end us) and the
    ``window`` (start us, end us) on the same clock: window, busy and
    bucket ms, the idle share, and ``problems``, the readings that cannot be
    right."""
    lo, hi = window
    window_ms = (hi - lo) / 1e3 / units
    busy_ms = union_us((a, b) for _, a, b in events) / 1e3 / units
    outside_ms = sum(max(0.0, min(b, lo) - a) + max(0.0, b - max(a, hi))
                     for _, a, b in events) / 1e3 / units
    buckets: dict = {}
    for name, a, b in events:
        buckets[bucket_of(name)] = buckets.get(bucket_of(name), 0.0) + (b - a) / 1e3 / units
    bucket_sum = sum(buckets.values())
    problems = []
    if outside_ms > TOL * window_ms:
        problems.append(f"{outside_ms:.3f} ms of device time outside the window")
    if bucket_sum - busy_ms > TOL * window_ms:
        problems.append(f"the buckets' sum {bucket_sum:.3f} ms exceeds the busy time "
                        f"{busy_ms:.3f} ms: device events overlap")
    return {"window_ms": window_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / window_ms, "outside_window_ms": outside_ms,
            "bucket_sum_ms": bucket_sum,
            "buckets_ms": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
            "problems": problems}


def profile(fn, dev) -> dict:
    """Per unit of ``fn``: ms without the profiler (CUDA events), and under
    torch.profiler the accounting of :func:`account`, with the device time
    of the left-out ``record_function`` ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(UNITS):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    plain_ms = start.elapsed_time(end) / UNITS
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(UNITS):
                fn()
            torch.cuda.synchronize(dev)
    window, device, ranges = None, [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (e.time_range.start, e.time_range.end)
        elif e.is_user_annotation:
            ms = (e.time_range.end - e.time_range.start) / 1e3 / UNITS
            ranges[e.name] = ranges.get(e.name, 0.0) + ms
        else:
            device.append((e.name, e.time_range.start, e.time_range.end))
    if window is None or not device:
        raise RuntimeError("the profiler recorded no window or no device activity")
    return {"ms": plain_ms, **account(device, window, UNITS), "left_out_ranges_ms": ranges}


def units(dev):
    """(path, call running one unit of it) for each path, built in turn."""
    import numpy as np
    import torch

    from ..core.config import DISEASE_LABELS
    from ..train import TrainState
    from ..zeroshot import prompts_for_family
    from .main_paths import (
        base_lrs, build_engine, grey_images, pretrain_step, tokenizer, train_batch,
        train_model,
    )

    rng = np.random.default_rng(SEED)
    _, engine = build_engine(dev, SEED, "serve_vit")
    engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
    images = torch.from_numpy(grey_images(rng, VIT_BATCH)).to(dev)
    yield "vit", lambda: engine._logits(images)

    preset, cfg, model = train_model(dev, SEED, "pretrain_clip")
    opt, step = pretrain_step(model, preset, cfg)
    data = train_batch(rng, tokenizer(), dev, TRAIN_BATCH, cfg.max_text_length)
    state, lrs = TrainState(model, opt), base_lrs(preset)
    gen = torch.Generator(dev).manual_seed(SEED)
    yield "train", lambda: step(state, data, lrs, gen)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", type=Path,
                   help="root of another checkout whose kernels are profiled in place of "
                        "this one's")
    args = p.parse_args(argv)
    import torch

    from ..core.device import require_cuda
    from ..ops import _build

    dev = require_cuda("cuda:0")
    kernels = "this checkout"
    if args.other is not None:
        from .compare_builds import other_library

        _build.use_library(other_library(args.other.resolve()))
        kernels = str(args.other)
    ok = True
    for path, fn in units(dev):
        r = profile(fn, dev)
        print(f"{path} ({kernels}'s kernels, {torch.cuda.get_device_name(0)}): "
              f"{r['ms']:.2f} ms a unit unprofiled; profiled window {r['window_ms']:.2f} ms, "
              f"device busy {r['device_busy_ms']:.2f} ms, idle {100 * r['idle_share']:.1f}%")
        for b, ms in r["buckets_ms"].items():
            print(f"  {b}: {ms:.3f} ms ({100 * ms / r['bucket_sum_ms']:.1f}% of the buckets)")
        for name, ms in r["left_out_ranges_ms"].items():
            print(f"  left out, a record_function range on the device: {name} {ms:.3f} ms")
        for problem in r["problems"]:
            print(f"  FAIL: {problem}")
        ok = ok and not r["problems"]
        print(json.dumps({"path": path, "kernels": kernels, **r}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
