"""Time the port's wrappers from the host, as a caller meets them: B1 at the
serving shape, B2 and B9 at one request, and one ViT-B/16 request through
``ZeroShotService``, each with the kernels' device time beside it. At these
shapes a wrapper's host path (checks, allocation, the launch) is longer
than its kernel, so these numbers move with ``ops/_build.launch``.

Run it as a script, once per checkout, from any directory; ``--root`` names
the checkout whose package is timed (default: the one holding this file),
so that two commits compare on one card when the command runs them in
turns (other, this, this, other):

    python clip_for_dl_tpu_torch/tools/launch_times.py --root other
    python clip_for_dl_tpu_torch/tools/launch_times.py

Prints one JSON line: per item the ms of one call (CUDA events over 100
back-to-back calls, the median and the least of seven) and the device ms
of its kernels (torch.profiler), the request's median host latency, and
the card.
Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def events_ms(fn, iters: int = 100, repeats: int = 7):
    """(median, min) ms of one call of ``fn`` over ``repeats`` CUDA-event
    timings of ``iters`` back-to-back calls, after three warm-up calls: the
    host's clock is shared with other work, so its spread is reported."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), min(times)


def device_ms(fn, names, calls: int = 20):
    """Device ms a call of ``fn`` spends in kernels whose names contain one
    of ``names`` (torch.profiler), or "not measured" without device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(a, "device_time_total", 0.0) for a in prof.key_averages()
                if any(n in a.key for n in names))
    return total / 1e3 / calls if total > 0 else "not measured"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", type=Path, default=HERE,
                   help="checkout whose clip_for_dl_tpu_torch is timed")
    p.add_argument("--requests", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import clip_for_dl_tpu_torch
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.ops import image_prep as prep
    from clip_for_dl_tpu_torch.ops import mlp_block as blk
    from clip_for_dl_tpu_torch.ops import similarity as sim
    from clip_for_dl_tpu_torch.serving import ZeroShotService
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine
    from clip_for_dl_tpu_torch.zeroshot import prompts_for_family

    if not Path(clip_for_dl_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"FAIL: imported the port from {clip_for_dl_tpu_torch.__file__}, not {root}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    _build.build()
    g = torch.Generator(dev).manual_seed(args.seed)
    result = {"root": str(root), "card": card()}

    img = torch.randn(256, 512, device=dev, generator=g)
    txt = torch.randn(16, 512, device=dev, generator=g)
    one = torch.randint(0, 256, (1, 224, 224, 3), device=dev, generator=g, dtype=torch.uint8)
    H, F = 768, 3072
    x = torch.randn(197, H, device=dev, generator=g).bfloat16()
    ls, lb = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g), torch.zeros(H, device=dev)
    w1 = (torch.randn(F, H, device=dev, generator=g) * H ** -0.5).bfloat16()
    w2 = (torch.randn(H, F, device=dev, generator=g) * F ** -0.5).bfloat16()
    b1, b2 = torch.zeros(F, device=dev), torch.zeros(H, device=dev)
    for name, fn, kernels in (
        ("B1 [256, 512] x [16, 512] fp32", lambda: sim.similarity(img, txt, 0.5),
         ("similarity",)),
        ("B2 [1, 224, 224, 3] uint8 -> bf16",
         lambda: prep.preprocess_images(one, 224, 224, CLIP_MEAN, CLIP_STD), ("image_prep",)),
        ("B9 [197, 768] bf16", lambda: blk.fused_mlp_block(x, ls, lb, w1, b1, w2, b2),
         ("mlp_block", "mlp_fwd")),
    ):
        median, least = events_ms(fn)
        result[name] = {"ms": median, "min_ms": least, "device_ms": device_ms(fn, kernels)}

    _, engine = build_engine(dev, args.seed, "serve_vit")
    engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
    rng = np.random.default_rng(args.seed)
    requests = rng.integers(0, 256, (args.requests, 224, 224, 3), dtype=np.uint8)
    service = ZeroShotService(engine, DISEASE_LABELS)
    try:
        for im in requests[:3]:  # warm-up
            service.predict_one(im, timeout_s=120.0)
        lat = []
        for im in requests:
            t = time.perf_counter()
            service.predict_one(im, timeout_s=120.0)
            lat.append((time.perf_counter() - t) * 1e3)
    finally:
        service.close()
    result["ViT-B/16 one request through ZeroShotService"] = {
        "median_ms": statistics.median(lat), "min_ms": min(lat), "max_ms": max(lat),
        "requests": len(lat)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
