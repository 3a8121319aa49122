"""Time the host decode that ``build_image_cache`` runs
(``native.batch_load_resize_u8``) over a set of PNG files, in one thread
and over a thread pool, and each of its stages apart: read, inflate
(zlib), unfilter (the stacked scanline reconstruction) and resize. Tells
which stages a pool speeds up: zlib and numpy's large operations release
the interpreter lock, the reconstruction's many small steps mostly hold it.

    python clip_for_dl_tpu_torch/tools/decode_threads.py DIR [--size 224] [--threads 8]

Prints one JSON line: for each stage and for the whole, the median seconds
of three runs in one thread and over ``--threads`` threads; images/s for
the whole. The pool runs the unfilter stage's stacks side by side, which
the library does not: it reconstructs them in the calling thread.
Host only; needs no card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from clip_for_dl_tpu_torch.native import bindings as nb  # noqa: E402


def _stages(paths: Sequence[str], size: int, pool) -> Dict[str, float]:
    """Seconds of each decode stage over ``paths``, in turn (pool None) or
    over ``pool``."""
    mapper = pool.map if pool else map
    out = {}
    t = time.perf_counter()
    datas = list(mapper(nb._read, paths))
    out["read"] = time.perf_counter() - t
    pngs = [None if d is None else nb._parse(d) for d in datas]
    t = time.perf_counter()
    raws = list(mapper(lambda p: None if p is None else nb._inflate(p), pngs))
    out["inflate"] = time.perf_counter() - t
    by_bpp: Dict[int, list] = {}
    for png, raw in zip(pngs, raws):
        for block in (None if png is None else nb._scanlines(png, raw)) or ():
            by_bpp.setdefault(max(1, nb._CHANNELS[png.color] * png.depth // 8), []).append(block)
    t = time.perf_counter()
    for bpp, blocks in by_bpp.items():
        list(mapper(lambda stack: nb._unfilter_blocks([blocks[i] for i in stack], bpp),
                    nb._stacks(blocks, bpp)))
    out["unfilter"] = time.perf_counter() - t
    images = [img for img in nb._decode_many(datas) if img is not None]
    t = time.perf_counter()
    list(mapper(lambda img: nb.resize_u8(img, size, size), images))
    out["resize"] = time.perf_counter() - t
    return out


def measure(paths: Sequence[str], size: int = 224, threads: int = 8,
            repeats: int = 3) -> Dict:
    """Median seconds of each stage and of the whole
    ``batch_load_resize_u8`` over ``paths``, in one thread and over
    ``threads``."""
    out: Dict = {"files": len(paths), "size": size, "threads": threads}
    for n in (1, threads):
        runs = []
        with ThreadPoolExecutor(max_workers=n) as pool:
            for _ in range(repeats):
                stages = _stages(paths, size, pool if n > 1 else None)
                t = time.perf_counter()
                nb.batch_load_resize_u8(paths, size, size, threads=n)
                stages["whole"] = time.perf_counter() - t
                runs.append(stages)
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        med["whole_img_per_s"] = len(paths) / med["whole"]
        out[f"{n}_thread{'s' if n > 1 else ''}"] = med
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir", help="directory of PNG files (searched recursively)")
    ap.add_argument("--size", type=int, default=224, help="side of the resized images")
    ap.add_argument("--threads", type=int, default=8, help="threads of the pool")
    args = ap.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(args.dir, "**", "*.png"), recursive=True))
    if not paths:
        print(f"no PNG files under {args.dir}", file=sys.stderr)
        return 2
    print(json.dumps(measure(paths, args.size, args.threads)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
