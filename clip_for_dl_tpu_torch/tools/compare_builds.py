"""Hold this checkout's packed attention kernels, B3 (forward) and B6
(backward), and its MLP backward B8 against another checkout's build of them
on one card: the same inputs, the outputs compared bit for bit, and the
times taken in turns (other, this, this, other) so that drift of the card's
clocks shows.

For a change that must not move the packed kernels' numerics, such as a
refactor of how they address their operands:

    mkdir other && git archive <commit> | tar -x -C other
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other

``--redesigned`` names the kernels that a change computes in another order
and so may move within tolerance instead of bit for bit: B6's gradients per
(batch row, head) slice within two bf16 steps of the other build's
(``grad_slice_error``), B3's output within 2e-2 (two bf16 steps at |o| ≤ 3),
B8's dx, g and dh each within two bf16 steps of the other build's largest
entry. For a redesign of the attention backward, of its forward, or of B8:

    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B6
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B3
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B8

Every row prints, for each kernel, whether it is bit-equal and its largest
difference.

The other checkout's kernels are built by its own ``ops/_build.py`` in a
child process and loaded beside this checkout's. Prints one JSON line per
(shape, dropout rate) and exits 1 if any output differs beyond what is
allowed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

from ..core.device import require_cuda
from ..ops import _build
from ..ops import flash_attention as fa
from ..ops import mlp_train as mlp
from .probe_bwd_layouts import time_ms

# (B, N, H, D): the prompt bank, the train step, the ViT batch, C1
SHAPES = ((64, 200, 12, 64), (128, 200, 12, 64), (256, 197, 12, 64), (2, 512, 2, 128))
RATES = (0.0, 0.1)
ENTRIES = ("cxr_flash_fwd_packed", "cxr_flash_bwd_packed")
FWD_TOL = 2e-2  # B3's output, max abs: two bf16 steps at |o| ≤ 3
# (R, H, F) of B8: the train step, and hidden 256 (C3)
MLP_SHAPES = ((25600, 768, 3072), (12800, 256, 1024))
MLP_BWD_REL = 2.0 ** -6  # B8's outputs: two bf16 steps at each one's largest entry


def other_library(root: Path) -> ctypes.CDLL:
    """The kernel library of the checkout at ``root``, built by its own
    ``ops/_build.py`` in a child process and loaded beside this one's."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from clip_for_dl_tpu_torch.ops import _build; _build.build(); "
            "print(_build.build_info['path'])")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {root}'s kernels failed:\n{out.stderr}")
    return _build.load(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", required=True, type=Path,
                   help="root of the other checkout (holds clip_for_dl_tpu_torch/)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--redesigned", nargs="+", choices=("B3", "B6", "B8"), default=(),
                   help="kernels held to the other build within tolerance, not bit for bit")
    args = p.parse_args(argv)

    dev = require_cuda(args.device)
    other = other_library(args.other.resolve())

    def call(name, *ptrs_and_ints):
        with torch.cuda.device(dev):
            err = getattr(other, name)(*ptrs_and_ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{args.other}: {name} returned CUDA error {err}")

    g = torch.Generator(dev).manual_seed(args.seed)
    ok = True
    for B, N, H, D in SHAPES:
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
        do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
        lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        for rate in RATES:
            seeds = (fa.dropout_seeds(g, B, dev) if rate
                     else torch.zeros(B, 1, dtype=torch.int32, device=dev))
            kw = dict(dropout_rate=rate, dropout_seeds=seeds)
            scalars = (B, N, H, D, 1.0 / D ** 0.5, rate, 1.0 / (1.0 - rate))
            out = torch.empty(B, N, H * D, dtype=torch.bfloat16, device=dev)
            dqkv = torch.empty_like(qkv)
            stats = torch.empty(3, B, H, N, device=dev)
            other_fwd = partial(call, ENTRIES[0], qkv.data_ptr(), bias.data_ptr(),
                                seeds.data_ptr(), out.data_ptr(), *scalars)
            other_bwd = partial(call, ENTRIES[1], qkv.data_ptr(), do.data_ptr(),
                                bias.data_ptr(), seeds.data_ptr(), dqkv.data_ptr(),
                                stats.data_ptr(), *scalars)
            this_fwd = partial(fa._kernel, qkv, H, bias, **kw)
            this_bwd = partial(fa._kernel_bwd, qkv, do, H, bias, **kw)
            other_fwd()
            other_bwd()
            got_fwd, got_bwd = this_fwd(), this_bwd()
            b6_err, b6_worst = fa.grad_slice_error(got_bwd, dqkv, "packed", H)
            b3_err = float((got_fwd.float() - out.float()).abs().max())
            row = {"shape": [B, N, H, D], "rate": rate,
                   "B3 bit-equal": bool(torch.equal(got_fwd, out)), "B3 max_abs_err": b3_err,
                   "B6 bit-equal": bool(torch.equal(got_bwd, dqkv)), "B6 max_abs_err": b6_err,
                   "B6 worst slice / tol": b6_worst}
            within = {"B3": b3_err <= FWD_TOL, "B6": b6_worst <= 1.0}
            for name, (o, t) in (("B3", (other_fwd, this_fwd)), ("B6", (other_bwd, this_bwd))):
                iters = 20 if name == "B3" else 10
                row[f"{name} ms other,this,this,other"] = [
                    time_ms(fn, iters, dev) for fn in (o, t, t, o)]
                ok = ok and (row[f"{name} bit-equal"]
                             or (name in args.redesigned and within[name]))
            print(json.dumps(row), flush=True)
    for R, H, F in MLP_SHAPES:
        x = torch.randn(R, H, device=dev, generator=g).bfloat16()
        w1 = (torch.randn(F, H, device=dev, generator=g) * H ** -0.5).bfloat16()
        b1 = (torch.randn(F, device=dev, generator=g) * 0.1).bfloat16()
        w2 = (torch.randn(H, F, device=dev, generator=g) * F ** -0.5).bfloat16()
        dy = (torch.randn(R, H, device=dev, generator=g) * 0.1).bfloat16()
        outs = [torch.empty(R, n, dtype=torch.bfloat16, device=dev) for n in (H, F, F)]
        other_b8 = partial(call, "cxr_mlp_bwd", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           w2.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in outs), R, H, F)
        this_b8 = partial(mlp._kernel_bwd, x, w1, b1, w2, dy)
        other_b8()
        got = this_b8()
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, outs)]
        worst = max(e / (MLP_BWD_REL * float(b.float().abs().max())) for e, b in zip(errs, outs))
        row = {"B8 shape": [R, H, F],
               "B8 bit-equal": all(torch.equal(a, b) for a, b in zip(got, outs)),
               "B8 max_abs_err dx,g,dh": errs, "B8 worst / tol": worst,
               "B8 ms other,this,this,other": [time_ms(fn, 5, dev)
                                               for fn in (other_b8, this_b8, this_b8, other_b8)]}
        ok = ok and (row["B8 bit-equal"] or ("B8" in args.redesigned and worst <= 1.0))
        print(json.dumps(row), flush=True)
    print("as required" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
