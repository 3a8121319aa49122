"""Hold this checkout's packed attention kernels, B3 (forward) and B6
(backward), its MLP kernels, B4 (forward), B8 (backward) and B9 (the ViT
block), its image prep, B2, and its similarity, B1, against another
checkout's build of them on one card: the same inputs, the outputs
compared bit for bit, and the times taken in turns (other, this, this,
other) so that drift of the card's clocks shows.

For a change that must not move the kernels' numerics, such as a refactor
of how they address their operands:

    mkdir other && git archive <commit> | tar -x -C other
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other

``--redesigned`` names the kernels that a change computes in another order
and so may move within tolerance instead of bit for bit: B6's gradients per
(batch row, head) slice within two bf16 steps of the other build's
(``grad_slice_error``), B3's output within 2e-2 (two bf16 steps at |o| ≤ 3),
B8's dx, g and dh each within two bf16 steps of the other build's largest
entry, B4's output within 2e-2 (two bf16 steps at |y| ≲ 2), B9's MLP
branch out - x within two bf16 steps of its largest entry, B2's output
within its plain-version tolerances (1.6e-2 in bf16, one step at |x| ≤
2.2; 1e-4 in fp32), B1's logits within 1e-5 (fp32, summation order). For a
redesign of the attention backward, of its forward, of B8, of the MLP
forwards, of B2 or of B1:

    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B6
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B3
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B8
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B4 B9
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B2
    python -m clip_for_dl_tpu_torch.tools.compare_builds --other other --redesigned B1

Every row prints, for each kernel, whether it is bit-equal and its largest
difference. B2's and B1's rows call both builds' C entries with the same
pointers (no wrapper on either side), check this build against its
wrapper, and add each one's device time from torch.profiler, since one
request's kernel is shorter than a launch from Python (the wrappers' own
host time is tools/launch_times.py's).

The other checkout's kernels are built by its own ``ops/_build.py`` in a
child process and loaded beside this checkout's with that checkout's own C
signatures; this checkout's kernels run through their wrappers. Prints one
JSON line per (shape, dropout rate) and exits 1 if any output differs
beyond what is allowed.
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
from ..ops import image_prep as prep
from ..ops import mlp_block as blk
from ..ops import mlp_train as mlp
from ..ops import similarity as sim
from .probe_bwd_layouts import time_ms

# (B, N, H, D): the prompt bank, the train step, the ViT batch, C1
SHAPES = ((64, 200, 12, 64), (128, 200, 12, 64), (256, 197, 12, 64), (2, 512, 2, 128))
RATES = (0.0, 0.1)
ENTRIES = ("cxr_flash_fwd_packed", "cxr_flash_bwd_packed")
FWD_TOL = 2e-2  # B3's output, max abs: two bf16 steps at |o| ≤ 3
# (R, H, F) of B8: the train step, and hidden 256 (C3)
MLP_SHAPES = ((25600, 768, 3072), (12800, 256, 1024))
MLP_BWD_REL = 2.0 ** -6  # B8's outputs: two bf16 steps at each one's largest entry
# (R, H, F) of B4: the prompt bank, and hidden 256 (C3); of B9: the ViT
# batch, and one request
B4_SHAPES = ((12800, 768, 3072), (12800, 256, 1024))
B9_SHAPES = ((50432, 768, 3072), (197, 768, 3072))
B4_TOL = 2e-2  # B4's output, max abs: two bf16 steps at |y| ≲ 2
B9_REL = 2.0 ** -6  # B9's branch out - x: two bf16 steps at its largest entry
# B2: (B, H_in, W_in, C) -> 224 x 224: the serving batch, the identity at
# eight requests and at one, odd widths
B2_SHAPES = ((256, 512, 512, 1), (8, 224, 224, 3), (1, 224, 224, 3), (2, 333, 97, 3))
B2_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-4}  # its plain-version tolerances
# B1: (B, C, D) fp32 features: the serving batch, one request, 200 prompts
B1_SHAPES = ((256, 16, 512), (1, 16, 512), (256, 200, 96))
B1_TOL = 1e-5  # fp32 logits ≤ 1/T = 2, summation order
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _pointers(signature) -> int:
    """How many pointers lead an entry point's arguments."""
    return next(i for i, t in enumerate(signature) if t is not ctypes.c_void_p)


class ThisInterface:
    """Another build's kernel library, called as this checkout's wrappers
    call their own. An entry point's scratch buffers come last among its
    pointers; where the other build's entry takes fewer pointers (the MLP
    forwards before they took scratch), the extra ones are left out of the
    call, so the other build runs with its own C signature."""

    def __init__(self, lib: ctypes.CDLL, signatures: dict):
        self._lib, self._signatures = lib, signatures

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in _build._SIGNATURES:
            return fn
        n = _pointers(_build._SIGNATURES[name])
        keep = _pointers(self._signatures[name])
        return fn if keep == n else (lambda *args: fn(*args[:keep], *args[n:]))


def other_library(root: Path) -> ThisInterface:
    """The kernel library of the checkout at ``root``, built by its own
    ``ops/_build.py`` in a child process and loaded beside this one's with
    that checkout's signatures."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from clip_for_dl_tpu_torch.ops import _build; _build.build(); "
            "print(json.dumps({k: [t.__name__ for t in v] "
            "for k, v in _build._SIGNATURES.items()})); "
            "print(_build.build_info['path'])")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {root}'s kernels failed:\n{out.stderr}")
    *_, names, path = out.stdout.strip().splitlines()
    signatures = {k: tuple(getattr(ctypes, t) for t in v) for k, v in json.loads(names).items()}
    return ThisInterface(_build.load(path, signatures), signatures)


def in_turns(other, this, iters: int, dev) -> list:
    """ms of ``other``, ``this``, ``this``, ``other``."""
    return [time_ms(fn, iters, dev) for fn in (other, this, this, other)]


def device_ms(fn, name: str, calls: int = 20, tries: int = 3) -> float:
    """Device ms a call of ``fn`` spends in kernels whose names contain
    ``name`` (torch.profiler over ``calls`` calls after one). A window in
    which the profiler recorded none of them (it drops a run of short
    kernels now and then) is profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(a, "device_time_total", 0.0) for a in prof.key_averages()
                    if name in a.key)
        if total > 0:
            return total / 1e3 / calls
    raise RuntimeError(f"the profiler recorded no device time for {name} in {tries} windows")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", required=True, type=Path,
                   help="root of the other checkout (holds clip_for_dl_tpu_torch/)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--redesigned", nargs="+",
                   choices=("B1", "B2", "B3", "B4", "B6", "B8", "B9"),
                   default=(),
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
                row[f"{name} ms other,this,this,other"] = in_turns(o, t, iters, dev)
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
               "B8 ms other,this,this,other": in_turns(other_b8, this_b8, 5, dev)}
        ok = ok and (row["B8 bit-equal"] or ("B8" in args.redesigned and worst <= 1.0))
        print(json.dumps(row), flush=True)
    for R, H, F in B4_SHAPES:
        x = torch.randn(R, H, device=dev, generator=g).bfloat16()
        w1 = (torch.randn(F, H, device=dev, generator=g) * H ** -0.5).bfloat16()
        b1 = (torch.randn(F, device=dev, generator=g) * 0.1).bfloat16()
        w2 = (torch.randn(H, F, device=dev, generator=g) * F ** -0.5).bfloat16()
        b2 = (torch.randn(H, device=dev, generator=g) * 0.1).bfloat16()
        y = torch.empty(R, H, dtype=torch.bfloat16, device=dev)
        scratch = torch.empty(R, F, dtype=torch.bfloat16, device=dev)
        other_b4 = partial(call, "cxr_mlp_fwd", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           w2.data_ptr(), b2.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                           R, H, F)
        this_b4 = partial(mlp._kernel, x, w1, b1, w2, b2)
        other_b4()
        got = this_b4()
        err = float((got.float() - y.float()).abs().max())
        row = {"B4 shape": [R, H, F], "B4 bit-equal": bool(torch.equal(got, y)),
               "B4 max_abs_err": err, "B4 tol": B4_TOL,
               "B4 ms other,this,this,other": in_turns(other_b4, this_b4, 10, dev)}
        ok = ok and (row["B4 bit-equal"] or ("B4" in args.redesigned and err <= B4_TOL))
        print(json.dumps(row), flush=True)
    for R, H, F in B9_SHAPES:
        x = torch.randn(R, H, device=dev, generator=g).bfloat16()
        ls = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g)
        lb = 0.1 * torch.randn(H, device=dev, generator=g)
        w1 = (torch.randn(F, H, device=dev, generator=g) * H ** -0.5).bfloat16()
        b1 = 0.1 * torch.randn(F, device=dev, generator=g)
        w2 = (torch.randn(H, F, device=dev, generator=g) * F ** -0.5).bfloat16()
        b2 = 0.1 * torch.randn(H, device=dev, generator=g)
        out = torch.empty_like(x)
        scratch = (torch.empty_like(x), torch.empty(R, F, dtype=torch.bfloat16, device=dev))
        other_b9 = partial(call, "cxr_mlp_block", *(t.data_ptr() for t in (
            x, ls, lb, w1, b1, w2, b2, out) + scratch), R, H, F, 1e-6, 0)
        this_b9 = partial(blk._kernel, x, ls, lb, w1, b1, w2, b2, eps=1e-6,
                          gelu_approximate=False)
        other_b9()
        got = this_b9()
        branch = out.float() - x.float()
        err = float((got.float() - out.float()).abs().max())
        tol = B9_REL * float(branch.abs().max())
        row = {"B9 shape": [R, H, F], "B9 bit-equal": bool(torch.equal(got, out)),
               "B9 max_abs_err": err, "B9 tol (out - x)": tol,
               "B9 ms other,this,this,other": in_turns(other_b9, this_b9, 10, dev)}
        ok = ok and (row["B9 bit-equal"] or ("B9" in args.redesigned and err <= tol))
        print(json.dumps(row), flush=True)
    this = _build.build()
    scale, bias = prep._device_scale_bias(CLIP_MEAN, CLIP_STD, 1.0 / 255.0, dev)
    for B, H, W, C in B2_SHAPES:
        images = torch.randint(0, 256, (B, H, W, C), device=dev, generator=g,
                               dtype=torch.uint8)
        taps = (*prep._device_taps(H, 224, dev), *prep._device_taps(W, 224, dev))
        for dt in (torch.bfloat16, torch.float32):
            outs = [torch.empty(B, 224, 224, 3, dtype=dt, device=dev) for _ in range(2)]
            other_args, this_args = (
                (images.data_ptr(), *(t.data_ptr() for t in taps), scale.data_ptr(),
                 bias.data_ptr(), o.data_ptr(), B, H, W, C, 224, 224, 3,
                 int(dt == torch.bfloat16)) for o in outs)

            def this_b2():
                with torch.cuda.device(dev):
                    err = this.cxr_image_prep(*this_args,
                                              torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"cxr_image_prep returned CUDA error {err}")

            other_b2 = partial(call, "cxr_image_prep", *other_args)
            other_b2()
            this_b2()
            wrapper = prep.preprocess_images(images, 224, 224, CLIP_MEAN, CLIP_STD, dt)
            err = float((outs[1].float() - outs[0].float()).abs().max())
            row = {"B2 shape": [B, H, W, C], "dtype": str(dt).split(".")[-1],
                   "B2 bit-equal": bool(torch.equal(outs[1], outs[0])),
                   "B2 max_abs_err": err, "B2 tol": B2_TOL[dt],
                   "B2 wrapper bit-equal": bool(torch.equal(wrapper, outs[1])),
                   "B2 ms other,this,this,other": in_turns(other_b2, this_b2, 20, dev),
                   "B2 device ms other,this,this,other": [
                       device_ms(fn, "image_prep") for fn in (other_b2, this_b2, this_b2,
                                                              other_b2)]}
            ok = ok and row["B2 wrapper bit-equal"] and (
                row["B2 bit-equal"] or ("B2" in args.redesigned and err <= B2_TOL[dt]))
            print(json.dumps(row), flush=True)
    for B, C, D in B1_SHAPES:
        img = torch.randn(B, D, device=dev, generator=g)
        img[-1] = 0.0  # a padded bucket row
        txt = torch.randn(C, D, device=dev, generator=g)
        outs = [torch.empty(B, C, device=dev) for _ in range(2)]
        ptrs = [(img.data_ptr(), txt.data_ptr(), o.data_ptr(), B, C, D, 2.0, 1e-12) for o in outs]

        def this_b1():
            with torch.cuda.device(dev):
                err = this.cxr_similarity(*ptrs[1], 0, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cxr_similarity returned CUDA error {err}")

        other_b1 = partial(call, "cxr_similarity", *ptrs[0])
        other_b1()
        this_b1()
        wrapper = sim.similarity(img, txt, 0.5)
        err = float((outs[1] - outs[0]).abs().max())
        row = {"B1 shape": [B, C, D], "B1 bit-equal": bool(torch.equal(outs[1], outs[0])),
               "B1 max_abs_err": err, "B1 tol": B1_TOL,
               "B1 wrapper bit-equal": bool(torch.equal(wrapper, outs[1])),
               "B1 ms other,this,this,other": in_turns(other_b1, this_b1, 20, dev),
               "B1 device ms other,this,this,other": [
                   device_ms(fn, "similarity") for fn in (other_b1, this_b1, this_b1, other_b1)]}
        ok = ok and row["B1 wrapper bit-equal"] and (
            row["B1 bit-equal"] or ("B1" in args.redesigned and err <= B1_TOL))
        print(json.dumps(row), flush=True)
    print("as required" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
