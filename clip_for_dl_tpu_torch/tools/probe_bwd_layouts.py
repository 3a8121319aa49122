"""Probe: does the head layout cost the attention backward anything?

Counterpart of ``tools/probe_bwd_lane_packing.py`` (P1). That probe asked
whether TPU lane layouts of two D = 64 heads (``stack2``, ``reshape3d``) fed
the TPU's 128-lane matrix unit better than the shipped backward; lane
packing does not exist on Hopper. The question here is whether the layout of
the heads in device memory costs the backward anything: three runs at one
shape, bf16 inputs from a seed, dropout off, key bias zero:

- ``shipped``: kernel B6 on packed qkv [B, N, 3·H·D];
- ``bnhd``: kernel B7 on q, k, v, d(out) [B, N, H, D] (the towers' bytes);
- ``bhnd``: kernel B7 on head-major contiguous [B, H, N, D].

B6 and B7 are one kernel body with other strides, so all three must give the
same dq, dk and dv bits; if not, the variant reports ``MISMATCH`` and the
probe exits 1. Each variant's time is the mean of ``--iters`` launches
between CUDA events after three warm-up launches, with TFLOP/s from the JAX
probe's count 10·B·H·NP²·D (NP = N rounded up to 8).

Usage, on the GPU (``--device cpu`` runs the plain versions instead):

    python -m clip_for_dl_tpu_torch.tools.probe_bwd_layouts --out BASE

prints one JSON line per variant, then the whole result; ``--out BASE``
writes ``BASE.json`` and ``BASE.md``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.device import require_cuda
from ..ops import flash_attention as fa


def time_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean ms of ``iters`` calls of ``fn`` after three warm-up calls: CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def _variants(q, k, v, do, bias):
    """name -> a call returning (dq, dk, dv) as [B, N, H, D]."""
    B, N, H, D = q.shape
    qkv = torch.cat([t.reshape(B, N, H * D) for t in (q, k, v)], dim=-1)
    head_major = [t.transpose(1, 2).contiguous() for t in (q, k, v, do)]

    def shipped():
        dqkv = fa.flash_attention_packed_bwd(qkv, do.reshape(B, N, H * D), H, bias)
        return tuple(dqkv.view(B, N, 3, H, D).unbind(2))

    return {
        "shipped": shipped,
        "bnhd": lambda: fa.flash_attention_bwd(q, k, v, do, bias, layout="bnhd"),
        "bhnd": lambda: tuple(g.transpose(1, 2) for g in fa.flash_attention_bwd(
            *head_major, bias, layout="bhnd")),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seq", type=int, default=200)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--out", default=None, metavar="BASE")
    args = p.parse_args(argv)

    dev = torch.device("cpu") if args.device == "cpu" else require_cuda(args.device)
    B, N, H, D = args.batch, args.seq, args.heads, args.dim
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, N, H, D)).astype(np.float32))
                   .to(dev).bfloat16() for _ in range(4))
    bias = torch.zeros((B, N), dtype=torch.float32, device=dev)
    NP = -(-N // 8) * 8
    flops = 10 * B * H * NP * NP * D
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    results = {"shape": {"B": B, "N": N, "NP": NP, "H": H, "D": D},
               "device": kind, "variants": {}}
    reference = None
    ok = True
    for name, fn in _variants(q, k, v, do, bias).items():
        out = fn()
        row: dict = {}
        if reference is None:
            reference = out
            row["numerics"] = "reference"
        else:
            equal = all(torch.equal(a, b) for a, b in zip(out, reference))
            row["max_abs_err_vs_shipped"] = max(
                float((a.float() - b.float()).abs().max()) for a, b in zip(out, reference))
            row["numerics"] = "bit-equal" if equal else "MISMATCH"
            ok = ok and equal
        ms = time_ms(fn, args.iters, dev)
        row["ms"] = ms
        row["tflops_per_s"] = flops / (ms * 1e-3) / 1e12
        results["variants"][name] = row
        print(json.dumps({name: row}), flush=True)

    print(json.dumps(results))
    if args.out:
        with open(args.out + ".json", "w") as f:
            json.dump(results, f, indent=1)
        lines = [
            "# Attention backward: head-layout probe",
            "",
            f"Shape B={B} N={N} (NP {NP}) H={H} D={D}, dropout off, bf16 inputs, "
            f"mean of {args.iters} calls a variant after 3 warm-up calls, on {kind}.",
            "",
            "| variant | ms | TFLOP/s | numerics |",
            "|---|---|---|---|",
        ]
        for name, row in results["variants"].items():
            lines.append(f"| {name} | {row['ms']:.4f} | {row['tflops_per_s']:.2f} "
                         f"| {row['numerics']} |")
        lines += ["", "Generated by `python -m clip_for_dl_tpu_torch.tools.probe_bwd_layouts "
                      f"--out {args.out}`."]
        with open(args.out + ".md", "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
