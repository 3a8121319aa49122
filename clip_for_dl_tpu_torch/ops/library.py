"""The forward kernels as PyTorch operators, in the namespace ``cxr``.

Each kernel that an exported program reaches (B1 ``similarity``, B2
``preprocess_images``, B3 ``flash_attention_packed``, B4
``dense_gelu_dense``, B9 ``fused_mlp_block``) is one operator with three
implementations: on the CPU its plain version, on CUDA its kernel wrapper
(which launches the kernel or raises), and a fake one that gives only the
output's shape and type. ``torch.export`` records the operator, not the
body of either implementation, so one program traced on the CPU runs the
kernels once it is moved to the card (``clip_for_dl_tpu_torch.export``):
the counterpart of the JAX package's one artifact lowered for cpu and tpu.
Every public wrapper calls its operator on both devices.

The operators are defined with ``torch.library.Library(..., "DEF")``,
``define`` and ``impl``: the dispatcher calls the implementation for the
tensors' device straight away, with no Python layer of its own above it
(``custom_op`` adds one). The autograd key falls through
(``torch.library.fallthrough_kernel``), as for a function that is no
operator: a CPU call that needs a gradient runs the plain version, whose
own operations record it, so its gradient is the plain version's, bit for
bit; on CUDA the kernels keep no graph, as before. The training paths
reach B3 and B4 through their ``autograd.Function``, whose forward runs
without grad.

A branch on a size (an empty batch launches nothing) lives inside the
CUDA implementation, so that a traced batch stays symbolic. The backward
kernels (B6, B7, B8) and the split attention forward (B5) are not
operators: no exported program reaches them.

Loading a ``.pt2`` that holds these operators needs them registered, that
is, this module imported (``clip_for_dl_tpu_torch.export`` imports every
module that defines one).
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "cxr"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Register operator ``cxr::name`` with ``schema`` (its arguments and
    result, as ``"(Tensor x, int n) -> Tensor"``), ``cpu`` and ``cuda`` as
    its implementations for those devices and ``fake`` for tracing; returns
    the operator's overload, which callers call like a function.

    A traced tensor reports the device it stands for, so a tensor that
    reaches ``fake`` on the meta device is a real meta tensor, on which no
    kernel runs: it goes to ``cuda``, whose checks raise."""

    def fake_or_raise(*args):
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta" for a in args):
            return cuda(*args)
        return fake(*args)

    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, torch.library.fallthrough_kernel, "Autograd")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_or_raise, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
