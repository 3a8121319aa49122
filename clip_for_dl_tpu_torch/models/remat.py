"""Rematerialization of the towers' layers (counterpart of
``clip_for_dl_tpu.models.remat``).

``remat`` on a transformer tower (``remat_conv`` on the ResNet) runs each
layer (each bottleneck block) through :func:`remat_call`: its forward
keeps only what the *policy* saves, and the backward recomputes the rest
from the layer's inputs.

- ``"full"``: save nothing (``torch.utils.checkpoint.checkpoint`` with
  ``use_reentrant=False``), the most memory saved and the most recompute;
- ``"dots"``: save the outputs of the matrix products and convolutions
  (JAX's ``dots_saveable``: ``dot_general`` and ``conv_general_dilated``),
  here ``aten.mm``, ``addmm``, ``bmm``, ``baddbmm`` and ``convolution``,
  through selective checkpointing
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``);
- ``"dots_no_batch"``: save only the products with no batch dimension
  (JAX's ``dots_with_no_batch_dims_saveable``), here ``aten.mm`` and
  ``addmm``: a Dense over [B, L, D] is one product of the flattened rows, an
  attention or expert product over a batch dimension is a ``bmm``;
- ``"none"``: no wrapping.

A ``pallas_call`` is neither a dot nor a convolution, so JAX recomputes the
attention and MLP kernels under every policy; so does the port: the
``cxr::`` operators (``ops/library.py``) and the kernels' autograd
functions run again in the backward (a ``--remat`` step launches B3 and B4
twice a layer, B6 and B8 once).

What flax replays for free has to be carried into the recompute by hand,
which runs inside ``backward()``, after the step's contexts have exited:

- the layer's dropout ``generator`` (an explicit ``torch.Generator``, which
  ``torch.utils.checkpoint`` does not restore) is set back to its state
  at the forward for the recompute, and to its own state after it, so
  that the recompute draws the forward's seeds and masks;
- the context variables of the forward (BatchNorm's group,
  ``models/resnet.py``; the MoE layers' routing group,
  ``models/moe.py``) are those of a copy of the forward's context, in
  which :func:`recomputing` is true: BatchNorm then leaves its running
  statistics alone (flax updates them once) and a MoE layer appends no
  second aux loss. A recompute's collectives (global BatchNorm's sums, the
  routing's counts) run at the same point of every rank's backward.
"""

from __future__ import annotations

import contextvars
from typing import Callable, Optional

import torch

REMAT_POLICIES = ("full", "dots", "dots_no_batch", "none")

_aten = torch.ops.aten
# the products each policy saves (their overload packets)
_SAVED = {
    "dots": frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution}),
    "dots_no_batch": frozenset({_aten.mm, _aten.addmm}),
}

# true inside a recompute (see the module docstring)
_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar("remat_recomputing",
                                                              default=False)


def recomputing() -> bool:
    """True while a remat'd layer's forward runs again in the backward."""
    return _RECOMPUTING.get()


def resolve_remat_policy(name: str) -> Optional[Callable]:
    """A policy name → the selective checkpointing policy function (op
    saved or recomputed), or None for ``"full"`` (save nothing) and
    ``"none"`` (the caller does not wrap)."""
    if name in ("full", "none"):
        return None
    if name not in _SAVED:
        raise ValueError(f"unknown remat policy {name!r}; expected one of {REMAT_POLICIES}")
    from torch.utils.checkpoint import CheckpointPolicy

    saved = _SAVED[name]

    def policy(ctx, func, *args, **kwargs):
        if func.overloadpacket in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def remat_call(fn: Callable, policy: str, *args,
               generator: Optional[torch.Generator] = None):
    """``fn(*args)`` rematerialized under ``policy`` (``"none"``, or no
    gradient being recorded: called as it is). ``generator``: the
    explicit generator ``fn`` draws its dropout from."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    forward_context = contextvars.copy_context()
    start = None if generator is None else generator.get_state()
    calls = []

    def body(*inner):
        if not calls:  # the forward
            calls.append(1)
            return fn(*inner)
        context = forward_context.copy()
        return context.run(_recompute, fn, inner, generator, start)

    kw = {}
    select = resolve_remat_policy(policy)
    if select is not None:
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(select)
    return checkpoint(body, *args, use_reentrant=False, **kw)


def _recompute(fn, args, generator, start):
    _RECOMPUTING.set(True)
    if generator is None:
        return fn(*args)
    after = generator.get_state()
    generator.set_state(start)
    try:
        return fn(*args)
    finally:
        generator.set_state(after)
