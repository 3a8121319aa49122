"""Sequence parallelism for the text tower (counterpart of
``clip_for_dl_tpu.parallel.sp``).

The JAX package shards the token batch ``[batch→data, sequence→model]``
and lets GSPMD propagate it; since its attention kernel partitions over
the batch only, GSPMD gathers the sequence in front of it. Here the same
schedule runs the BERT layers' own forward (``models/bert.py``) under a
:class:`SequenceContext`, forward only, on a 2-D layout
(``parallel/common.py``):

- each model rank holds a slice of the sequence, its position ids offset by
  the slice's start; the embeddings, the LayerNorms and the MLP (B4 on the
  local rows, under ``--bert-fused-mlp``) run on the local tokens;
- attention gathers the projected q|k|v along the sequence, runs B3 on the
  whole sequence and keeps the rank's query rows;
- with ``tp_params=True`` (Megatron TP+SP on one axis) the rank holds its
  tensor-parallel shard of every layer (``parallel/tp.py``): the sequence
  is gathered in front of each column-parallel product, and after each
  row-parallel one the partial sums are reduced and the rank's slice kept
  (a reduce-scatter, written as an all-reduce and a slice, since gloo has
  none), the bias added once; B3 runs over its heads with ``head_offset``.

Ragged sequences and batches are padded (tokens with mask 0, rows of zeros)
and sliced back off the output, as the JAX wrapper does.

A MoE layer's MLP (``models/moe.py``; replicated, as the JAX ``tp_spec``
leaves it) runs on the sequence gathered over the model axis, routing over
the data axis (``moe.routing``) in the padded global batch's (row, token)
order, which is the unsharded layer's on the padded batch (GSPMD's result
in the JAX package); each rank keeps its tokens of the output.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from ..models.moe import routing
from .collectives import all_gather_dim
from .common import DATA_AXIS, MODEL_AXIS, Mesh2D
from .tp import TPContext, check_model_tp, shard_layers_


@dataclass(frozen=True)
class SequenceContext(TPContext):
    """A layer whose tokens are sharded along the sequence: this rank's is
    block ``seq_rank`` of ``seq_size`` over ``seq_group``. With the weights
    replicated (``size`` 1) the attention gathers q|k|v and keeps the
    rank's query rows; with them tensor-parallel over the same group
    (``size`` > 1) the input is gathered at each column-parallel product
    and each row-parallel sum sliced back to the rank's tokens."""

    seq_rank: int = 0
    seq_size: int = 1
    seq_group: Optional[object] = None

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        return t.chunk(self.seq_size, 1)[self.seq_rank]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else all_gather_dim(x, 1, self.seq_group)

    def row_output(self, parts: List[torch.Tensor], bias: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        if self.size == 1:
            return parts[0]
        return (self._local(self.reduce([p.float() for p in parts])) + bias.float()).to(dtype)

    def attend(self, fn: Callable, *qkv: torch.Tensor) -> torch.Tensor:
        if self.size > 1:  # the sequence was gathered at the layer's input
            return fn(*qkv)
        return self._local(fn(*(all_gather_dim(t, 1, self.seq_group) for t in qkv)))

    def replicated(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        return self._local(fn(all_gather_dim(x, 1, self.seq_group)))


def sequence_sharded_fn(
    encoder,
    mesh: Mesh2D,
    data_axis: str = DATA_AXIS,
    seq_axis: str = MODEL_AXIS,
    tp_params: bool = False,
) -> Callable:
    """The text-tower forward of ``encoder`` (a ``models.bert.BertEncoder``)
    with tokens sharded ``[batch→data, sequence→seq_axis]``:
    ``wrapped(input_ids, attention_mask)`` → last hidden state [B, L,
    hidden] on every rank. ``tp_params=True`` also tensor-parallel-shards
    the weights over ``seq_axis`` (Megatron TP+SP on one axis); otherwise
    each rank runs the whole layer on its tokens. Forward only (eval): it
    runs an eval-mode copy of ``encoder``."""
    if tuple(mesh.axis_names) != (data_axis, seq_axis):
        raise ValueError(f"the mesh's axes are {mesh.axis_names}, not "
                         f"{(data_axis, seq_axis)}")
    n_batch, n_seq = mesh.data_size, mesh.model_size
    r_batch, r_seq = mesh.data_index, mesh.model_index
    seq_group, batch_group = mesh.model_group, mesh.data_group
    tower = copy.deepcopy(encoder).eval()
    if tp_params:
        check_model_tp(tower, n_seq)
        ctx = SequenceContext(r_seq, n_seq, seq_group, r_seq, n_seq, seq_group)
    else:
        ctx = SequenceContext(seq_rank=r_seq, seq_size=n_seq, seq_group=seq_group)
    shard_layers_(tower, ctx)

    @torch.no_grad()
    def wrapped(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, s = input_ids.shape
        # shards need divisible dims: pad tokens with mask-0 positions (inert
        # under the masked attention) and the batch with zero rows
        pad_s, pad_b = (-s) % n_seq, (-b) % n_batch
        if pad_s or pad_b:
            input_ids = F.pad(input_ids, (0, pad_s, 0, pad_b))
            attention_mask = F.pad(attention_mask, (0, pad_s, 0, pad_b))
        bl, sl = (b + pad_b) // n_batch, (s + pad_s) // n_seq
        ids = input_ids[r_batch * bl:(r_batch + 1) * bl, r_seq * sl:(r_seq + 1) * sl]
        mask = attention_mask[r_batch * bl:(r_batch + 1) * bl]
        x = tower.embeddings(ids, start=r_seq * sl)
        bias = torch.where(mask > 0, 0.0, -1e10).to(torch.float32)
        with routing(batch_group):
            for layer in tower.encoder.layer:
                x = layer(x, bias)
        out = all_gather_dim(all_gather_dim(x, 1, seq_group), 0, batch_group)
        return out[:b, :s]

    return wrapped
