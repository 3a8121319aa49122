"""Sequence parallelism of the port (clip_for_dl_tpu_torch/parallel/sp.py)
against the JAX package's single-device text-tower forward, as
tests/test_sp.py holds JAX's ``sequence_sharded_fn``: within 2e-5.

Four gloo ranks (``clip_for_dl_tpu_torch.testing.ranks``, one launch)
take the layouts 2 x 2 and 1 x 4 (the sequence over the model axis); a
BERT of hidden 16, 4 heads, MLP 32, 2 layers runs four rows of 64 tokens
and of 50 (not a multiple of the shards: padded with mask 0 and sliced
back), the last five positions of each row masked, with the weights
replicated and with ``tp_params`` (Megatron TP+SP on one axis), its
attention plain and through the packed kernel's wrapper (``flash``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.models.bert import BertEncoder as JBertEncoder
from clip_for_dl_tpu_torch.models import convert
from clip_for_dl_tpu_torch.testing import ranks

torch.set_num_threads(1)

BERT = dict(vocab_size=64, hidden=16, layers=2, heads=4, intermediate=32, max_position=64)
WORLD = 4
LAYOUTS = (2, 4)
LENGTHS = (64, 50)
MODES = (False, True)


@functools.lru_cache(maxsize=None)
def _tower():
    module = JBertEncoder(**BERT)
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(2)

    def fill(path, leaf):
        if str(path[-1].key) == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        if str(path[-1].key) == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    return module, params, {k[2:]: v.numpy() for k, v in convert._bert(params, "t").items()}


def _inputs(s):
    rng = np.random.default_rng(s)
    ids = rng.integers(0, 64, (4, s)).astype(np.int32)
    mask = np.ones((4, s), np.int32)
    mask[:, s - 5:] = 0  # a ragged tail: the padded positions must be inert
    return {"ids": ids, "mask": mask}


@functools.lru_cache(maxsize=None)
def _jax(s):
    module, params, _ = _tower()
    return np.asarray(module.apply({"params": params},
                                   *(jnp.asarray(v) for v in _inputs(s).values())))


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    cases = {f"sp_{s}_{t}_{m}{'_flash' * f}": dict(
        kind="sp", tower="bert", config=dict(BERT, flash=f), state=_tower()[2],
        inputs=_inputs(s), tp=t, tp_params=m)
        for s in LENGTHS for t in LAYOUTS for m in MODES for f in (False, True)}
    return ranks.launch(cases, WORLD, str(tmp_path_factory.mktemp("sp_ranks")))


@pytest.mark.parametrize("tp_params", MODES)
@pytest.mark.parametrize("t", LAYOUTS)
@pytest.mark.parametrize("s", LENGTHS)
def test_sequence_sharded_equals_the_jax_forward(rank_results, s, t, tp_params):
    want = _jax(s)
    for r in range(WORLD):
        got = rank_results[r][f"sp_{s}_{t}_{tp_params}"]["out"]
        assert got.shape == want.shape == (4, s, 16)
        np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("tp_params", MODES)
@pytest.mark.parametrize("t", LAYOUTS)
@pytest.mark.parametrize("s", LENGTHS)
def test_sequence_sharded_flash_equals_the_jax_forward(rank_results, s, t, tp_params):
    """The same with the tower's attention through ``flash_attention_packed``
    (its plain version here): q|k|v gathered packed."""
    want = _jax(s)
    for r in range(WORLD):
        got = rank_results[r][f"sp_{s}_{t}_{tp_params}_flash"]["out"]
        assert got.shape == want.shape == (4, s, 16)
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_one_rank_is_the_plain_forward():
    """Without a process group the layout is 1 x 1 and the function is the
    tower's forward (B3 over the whole sequence, the MLP on every row)."""
    from clip_for_dl_tpu_torch.models.bert import BertEncoder
    from clip_for_dl_tpu_torch.parallel.sp import sequence_sharded_fn
    from clip_for_dl_tpu_torch.parallel.tp import create_dp_tp_mesh

    enc = BertEncoder(**BERT, flash=True).eval()
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in _tower()[2].items()})
    ids, mask = (torch.from_numpy(v) for v in _inputs(50).values())
    got = sequence_sharded_fn(enc, create_dp_tp_mesh(1))(ids, mask)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), enc(ids, mask).numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _jax(50), atol=2e-5)
