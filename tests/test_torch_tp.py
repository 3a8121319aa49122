"""Tensor parallelism of the port (clip_for_dl_tpu_torch/parallel/tp.py,
common.py, the TP paths of models/bert.py and models/vit.py, the
zero-shot engine with a mesh) against the JAX package's
(clip_for_dl_tpu/parallel/tp.py; tests/test_tp.py holds it against its own
single-device forward and step), on the CPU in fp32.

Four gloo ranks (``clip_for_dl_tpu_torch.testing.ranks``, one launch for
every case of the file) take the 2-D layouts 2 x 2 and 1 x 4; the JAX side
runs single-device, as tests/test_tp.py's reference does. The geometry is
tests/test_tp.py's: BERT hidden 16, 4 heads, MLP 32, 2 layers; the step's
CXRClip with BERT 2 x 32 (4 heads, MLP 64), ResNet (1, 1, 1, 1) at width 8
and 32 px images. The bounds are JAX's own: 2e-5 on a forward
(tests/test_tp.py:136), loss rtol 1e-4 and parameters atol 2e-4 on the step
(:162), atol 2e-4 / rtol 1e-4 on the engine (:218). The step runs with the
attention dropout at 0.1 (both sides fed the same per-layer seeds, the
other dropouts off: the JAX side patches flax's Dropout) and at 0.
"""

import copy
import functools
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.core.config import ZeroShotConfig as JZeroShotConfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.bert import BertEncoder as JBertEncoder
from clip_for_dl_tpu.models.vit import ViT as JViT
from clip_for_dl_tpu.ops import flash_attention as jfa
from clip_for_dl_tpu.parallel import create_dp_tp_mesh as jcreate_dp_tp_mesh
from clip_for_dl_tpu.parallel import tp_spec as jtp_spec
from clip_for_dl_tpu.parallel import validate_tp as jvalidate_tp
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_step
from clip_for_dl_tpu.train.optim import make_label_fn as jmake_label_fn
from clip_for_dl_tpu.zeroshot import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu.zeroshot import prompts_for_family as jprompts_for_family
from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
from clip_for_dl_tpu_torch.models import convert, state_dict_from_jax
from clip_for_dl_tpu_torch.models.bert import BertLayer
from clip_for_dl_tpu_torch.models.bert import layer_shares as bert_shares
from clip_for_dl_tpu_torch.models.vit import ViTEncoderLayer
from clip_for_dl_tpu_torch.models.vit import layer_shares as vit_shares
from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.parallel import tp
from clip_for_dl_tpu_torch.parallel.common import Mesh2D, rank_grid
from clip_for_dl_tpu_torch.testing import ranks
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.train import TrainState, make_label_fn, make_optimizer

torch.set_num_threads(1)

BERT = dict(vocab_size=64, hidden=16, layers=2, heads=4, intermediate=32, max_position=16)
VIT = dict(image_size=32, patch=16, hidden=16, layers=2, heads=4, mlp_dim=32)
STEP_CFG = dict(image_size=32, max_text_length=16, vocab_size=128, text_embedding_dim=32,
                text_layers=2, text_heads=4, text_intermediate_dim=64, shared_embedding_dim=64,
                resnet_stages=(1, 1, 1, 1), resnet_width=8, flash_attention=True)
GROUPS = ["image_tower", "text_tower", "image_projector", "text_projector"]
LRS = {"image_tower": 1e-4, "text_tower": 1e-5, "image_projector": 1e-3,
       "text_projector": 1e-3, "default": 1e-4}
WORLD = 4
LAYOUTS = (2, 4)  # tp over the four ranks: 2 x 2 and 1 x 4
RATES = (0.1, 0.0)


def _filled(tree, rng):
    """Random values for every leaf of a flax shape tree (fan-in-scaled
    kernels, non-zero biases, norm scales near 1)."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "mean":
            v = rng.uniform(-0.5, 0.5, leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@functools.lru_cache(maxsize=None)
def _tower(kind):
    """(JAX module, params, port state dict of the bare tower)."""
    if kind == "bert":
        module = JBertEncoder(**BERT)
        shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
        params = _filled(shapes["params"], np.random.default_rng(5))
        sd = convert._bert(params, "t")
    else:
        module = JViT(**VIT)
        shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
        params = _filled(shapes["params"], np.random.default_rng(6))
        sd = convert._vit(params, "t")
    return module, params, {k[2:]: v.numpy() for k, v in sd.items()}


def _tower_inputs(kind):
    rng = np.random.default_rng(7)
    if kind == "bert":
        mask = np.ones((8, 12), np.int32)
        mask[1, 7:] = mask[5, 3:] = 0
        return {"ids": rng.integers(0, 64, (8, 12)).astype(np.int32), "mask": mask}
    return {"images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_forward(kind):
    module, params, _ = _tower(kind)
    inputs = [jnp.asarray(v) for v in _tower_inputs(kind).values()]
    return np.asarray(module.apply({"params": params}, *inputs))


@functools.lru_cache(maxsize=None)
def _step_variables():
    jmodel = JCXRClip(JModelConfig(**STEP_CFG))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    return {"params": _filled(shapes["params"], np.random.default_rng(1)),
            "batch_stats": _filled(shapes["batch_stats"], np.random.default_rng(2))}


def _step_batch():
    rng = np.random.default_rng(3)
    mask = np.ones((8, 16), np.int32)
    for i, n in enumerate((7, 3, 16, 12, 5, 16, 10, 4)):
        mask[i, n:] = 0
    return {"images": rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8),
            "input_ids": rng.integers(0, 128, (8, 16)).astype(np.int32),
            "attention_mask": mask}


def _seeds():
    """The attention dropout's per-layer seeds [B, 1] over the global batch."""
    rng = np.random.default_rng(11)
    return [rng.integers(-2 ** 31, 2 ** 31, (8, 1)).astype(np.int32)
            for _ in range(STEP_CFG["text_layers"])]


@functools.lru_cache(maxsize=None)
def _jax_step(rate):
    """JAX's single-device step (tests/test_tp.py's), its attention seeds
    the given ones in layer order and flax's Dropout the identity: (loss,
    the port's state dict after, the clipped gradient in the port's names,
    the seed calls). The gradient is Adam's first moment over (1 − b1)."""
    seeds, calls = _seeds(), []

    def fixed(rng, batch):
        calls.append(batch)
        return jnp.asarray(seeds[(len(calls) - 1) % len(seeds)])

    cfg = JModelConfig(**dict(STEP_CFG, dropout=rate))
    jmodel = JCXRClip(cfg, dtype=jnp.float32)
    tx = base_transform(weight_decay=1e-3)
    step = jmake_step(jmodel, tx, jmake_label_fn(GROUPS), temperature=2.0, image_size=32,
                      compute_dtype=jnp.float32)
    variables = _step_variables()
    batch = {k: jnp.asarray(v) for k, v in _step_batch().items()}
    with mock.patch.object(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x), \
            mock.patch.object(jfa, "dropout_seeds_from_rng", fixed):
        state, metrics = jax.jit(step)(JTrainState.create(variables, tx), batch, LRS,
                                       jax.random.key(1))
    after = jax.device_get(state)
    mu = optax.tree_utils.tree_get(after.opt_state, "mu")
    grads = jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)
    jgrads = {k: v for k, v in state_dict_from_jax(grads, after.batch_stats).items()
              if not k.endswith(("running_mean", "running_var"))}
    return (float(metrics["loss"]), state_dict_from_jax(after.params, after.batch_stats),
            jgrads, calls)


def _engine_setup():
    vocab = build_dev_vocab(DISEASE_LABELS)
    cfg = dict(STEP_CFG, text_heads=2, vocab_size=len(vocab), flash_attention=False)
    images = np.random.default_rng(9).integers(0, 255, (10, 32, 32, 3), dtype=np.uint8)
    return vocab, cfg, images


@functools.lru_cache(maxsize=None)
def _engine_variables(cfg_items):
    jmodel = JCXRClip(JModelConfig(**dict(cfg_items)))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    return {"params": _filled(shapes["params"], np.random.default_rng(4)),
            "batch_stats": _filled(shapes["batch_stats"], np.random.default_rng(8))}


def _cases():
    cases = {}
    for kind, cfg in (("bert", BERT), ("vit", VIT)):
        for t in LAYOUTS:
            cases[f"fwd_{kind}_{t}"] = dict(kind="tp_forward", tower=kind, config=cfg,
                                            state=_tower(kind)[2], inputs=_tower_inputs(kind),
                                            tp=t)
    for rate in RATES:
        for t in LAYOUTS:
            cases[f"step_{rate}_{t}"] = _step_case(rate, t)
    vocab, cfg, images = _engine_setup()
    rng = np.random.default_rng(12)
    cases["group_serve"] = dict(kind="group_serve", beat=0.2, idle=1.0, batches=[
        rng.integers(0, 255, (n, 4, 4, 3), dtype=np.uint8) for n in (1, 3, 8)])
    cases["engine"] = dict(kind="tp_engine", tp=2, config=cfg,
                           variables=_engine_variables(tuple(cfg.items())), vocab=vocab,
                           images=images, image_size=32, max_text_length=16)
    return cases


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Every case of the file on the four ranks, in one launch."""
    return ranks.launch(_cases(), WORLD, str(tmp_path_factory.mktemp("tp_ranks")))


# -- (a) the rules, the layout ---------------------------------------------------


def _jax_specs(params):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, v: out.__setitem__(tuple(str(p.key) for p in path), jtp_spec(path, v)),
        params)
    return out


@pytest.mark.parametrize("tower", ["resnet_bert", "vit"])
def test_tp_spec_through_the_convert_map_equals_jax(tower):
    """Every leaf: the JAX spec of each JAX leaf that a port tensor holds
    (found by giving every leaf its own constant value) is the port's
    spec, the kernel's sharded output columns being the torch weight's
    rows, the ViT's three q/k/v kernels the thirds of ``in_proj``."""
    cfg = dict(STEP_CFG)
    if tower == "vit":
        cfg.update(image_tower="vit_b16", vit_patch=16, vit_hidden=16, vit_layers=2,
                   vit_heads=4, vit_mlp_dim=32)
    jmodel = JCXRClip(JModelConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    leaves = jax.tree_util.tree_leaves_with_path(shapes["params"])
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes["params"]),
        [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    names = [tuple(str(p.key) for p in path) for path, _ in leaves]
    jspecs = _jax_specs(shapes["params"])
    sd = state_dict_from_jax(tagged, _filled(shapes.get("batch_stats", {}),
                                             np.random.default_rng(0)))
    covered, sharded = set(), 0
    for name, t in sd.items():
        if name.endswith(("running_mean", "running_var")):
            assert tp.tp_spec(name, t) == tp.REPLICATED
            continue
        tags = sorted(set(np.unique(t.numpy()).astype(int).tolist()))
        sources = [names[i - 1] for i in tags]
        covered.update(sources)
        want = [jspecs[s] for s in sources]
        spec = tp.tp_spec(name, t)
        if all(w == jax.sharding.PartitionSpec() for w in want):
            assert spec == tp.REPLICATED, name
            continue
        sharded += 1
        assert len(set(want)) == 1, name
        jdim = [i for i, a in enumerate(want[0]) if a == "model"]
        assert len(jdim) == 1, name
        # a 2-D kernel [in, out] is the torch weight [out, in]
        torch_dim = (1 - jdim[0]) if t.dim() == 2 else jdim[0]
        assert spec == tp.Spec(torch_dim, len(sources)), (name, spec, want)
    assert covered == set(names)
    # sharded tensors a layer: BERT q, k, v and intermediate (weight and
    # bias), the two row-parallel weights; the ViT in_proj (two), out_proj,
    # mlp.0 (two), mlp.3
    assert sharded == 10 * 2 + (6 * 2 if tower == "vit" else 0)


def test_validate_tp_and_the_rank_layout_equal_jax(eight_devices):
    for heads, inter, t in ((12, 3072, 4), (12, 3072, 8), (4, 32, 3), (4, 30, 4)):
        try:
            jvalidate_tp(heads, inter, t)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            tp.validate_tp(heads, inter, t)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want
    for t in (1, 2, 4, 8):
        mesh = jcreate_dp_tp_mesh(t)
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        np.testing.assert_array_equal(rank_grid(8, t), ids)
    with pytest.raises(ValueError) as jerr:
        jcreate_dp_tp_mesh(3)
    with pytest.raises(ValueError) as err:
        rank_grid(8, 3)
    assert str(err.value) == str(jerr.value)
    single = tp.create_dp_tp_mesh(1)
    assert (single.data_group, single.model_group, single.shape) == (
        None, None, {"data": 1, "model": 1})


def test_shard_and_gather_state_dict_round_trip():
    _, _, sd = _tower("vit")
    sd = {f"image_tower.{k}": torch.from_numpy(v) for k, v in sd.items()}
    for t in (2, 4):
        shards = [tp.shard_state_dict_tp(sd, r, t) for r in range(t)]
        w = "image_tower.encoder.layers.encoder_layer_0.self_attention.in_proj_weight"
        third = 16 // t
        # rank 1's q, k and v rows: its heads of each third
        np.testing.assert_array_equal(
            shards[1][w].numpy(),
            np.concatenate([sd[w].numpy()[o + third:o + 2 * third] for o in (0, 16, 32)]))
        back = tp.gather_state_dict_tp(shards)
        assert all(torch.equal(back[k], sd[k]) for k in sd)


def _share_mesh(t, rank=0):
    return Mesh2D(rank_grid(t, t), ("data", "model"), rank, None, None)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("flash", [True, False])
def test_layer_shares_equal_the_unsharded_layer(flash, rate):
    """Every rank's share of a BERT layer run in one process, the partial
    products summed there (the card's emulation, chip_smoke phase 16): the
    output, the input gradient and every weight gradient (gathered) of the
    unsharded layer in train mode, the dropout masks drawn once; tp = 1 is
    the plain path bit for bit."""
    torch.manual_seed(0)
    layer = BertLayer(16, 4, 32, dropout=rate, flash=flash).train()
    x = torch.randn(3, 10, 16, requires_grad=True)
    bias = torch.zeros(3, 10)
    bias[0, 7:] = -1e10
    want = layer(x, bias, torch.Generator().manual_seed(5))
    dy = torch.randn_like(want)
    want.backward(dy)
    wgrads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    wx, x.grad = x.grad.clone(), None
    for t in (1, 2, 4):
        shares = [tp.tensor_parallel_(copy.deepcopy(layer), _share_mesh(t), share=r)
                  for r in range(t)]
        got = bert_shares(shares, x, bias, torch.Generator().manual_seed(5))
        got.backward(dy)
        if t == 1:
            assert torch.equal(got, want) and torch.equal(x.grad, wx)
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=2e-5)
        np.testing.assert_allclose(x.grad.numpy(), wx.numpy(), atol=2e-5)
        for n, p in layer.named_parameters():
            g = tp.gather_tensor([dict(s.named_parameters())[n].grad for s in shares],
                                 tp.layer_spec(n, p))
            np.testing.assert_allclose(g.numpy(), wgrads[n].numpy(), atol=2e-5, err_msg=n)
        x.grad = None


@pytest.mark.parametrize("flash", [True, False])
def test_vit_layer_shares_equal_the_unsharded_layer(flash):
    torch.manual_seed(1)
    layer = ViTEncoderLayer(16, 4, 32, flash=flash).train()
    x = torch.randn(3, 10, 16, requires_grad=True)
    want = layer(x)
    dy = torch.randn_like(want)
    want.backward(dy)
    wx, x.grad = x.grad.clone(), None
    for t in (1, 2, 4):
        shares = [tp.tensor_parallel_(copy.deepcopy(layer), _share_mesh(t), share=r)
                  for r in range(t)]
        got = vit_shares(shares, x) if t > 1 else shares[0](x)
        got.backward(dy)
        if t == 1:
            assert torch.equal(got, want)
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=2e-5)
        np.testing.assert_allclose(x.grad.numpy(), wx.numpy(), atol=2e-5)
        x.grad = None


def test_shard_state_tp_shards_the_moments_and_the_ema():
    """After a step on the whole model, each rank's shard of the AdamW
    moments and of the EMA is the rank's slice of the whole one."""
    from clip_for_dl_tpu_torch.core.config import ModelConfig
    from clip_for_dl_tpu_torch.models import CXRClip, init_weights

    model = init_weights(CXRClip(ModelConfig(**STEP_CFG)), torch.Generator().manual_seed(0))
    opt = make_optimizer(model, make_label_fn(GROUPS), weight_decay=1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    for g in opt.param_groups:
        g["lr"] = 1e-3
    opt.step()
    whole = TrainState.create(model, opt, ema=True)
    name = "text_tower.encoder.layer.1.intermediate.dense.weight"
    full_p = dict(model.named_parameters())[name]
    full_m = opt.state[full_p]["exp_avg"].clone()
    for r in range(2):
        state = copy.deepcopy(whole)
        tp.shard_state_tp(state, _share_mesh(2, r))
        p = dict(state.model.named_parameters())[name]
        assert p.shape == (32, 32)
        assert torch.equal(state.optimizer.state[p]["exp_avg"], full_m[r * 32:(r + 1) * 32])
        assert torch.equal(state.ema_params[name], full_p.detach()[r * 32:(r + 1) * 32])
        assert p.tp_spec == tp.Spec(0)


def test_fused_mlp_is_refused_under_tp_as_in_jax():
    from clip_for_dl_tpu_torch.models.vit import ViT

    vit = ViT(**VIT, fused_mlp=True)
    with pytest.raises(ValueError, match="composes with data parallelism only"):
        tp.tensor_parallel_(vit, _share_mesh(2), share=0)
    tp.tensor_parallel_(ViT(**VIT, fused_mlp=True), _share_mesh(1), share=0)


# -- (b) the forward --------------------------------------------------------------


@pytest.mark.parametrize("t", LAYOUTS)
@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_tp_forward_equals_jax(rank_results, kind, t):
    want = _jax_forward(kind)
    for r in range(WORLD):
        np.testing.assert_allclose(rank_results[r][f"fwd_{kind}_{t}"]["out"], want, atol=2e-5)


# -- (c) the step -----------------------------------------------------------------


def _step_case(rate, t, plain=False):
    return dict(kind="tp_step", tp=t, plain=plain, config=dict(STEP_CFG, dropout=rate),
                variables=_step_variables(), batch=_step_batch(), seeds=_seeds(),
                groups=GROUPS, lrs=LRS, weight_decay=1e-3, clip=1.0, image_size=32,
                mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))


@functools.lru_cache(maxsize=None)
def _port_single_step(rate):
    """The port's unsharded step in this process (no group) on the same case."""
    out = ranks._tp_step_case(_step_case(rate, 1, plain=True))
    return out["loss"], {k: torch.from_numpy(v) for k, v in out["state"].items()}


def _gathered(outs, row, key):
    return tp.gather_state_dict_tp([
        {k: torch.from_numpy(v) for k, v in outs[int(r)][key].items()} for r in row])


@pytest.mark.parametrize("t", LAYOUTS)
@pytest.mark.parametrize("rate", RATES)
def test_tp_step_equals_the_single_device_step(rank_results, rate, t):
    """The TP step (its shards gathered from the model ranks of each data
    slice) against the single-device step, as tests/test_tp.py:162 holds
    JAX's: the port's own unsharded step, loss rtol 1e-4 and every
    parameter atol 2e-4 (BatchNorm statistics 1e-5); JAX's, the loss rtol
    1e-4 and every parameter atol 2e-4 where Adam's first update
    g / (|g| + eps) is conditioned (|g| > 1e-4 of the tensor's largest, g
    JAX's clipped gradient), within 2 · lr elsewhere, where a gradient's
    last bits flip the update's sign (tests/test_torch_train.py:202). The
    seeds were drawn once a layer on both sides."""
    loss, want, jgrads, calls = _jax_step(rate)
    single_loss, single = _port_single_step(rate)
    outs = [rank_results[r][f"step_{rate}_{t}"] for r in range(WORLD)]
    grid = np.asarray(outs[0]["grid"])
    label_fn = make_label_fn(GROUPS)
    for out in outs:
        np.testing.assert_allclose(out["loss"], single_loss, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-4, atol=1e-4)
        assert out["seed_calls"] == (STEP_CFG["text_layers"] if rate else 0)
    assert len(calls) == (STEP_CFG["text_layers"] if rate else 0)
    for row in grid:
        got, grads = _gathered(outs, row, "state"), _gathered(outs, row, "grads")
        assert set(got) == set(want) == set(single)
        for k, w in want.items():
            atol = 1e-5 if k.endswith(("running_mean", "running_var")) else 2e-4
            np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), atol=atol, err_msg=k)
            if k not in grads:
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol, err_msg=k)
                continue
            jg = jgrads[k]
            diff = (got[k] - w).abs()
            big = jg.abs() > 1e-4 * jg.abs().max()
            assert not big.any() or float(diff[big].max()) <= 2e-4, k
            assert float(diff.max()) <= 2 * LRS[label_fn(tuple(k.split(".")))], k


# -- (d) the engine ---------------------------------------------------------------


def test_tp_engine_matches_jax_on_an_uneven_batch(rank_results):
    vocab, cfg, images = _engine_setup()
    variables = _engine_variables(tuple(cfg.items()))
    engine = JZeroShotEngine(JCXRClip(JModelConfig(**cfg)), variables, JBertTokenizer(vocab),
                             DISEASE_LABELS, JZeroShotConfig(), image_size=32,
                             max_text_length=16, compute_dtype=jnp.float32)
    engine.build_text_features(jprompts_for_family("prediction", DISEASE_LABELS))
    want = engine.logits(images)
    for r in range(WORLD):
        got = rank_results[r]["engine"]["logits"]
        assert got.shape == want.shape == (10, len(DISEASE_LABELS))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# -- (f) the head offset ----------------------------------------------------------


@pytest.mark.parametrize("h0,h", [(0, 2), (2, 2), (1, 3), (3, 1)])
def test_plain_attention_with_a_head_offset_is_the_unsharded_heads(h0, h):
    """Heads h0 … h0 + h − 1 alone, numbered from h0 in the dropout hash,
    are those heads of the unsharded call, bit for bit, forward and
    backward; the public entry points (the seeds offset for the kernels)
    give the same bits."""
    B, N, H, D = 3, 20, 4, 8
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, N, 3 * H * D, generator=g)
    do = torch.randn(B, N, H * D, generator=g)
    seeds = fa.dropout_seeds(torch.Generator().manual_seed(1), B)
    kw = dict(dropout_rate=0.3, dropout_seeds=seeds)
    full = fa.flash_attention_packed_reference(qkv, H, **kw).view(B, N, H, D)
    dfull = fa.flash_attention_packed_bwd_reference(qkv, do, H, **kw).view(B, N, 3, H, D)
    q, k, v = qkv.view(B, N, 3, H, D).unbind(2)
    local = torch.cat([t[:, :, h0:h0 + h].reshape(B, N, -1) for t in (q, k, v)], -1)
    dlocal = do.view(B, N, H, D)[:, :, h0:h0 + h].reshape(B, N, -1)
    got = fa.flash_attention_packed_reference(local, h, **kw, head_offset=h0)
    assert torch.equal(got, full[:, :, h0:h0 + h].reshape(B, N, -1))
    assert torch.equal(fa.flash_attention_packed(local, h, **kw, head_offset=h0), got)
    dgot = fa.flash_attention_packed_bwd_reference(local, dlocal, h, **kw, head_offset=h0)
    assert torch.equal(dgot, dfull[:, :, :, h0:h0 + h].reshape(B, N, -1))
    assert torch.equal(fa.flash_attention_packed_bwd(local, dlocal, h, **kw, head_offset=h0),
                       dgot)
    # offset 0 hands the kernels the seeds themselves
    assert fa.offset_seeds(seeds, 0) is seeds


# -- serving over a group ---------------------------------------------------------------


def test_group_server_ranks_follow_rank_zeros_batches(rank_results):
    """serving.GroupEngine on rank 0 and serving.follow on ranks 1-3 (a
    stand-in engine that scores a row by its sum): rank 0 idles past the
    idle beat (0.2 s here) and the followers take the beats; each batch
    reaches every rank with its bytes and shape, in order; rank 0 answers
    from its own dispatch; the stop ends every follower's loop."""
    batches = _cases()["group_serve"]["batches"]
    lead = rank_results[0]["group_serve"]
    assert lead["beats"] >= 2
    for got, b in zip(lead["logits"], batches):
        np.testing.assert_array_equal(got[:, 0], b.reshape(len(b), -1).sum(1))
    for r in range(WORLD):
        out = rank_results[r]["group_serve"]
        assert out["seen"] == [b.tolist() for b in batches]
        if r:
            assert out["followed"] == len(batches)


@pytest.mark.parametrize("fail", [0, 1])
def test_group_server_failure_on_one_rank_ends_the_group(fail, tmp_path):
    """The stand-in engine of rank ``fail`` raises at its second batch, on
    two ranks started without torchrun: rank 0's engine stops for good (its
    ``on_failure`` called once, a later dispatch refused) and the server
    would shut down; the follower leaves the group, its log naming the
    failure; all within a fraction of the collectives' 60 s timeout, since
    a rank's exit fails the other's pending collective at once."""
    import re
    import time

    rng = np.random.default_rng(13)
    batches = [rng.integers(0, 255, (n, 4, 4, 3), dtype=np.uint8) for n in (2, 3, 1)]
    case = dict(kind="group_serve_fault", fail=fail, at=1, beat=0.2, wait=20.0, batches=batches)
    t0 = time.monotonic()
    (code0, log0, res0), (code1, log1, _) = ranks.launch_unsupervised(
        {"fault": case}, 2, str(tmp_path), timeout=60.0)
    took = time.monotonic() - t0
    assert code0 == 0, log0
    lead = res0["fault"]
    assert lead["on_failure"] == 1, lead
    assert lead["raised"][-1] == "the group engine has stopped", lead
    assert "the engine failed under the process group" in log0, log0
    if fail == 0:
        assert lead["seen"] == 1 and "the stand-in engine fails" in lead["failed"], lead
    else:
        assert lead["seen"] >= 2, lead
    assert code1 != 0, log1
    assert re.search(r"rank 1: the group failed after \d+ batches", log1), log1
    assert took < 45, took
