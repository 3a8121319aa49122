"""The Switch-MoE text tower of the port (clip_for_dl_tpu_torch/models/moe.py,
the MoE layers of models/bert.py, the steps' aux loss, ``--moe-experts`` in
the CLI) against the JAX package's (clip_for_dl_tpu/models/moe.py; its own
tests are tests/test_moe.py), on the CPU in fp32 with dropout 0.

The layer's geometry is tests/test_moe.py's (E = 4 experts, hidden 16, MLP
32, a batch of 2 x 8 tokens), its parameters drawn from a seed and its
last tokens padding. The steps' CXRClip is tests/test_torch_dp.py's (ResNet
(1, 1, 1, 1) at width 8, BERT 2 x 64 with 2 heads and MLP 128, 32 px) with
its second BERT layer a MoE of 4 experts; both sides update by SGD at
learning rate 1 after the clip at 1.0, so that a parameter's change is its
clipped gradient. Bounds: the layer's forward 1e-6 absolute, its gradients
1e-5 of each tensor's largest entry; a step's loss 1e-5 relative and each
parameter's change 1e-5 of its tensor's largest change (the ResNet's 1e-4,
as tests/test_torch_train.py holds it; plus after − before's fp32
resolution); the tensor-parallel engine at the TP tests' 2e-4 / 1e-4
(tests/test_torch_tp.py).
"""

import argparse
import copy
import functools
import importlib
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
from clip_for_dl_tpu.models.moe import SwitchMoEMLP as JSwitchMoEMLP
from clip_for_dl_tpu.models.torch_export import export_bert as jexport_bert
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_pretrain_step
from clip_for_dl_tpu.train import make_multiview_train_step as jmake_multiview_step
from clip_for_dl_tpu.train.optim import make_label_fn as jmake_label_fn
from clip_for_dl_tpu.zeroshot import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu.zeroshot import prompts_for_family as jprompts_for_family
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, DISEASE_LABELS, ModelConfig
from clip_for_dl_tpu_torch.models import CXRClip, convert, state_dict_from_jax
from clip_for_dl_tpu_torch.models.bert import BertEncoder, layer_shares
from clip_for_dl_tpu_torch.models.lora import lora_paths
from clip_for_dl_tpu_torch.models.moe import SwitchMoEMLP, capacity, route, routing
from clip_for_dl_tpu_torch.ops import mlp_train
from clip_for_dl_tpu_torch.parallel import tp
from clip_for_dl_tpu_torch.parallel.common import Mesh2D, rank_grid
from clip_for_dl_tpu_torch.testing import ranks
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab

torch.set_num_threads(1)

E, D, F = 4, 16, 32
FACTORS = (1.5, 0.5, 1e-6)  # C = 6, 2 and 1 for the layer's 16 tokens
STEP_CFG = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=64,
    text_layers=2, text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    dropout=0.0, flash_attention=True, text_moe_experts=4, text_moe_every=2,
)
GROUPS = ["image_tower", "text_tower", "image_projector", "text_projector"]
LRS = {**{g: 1.0 for g in GROUPS}, "default": 1.0}
PREP = dict(image_size=32, mean=CLIP_MEAN, std=CLIP_STD)


# -- the layer ---------------------------------------------------------------------


def _layer_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[0, 6:] = mask[1, 3:] = 0
    return x, mask


@functools.lru_cache(maxsize=None)
def _layer_params():
    x, _ = _layer_inputs()
    params = JSwitchMoEMLP(E, F).init(jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a + 0.1 * rng.standard_normal(a.shape),
                                             np.float32), params)


def _port_layer(factor):
    params = _layer_params()
    layer = SwitchMoEMLP(D, F, E, factor)
    sd = {"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
          "router.bias": torch.from_numpy(params["router"]["bias"].copy())}
    sd.update({k: torch.from_numpy(params[k].copy()) for k in ("wi", "bi", "wo", "bo")})
    layer.load_state_dict(sd, strict=True)
    return layer


@functools.lru_cache(maxsize=None)
def _jax_layer(factor):
    """JAX's layer on the inputs: (out, aux, gradients of Σ out² + 3·aux
    by the parameters and by x)."""
    x, mask = _layer_inputs()
    module = JSwitchMoEMLP(E, F, capacity_factor=factor)

    def loss(params, x):
        y, sown = module.apply({"params": params}, x, jnp.asarray(mask), mutable=["losses"])
        aux = jax.tree.leaves(sown)[0]
        return jnp.sum(y ** 2) + 3.0 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        _layer_params(), jnp.asarray(x))
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _port_run(factor):
    x, mask = _layer_inputs()
    layer = _port_layer(factor)
    xt = torch.from_numpy(x).requires_grad_()
    with routing() as aux:
        y = layer(xt, torch.from_numpy(mask))
    (torch.sum(y ** 2) + 3.0 * aux[0]).backward()
    return layer, y.detach().numpy(), aux, xt.grad.numpy()


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("factor", FACTORS)
def test_layer_matches_jax_with_a_padding_mask(factor):
    """Forward at 1e-6; the gradients of x, the router and wi/bi/wo/bo at
    1e-5 of each one's largest entry; the aux loss at 1e-6."""
    layer, y, aux, gx = _port_run(factor)
    jy, jaux, jgp, jgx = _jax_layer(factor)
    np.testing.assert_allclose(y, jy, atol=1e-6, rtol=0)
    assert len(aux) == 1 and float(aux[0].detach()) == pytest.approx(jaux, abs=1e-6)
    _close(gx, jgx, 1e-5, "x")
    _close(layer.router.weight.grad.numpy().T, jgp["router"]["kernel"], 1e-5, "router")
    _close(layer.router.bias.grad.numpy(), jgp["router"]["bias"], 1e-5, "router bias")
    for k in ("wi", "bi", "wo", "bo"):
        _close(getattr(layer, k).grad.numpy(), jgp[k], 1e-5, k)


def _routed_rows(y, mask):
    return (np.abs(y).sum(-1) > 0) & (mask > 0)


def test_capacity_drops_tokens():
    """At a factor near 0 the capacity is 1: at most one token an expert
    gets an update, each at a different expert; the rest pass with a zero
    update. At 0.5 (C = 2) some real tokens are dropped, at 1.5 none."""
    x, mask = _layer_inputs()
    assert [capacity(16, E, f) for f in FACTORS] == [6, 2, 1]
    _, y, _, _ = _port_run(1e-6)
    routed = _routed_rows(y, mask)
    assert 1 <= routed.sum() <= E
    r = route(_port_layer(1e-6), torch.from_numpy(x), torch.from_numpy(mask))
    kept = (r.slot < E * r.capacity).numpy()
    np.testing.assert_array_equal(kept.reshape(2, 8), routed)
    assert len(set(r.expert.numpy()[kept].tolist())) == kept.sum()
    assert _routed_rows(_port_run(0.5)[1], mask).sum() < mask.sum()
    assert _routed_rows(_port_run(1.5)[1], mask).sum() == mask.sum()


def test_padding_tokens_are_inert():
    """Pads get a zero update and take no capacity: changing their inputs
    changes no real token's output nor the aux loss, which stays >= 1."""
    x, mask = _layer_inputs()
    layer = _port_layer(0.5)
    other = x.copy()
    other[mask == 0] = np.random.default_rng(9).standard_normal(((mask == 0).sum(), D))
    outs, auxes = [], []
    for v in (x, other):
        with torch.no_grad(), routing() as aux:
            outs.append(layer(torch.from_numpy(v), torch.from_numpy(mask)).numpy())
        auxes.append(float(aux[0]))
    assert np.all(outs[0][mask == 0] == 0) and np.all(outs[1][mask == 0] == 0)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert auxes[0] == auxes[1] >= 1.0 - 1e-6


def test_aux_loss_is_dropped_outside_routing_and_bounded_below_by_one():
    """A uniform router would give exactly 1.0, so any router gives >= 1;
    outside ``routing`` the layer runs and nothing collects its aux."""
    x, _ = _layer_inputs()
    layer = _port_layer(1.5)
    with torch.no_grad():
        plain = layer(torch.from_numpy(x))
        with routing() as aux:
            inside = layer(torch.from_numpy(x))
    assert torch.equal(plain, inside) and float(aux[0]) >= 1.0 - 1e-6


# -- the tower -----------------------------------------------------------------------


@pytest.mark.parametrize("every", [2, 3])
def test_moe_every_and_the_tower_match_jax(every):
    """Layers i with i % every == every − 1 hold ``moe_mlp`` and
    ``output.LayerNorm`` and no dense MLP; the MoE tower's output equals
    JAX's at 1e-5 and each MoE layer hands one aux loss."""
    cfg = dict(vocab_size=64, hidden=16, layers=4, heads=2, intermediate=32, max_position=16,
               moe_experts=4, moe_every=every)
    jbert = JBertEncoder(**cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    shapes = jax.eval_shape(jbert.init, jax.random.key(0), jnp.asarray(ids))["params"]
    params = jax.tree.map(lambda t: (rng.standard_normal(t.shape) * 0.3).astype(np.float32),
                          shapes)
    moe = [i for i in range(4) if i % every == every - 1]
    assert [i for i in range(4) if "moe_mlp" in params[f"layer_{i}"]] == moe
    want, sown = jax.jit(functools.partial(jbert.apply, mutable=["losses"]))(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    bert = BertEncoder(**cfg)
    bert.load_state_dict({k[2:]: v for k, v in convert._bert(params, "t").items()}, strict=True)
    names = dict(bert.named_parameters())
    for i in range(4):
        stem = f"encoder.layer.{i}."
        assert (stem + "moe_mlp.wi" in names) == (i in moe)
        assert (stem + "intermediate.dense.weight" in names) == (i not in moe)
        assert (stem + "output.dense.weight" in names) == (i not in moe)
        assert stem + "output.LayerNorm.weight" in names
    with torch.no_grad(), routing() as aux:
        got = bert.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    jaux = [float(v) for v in jax.tree.leaves(sown)]
    assert len(aux) == len(jaux) == len(moe)
    np.testing.assert_allclose([float(a) for a in aux], jaux, atol=1e-6)


def test_state_dict_from_jax_maps_every_moe_leaf():
    """Each leaf of a MoE CXRClip (given its own constant value) lands in
    one port tensor, and the port model loads the whole dict strictly."""
    jmodel = JCXRClip(JModelConfig(**STEP_CFG))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    leaves = jax.tree_util.tree_leaves_with_path(shapes["params"])
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes["params"]),
        [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    sd = state_dict_from_jax(tagged, stats)
    seen = set()
    for name, t in sd.items():
        if not name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            seen |= set(np.unique(t.numpy()).astype(int).tolist())
    assert seen == set(range(1, len(leaves) + 1))
    moe = "text_tower.encoder.layer.1.moe_mlp."
    assert sd[moe + "wi"].shape == (4, 64, 128) and sd[moe + "router.weight"].shape == (4, 64)
    CXRClip(ModelConfig(**STEP_CFG)).load_state_dict(sd, strict=True)


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("wi", "wo"):
        v = rng.standard_normal(shape) / np.sqrt(shape[1])
    elif name in ("scale", "var"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        v = rng.uniform(-0.5, 0.5, shape)
    elif name == "embedding":
        v = rng.standard_normal(shape) * 0.5
    else:
        v = rng.standard_normal(shape) * 0.1
    return np.asarray(v, np.float32)


def _config(factor):
    return dict(STEP_CFG, moe_capacity_factor=factor)


@functools.lru_cache(maxsize=None)
def _variables(factor):
    jmodel = JCXRClip(JModelConfig(**_config(factor)))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(1)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng)}


def _batch(b=8):
    rng = np.random.default_rng(4)
    mask = np.ones((b, 12), np.int32)
    for i, n in enumerate((7, 3, 9, 12, 5, 12, 10, 4)[:b]):
        mask[i, n:] = 0
    labels = (rng.random((b, 16)) < 0.3).astype(np.float32)
    labels[np.arange(b), np.arange(b) % 16] = 1.0
    return {"images": rng.integers(0, 256, (b, 2, 48, 48, 1), dtype=np.uint8),
            "input_ids": rng.integers(5, 64, (b, 12)).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def step_case(kind, factor):
    """The rank-side description of a step case (testing/ranks.py)."""
    b = _batch()
    common = dict(kind=kind, clip=1.0, config=_config(factor), variables=_variables(factor),
                  **PREP)
    if kind == "pretrain":
        batch = {k: b[k] for k in ("input_ids", "attention_mask")}
        batch["images"] = b["images"][:, 0]
        return dict(common, batch=batch, loss="clip_self_distill", temperature=2.0,
                    groups=GROUPS, lrs=LRS)
    return dict(common, temperature=0.07, batch={"images": b["images"], "labels": b["labels"]},
                bank=_bank(), lrs={"default": 1.0})


def _bank():
    f = np.random.default_rng(3).standard_normal((16, 64)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
@mock.patch.object(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
def jax_step(kind, factor, n=None):
    """The JAX step of a case, jitted (over an n-device slice of conftest's
    8-device mesh with ``n``): (loss, parameter change in the port's names)."""
    from clip_for_dl_tpu.core.mesh import create_mesh
    from clip_for_dl_tpu.parallel import data_parallel_step, replicate_state

    case = step_case(kind, factor)
    jmodel = JCXRClip(JModelConfig(**case["config"]))
    variables = case["variables"]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.identity())
    if kind == "pretrain":
        raw = jmake_pretrain_step(jmodel, tx, jmake_label_fn(GROUPS), "clip_self_distill", 2.0,
                                  compute_dtype=jnp.float32, **PREP)
        rest = (case["lrs"], jax.random.key(0))
    else:
        raw = jmake_multiview_step(jmodel, tx, jmake_label_fn([]), temperature=0.07,
                                   compute_dtype=jnp.float32, augment=False, **PREP)
        rest = (jnp.asarray(case["bank"]), case["lrs"], jax.random.key(0))
    state = JTrainState.create(variables, tx)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    if n is None:
        state, metrics = jax.jit(raw)(state, batch, *rest)
    else:
        mesh = create_mesh(n)
        state, metrics = data_parallel_step(raw, mesh, donate_state=False)(
            replicate_state(state, mesh), batch, *rest)
    after = jax.device_get(state)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - b, after.params, variables["params"])
    return float(metrics["loss"]), state_dict_from_jax(delta, after.batch_stats)


def assert_delta_close(got, want, rel, err=""):
    """Each change within ``rel`` of its tensor's largest change (the
    ResNet's within tests/test_torch_train.py's 1e-4: fp32 sums in other
    orders through its BatchNorm), plus the resolution of after − before
    in fp32 (two steps of a weight near 1)."""
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        w = np.asarray(w)
        r = max(rel, 1e-4) if name.startswith("image_tower.") else rel
        np.testing.assert_allclose(got[name], w, atol=r * float(np.abs(w).max()) + 2.5e-7,
                                   rtol=0, err_msg=f"{err} {name}")


@pytest.mark.parametrize("kind,factor", [("pretrain", 1.25), ("multiview", 1.25)])
def test_step_matches_jax(kind, factor):
    """One step on one process against JAX's jitted step: the loss (with
    0.01 x the aux loss in the pretrain step) at 1e-5 relative, each
    parameter's change at 1e-5 of its tensor's largest (the ResNet's at
    1e-4)."""
    losses, _, delta = ranks.step_case(step_case(kind, factor))
    loss, jdelta = jax_step(kind, factor)
    assert losses[0] == pytest.approx(loss, rel=1e-5)
    assert_delta_close(delta, jdelta, 1e-5, kind)


def test_the_aux_loss_enters_the_pretrain_loss():
    """Zeroing ``moe_aux_weight`` lowers the step's loss by 0.01 x the sum
    of the layers' aux losses (each >= 1), as in tests/test_moe.py."""
    case = step_case("pretrain", 1.25)
    with_aux = ranks.step_case(case)[0][0]
    without = ranks.step_case(dict(case, config=dict(case["config"], moe_aux_weight=0.0)))[0][0]
    assert 0.01 - 1e-6 <= with_aux - without < 0.1


# -- composition ------------------------------------------------------------------------


def test_tp_shares_run_the_moe_once():
    """Every rank's share of a tensor-parallel layer in one process: the
    MoE (replicated) runs once on the whole input, not once a share, so
    the shares give the unsharded layer's output and aux loss."""
    torch.manual_seed(0)
    bert = BertEncoder(vocab_size=64, hidden=16, layers=2, heads=4, intermediate=32,
                       max_position=16, moe_experts=4).eval()
    layer = bert.encoder.layer[1]
    x = torch.randn(2, 8, 16)
    bias = torch.zeros(2, 8)
    bias[1, 5:] = -1e10
    with torch.no_grad(), routing() as aux:
        want = layer(x, bias)
        mesh = Mesh2D(rank_grid(2, 2), ("data", "model"), 0, None, None)
        shares = [tp.tensor_parallel_(copy.deepcopy(bert), mesh, share=r).encoder.layer[1]
                  for r in range(2)]
        got = layer_shares(shares, x, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert len(aux) == 2 and float(aux[1]) == pytest.approx(float(aux[0]), abs=1e-6)


def test_bert_fused_mlp_runs_on_the_dense_blocks_only():
    """``--bert-fused-mlp`` in bf16: B4 (its wrapper) runs in the dense
    layer and never in the MoE one, whose MLP the MoE replaces."""
    bert = BertEncoder(vocab_size=64, hidden=128, layers=2, heads=2, intermediate=256,
                       max_position=16, fused_mlp=True, moe_experts=2).eval()
    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights

    cast_matmul_weights(bert, torch.bfloat16)
    calls = []
    real = mlp_train.dense_gelu_dense

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ids = torch.randint(0, 64, (2, 8))
    with torch.no_grad(), mock.patch.object(mlp_train, "dense_gelu_dense", counting):
        out = bert(ids, torch.ones(2, 8, dtype=torch.int64))
    assert len(calls) == 1 and out.dtype == torch.bfloat16
    moe = bert.encoder.layer[1].moe_mlp
    assert moe.router.weight.dtype == moe.bi.dtype == torch.float32
    assert moe.wi.dtype == torch.bfloat16


def test_lora_targets_no_moe_weight():
    """The default LoRA targets match no router or expert weight (nor does
    the JAX pattern, whose kernels the MoE leaves are not)."""
    paths = lora_paths(CXRClip(ModelConfig(**STEP_CFG)))
    assert "text_tower.encoder.layer.0.intermediate.dense.weight" in paths
    assert "text_tower.encoder.layer.1.attention.self.query.weight" in paths
    assert not [p for p in paths if "moe_mlp" in p]


# -- tensor-parallel zero-shot over gloo ------------------------------------------------


def _engine_setup():
    vocab = build_dev_vocab(DISEASE_LABELS)
    cfg = dict(STEP_CFG, vocab_size=len(vocab), flash_attention=False, max_text_length=16,
               moe_capacity_factor=0.5)
    images = np.random.default_rng(9).integers(0, 255, (10, 32, 32, 3), dtype=np.uint8)
    return vocab, cfg, images


@functools.lru_cache(maxsize=None)
def _engine_variables(cfg_items):
    jmodel = JCXRClip(JModelConfig(**dict(cfg_items)))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    rng = np.random.default_rng(4)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng)}


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    vocab, cfg, images = _engine_setup()
    cases = {"engine": dict(kind="tp_engine", tp=2, config=cfg,
                            variables=_engine_variables(tuple(cfg.items())), vocab=vocab,
                            images=images, image_size=32, max_text_length=16)}
    return ranks.launch(cases, 2, str(tmp_path_factory.mktemp("moe_tp")))


def test_tp2_zeroshot_with_a_moe_tower_matches_jax(tp_ranks):
    """The engine's towers tensor-parallel over two gloo ranks (its MoE
    replicated, its prompt bank routed in 64-prompt chunks on each rank as
    on one device) against the JAX engine: 2e-4 / 1e-4."""
    vocab, cfg, images = _engine_setup()
    engine = JZeroShotEngine(JCXRClip(JModelConfig(**cfg)),
                             _engine_variables(tuple(cfg.items())), JBertTokenizer(vocab),
                             DISEASE_LABELS, JZeroShotConfig(), image_size=32,
                             max_text_length=16, compute_dtype=jnp.float32)
    engine.build_text_features(jprompts_for_family("prediction", DISEASE_LABELS))
    want = engine.logits(images)
    for r in range(2):
        got = tp_ranks[r]["engine"]["logits"]
        assert got.shape == want.shape == (10, len(DISEASE_LABELS))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# -- the command line ---------------------------------------------------------------------


@pytest.fixture
def cli(monkeypatch):
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    return importlib.import_module("clip_for_dl_tpu_torch.cli.main")


TINY_ARGS = ["--tiny", "--fp32", "--synthetic", "--synthetic-samples", "8"]


def test_cli_moe_chain_and_the_missing_tensor_refusal(cli, tmp_path):
    """``pretrain --moe-experts 4`` writes a checkpoint with the MoE
    tensors; ``zeroshot --moe-experts 4`` scores from it; ``zeroshot``
    without the flag raises in the missing-tensor guard, naming the dense
    tensors the checkpoint lacks and the flag; ``convert --moe-experts``
    refuses (the JAX convert raises, see below)."""
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    assert cli.main(["pretrain", *TINY_ARGS, "--batch-size", "4", "--epochs", "1",
                     "--moe-experts", "4", "--checkpoint-dir", ck, "--log-dir", logs]) == 0
    saved = torch.load(f"{ck}/0.pt", weights_only=False)["model"]
    assert saved["text_tower.encoder.layer.1.moe_mlp.wi"].shape == (4, 64, 128)
    assert "text_tower.encoder.layer.1.intermediate.dense.weight" not in saved
    assert cli.main(["zeroshot", *TINY_ARGS, "--moe-experts", "4", "--checkpoint", ck,
                     "--log-dir", logs]) == 0
    assert (tmp_path / "logs" / "zero_shot_results.csv").exists()
    with pytest.raises(ValueError, match=r"lacks 4 of the model's tensors.*layer\.1\."
                                         r"intermediate.*--moe-experts"):
        cli.main(["zeroshot", *TINY_ARGS, "--checkpoint", ck, "--log-dir", logs])
    with pytest.raises(SystemExit, match="convert --moe-experts"):
        cli.main(["convert", *TINY_ARGS, "--moe-experts", "4", "--checkpoint", ck,
                  "--out", str(tmp_path / "x.safetensors")])


def test_jax_convert_raises_on_a_moe_tower():
    """The reference behaviour the port copies by refusing: the JAX
    ``export_bert`` (what ``convert`` writes through) reads a dense MLP in
    every layer, so a MoE tower's first MoE layer raises KeyError. A JAX
    convert that learns MoE fails this test, and the port's refusal is then
    to be replaced by its mapping."""
    jbert = JBertEncoder(vocab_size=64, hidden=16, layers=2, heads=2, intermediate=32,
                         max_position=16, moe_experts=4)
    shapes = jax.eval_shape(jbert.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), shapes["params"])
    with pytest.raises(KeyError, match="intermediate"):
        jexport_bert(params, layers=2)


def _actions(parser, command=""):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                yield from _actions(sub, name)
        else:
            yield command, action


def test_no_ported_flag_help_names_a_roadmap_item(cli):
    """ROADMAP C10: a flag that runs says what it does, not that it is
    unported; the flags that exit 2 still name their item (none is left).
    ``--remat``, ``--remat-policy`` and ``--bf16-attention-probs`` say it in
    the JAX CLI's words, in every command that takes them."""
    unported = {"--" + d.replace("_", "-") for d in cli.UNPORTED_FLAGS}
    seen = set()
    for command, action in _actions(cli.build_parser()):
        flags = set(action.option_strings)
        if not flags or action.help is None:
            continue
        seen |= flags
        if flags & unported:
            continue
        assert "ROADMAP" not in action.help and "not ported" not in action.help, (
            command, sorted(flags), action.help)
    assert {"--tp", "--ep", "--moe-experts", "--pp"} <= seen
    assert not {"--pp", "--ep", "--moe-experts"} & unported
    assert not unported
    jcli = importlib.import_module("clip_for_dl_tpu.cli.main")
    jax_help = {(command, a.dest): a.help for command, a in _actions(jcli.build_parser())}
    same = [(command, a.dest) for command, a in _actions(cli.build_parser())
            if a.dest in ("remat", "remat_policy", "bf16_attention_probs")]
    assert len(same) == 3 * 10  # the ten commands that take the common flags
    for key in same:
        got = next(a.help for command, a in _actions(cli.build_parser())
                   if (command, a.dest) == key)
        assert got == jax_help[key], key
