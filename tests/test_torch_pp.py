"""Pipeline parallelism of the port (clip_for_dl_tpu_torch/parallel/pp.py,
``pretrain --pp``) on gloo ranks, against the JAX package's
(clip_for_dl_tpu/parallel/pp.py; its own tests are tests/test_pp.py) on
conftest's 8 virtual CPU devices and against the port's one-process form
(``pipelined_bert_shares``), on the CPU in fp32.

The geometry is tests/test_pp.py's: a BERT of 4 layers at hidden 16 (2
heads, MLP 32) on 8 reports of 12 tokens with a ragged mask; a ViT of 4
layers at hidden 16 on 32 px images in patches of 8; a CXRClip with a
4-layer BERT at hidden 32 and a ResNet (1, 1, 1, 1) at width 8. Weights go
in through ``state_dict_from_jax``. One launch of two ranks runs the
pipelined BERT at S = 2 (M = 1, 2 and 4, forward and backward: every hop's
backward must pair up, under the launch's deadline) and the planted faults;
one launch of four ranks runs S = 4 at M = 1, 2 and 4, S = 2 over a 2 x 2
layout, the ViT, the pretrain step at dp 2 x pp 2 and pp 4 (SGD, and AdamW
with a checkpoint), and ``pretrain --num-devices 4 --pp 2`` from the
command line (a fresh run, its resume, and a resume from a checkpoint of
the command without ``--pp``).

Bounds: the forward 1e-5 absolute (tests/test_pp.py's); each gradient
1e-5 of its tensor's largest entry (microbatches sum the weights'
gradients in another order); the step's loss 1e-5 relative and each
parameter's change after one SGD update (its clipped gradient) 1e-5 of its
tensor's largest change, the ResNet's 1e-4 (tests/test_torch_moe.py's
``assert_delta_close``); the one-process form bit for bit the ranks'
result on one data slice.
"""

import copy
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.bert import BertEncoder as JBertEncoder
from clip_for_dl_tpu.models.vit import ViT as JViT
from clip_for_dl_tpu.parallel import pp as jpp
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train.optim import make_label_fn as jmake_label_fn
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD
from clip_for_dl_tpu_torch.models import convert, state_dict_from_jax
from clip_for_dl_tpu_torch.models.bert import BertEncoder
from clip_for_dl_tpu_torch.models.vit import ViT
from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.ops import mlp_train
from clip_for_dl_tpu_torch.parallel import pp
from clip_for_dl_tpu_torch.parallel.common import rank_grid
from clip_for_dl_tpu_torch.testing import ranks
from test_torch_moe import _fill, assert_delta_close

torch.set_num_threads(1)

BERT = dict(vocab_size=64, hidden=16, layers=4, heads=2, intermediate=32, max_position=16)
VIT = dict(image_size=32, patch=8, hidden=16, layers=4, heads=2, mlp_dim=32)
STEP_CFG = dict(image_size=32, max_text_length=16, vocab_size=128, text_embedding_dim=32,
                text_layers=4, text_heads=2, text_intermediate_dim=64,
                shared_embedding_dim=64, resnet_stages=(1, 1, 1, 1), resnet_width=8,
                dropout=0.0)
GROUPS = ["image_tower", "text_tower", "image_projector", "text_projector"]
LRS = {**{g: 1.0 for g in GROUPS}, "default": 1.0}
PREP = dict(image_size=32, mean=CLIP_MEAN, std=CLIP_STD)
# (S, M) of the pipelined BERT in each launch; the four-rank launch's S = 2
# runs over a 2 x 2 layout
TWO_RANKS = [(2, 1), (2, 2), (2, 4)]
FOUR_RANKS = [(4, 1), (4, 2), (4, 4), (2, 2)]
FAULTS = list(ranks.PP_FAULTS)


# -- inputs and weights ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bert_params():
    return jax.tree.map(np.asarray, JBertEncoder(**BERT).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


@functools.lru_cache(maxsize=None)
def _vit_params():
    return jax.tree.map(np.asarray, JViT(**VIT).init(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"])


def _bert_inputs():
    rng = np.random.default_rng(0)
    lengths = rng.integers(4, 13, (8,))
    return {"ids": rng.integers(0, 64, (8, 12)).astype(np.int64),
            "mask": (np.arange(12)[None, :] < lengths[:, None]).astype(np.int64)}


def _images():
    return np.random.default_rng(2).standard_normal((8, 32, 32, 3)).astype(np.float32)


def _cot(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_state(tower):
    """The JAX tower's parameters under the port's names."""
    if tower == "bert":
        return {k[2:]: v.numpy() for k, v in convert._bert(_bert_params(), "t").items()}
    return {k[2:]: v.numpy() for k, v in convert._vit(_vit_params(), "t").items()}


def _port_tower(tower):
    module = BertEncoder(**BERT) if tower == "bert" else ViT(**VIT)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in _port_state(tower).items()})
    return module


def _forward_case(s, m, **kw):
    return dict(kind="pp_forward", tower="bert", config=BERT, state=_port_state("bert"),
                inputs=_bert_inputs(), pp=s, m=m, cot=_cot((8, 12, 16), 3), **kw)


def _vit_case():
    return dict(kind="pp_forward", tower="vit", config=VIT, state=_port_state("vit"),
                inputs={"images": _images()}, pp=4, m=2, cot=_cot((8, 16), 4))


@functools.lru_cache(maxsize=None)
def _step_variables():
    jmodel = JCXRClip(JModelConfig(**STEP_CFG))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    rng = np.random.default_rng(1)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng)}


def _step_batch():
    rng = np.random.default_rng(4)
    mask = np.ones((8, 16), np.int32)
    for i, n in enumerate((7, 3, 9, 16, 5, 12, 10, 4)):
        mask[i, n:] = 0
    return {"images": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
            "input_ids": rng.integers(5, 128, (8, 16)).astype(np.int32),
            "attention_mask": mask}


def _step_case(s, **kw):
    return {**dict(kind="pp_step", config=STEP_CFG, variables=_step_variables(),
                   batch=_step_batch(), pp=s, m=2, clip=1.0, temperature=2.0, groups=GROUPS,
                   lrs=LRS, **PREP), **kw}


def _cli_argv(out, *extra):
    """``pretrain --tiny --fp32`` (2 BERT layers): two steps of 4 synthetic
    pairs an epoch, a validation batch, checkpoints and a history under
    ``out``."""
    return ["pretrain", "--tiny", "--fp32", "--synthetic", "--synthetic-samples", "8",
            "--batch-size", "4", "--checkpoint-dir", str(out / "ckpt"), "--log-dir",
            str(out / "logs"), *extra]


PP_FLAGS = ("--virtual-devices", "4", "--num-devices", "4", "--pp", "2")


def _no_dropout(get_preset):
    def preset(name):
        cfg = get_preset(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))

    return preset


@pytest.fixture(scope="module")
def cli_single(tmp_path_factory):
    """The command without ``--pp`` in this process (one epoch, dropout 0):
    the reference of the command over the ranks, and the dense checkpoint
    one of them resumes."""
    from unittest import mock

    from clip_for_dl_tpu_torch.core import config

    work = tmp_path_factory.mktemp("pp_cli")
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    with mock.patch.object(config, "get_preset", _no_dropout(config.get_preset)), \
            mock.patch.dict("os.environ", {"CLIP_FOR_DL_TPU_FORCE_CPU": "1"}):
        assert cli.main(_cli_argv(work / "single", "--epochs", "1")) == 0
    return work


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp_two")
    cases = {f"bert{s}{m}": _forward_case(s, m) for s, m in TWO_RANKS}
    cases.update({f"fault_{f}": _forward_case(2, 2, fault=f) for f in FAULTS})
    return ranks.launch(cases, 2, str(work))


@pytest.fixture(scope="module")
def four_ranks(cli_single):
    import shutil

    work = cli_single
    shutil.copytree(work / "single" / "ckpt", work / "dense" / "ckpt")
    cases = {f"bert{s}{m}": _forward_case(s, m) for s, m in FOUR_RANKS}
    cases["vit"] = _vit_case()
    cases["step_dp2xpp2"] = _step_case(2)
    cases["step_pp4"] = _step_case(4)
    cases["adamw"] = _step_case(2, adamw=True, weight_decay=1e-3, lrs={**LRS, "default": 1e-3},
                                dir=str(work / "adamw_ckpt"))
    for name, argv in (("cli_pp2", _cli_argv(work / "pp2", "--epochs", "1", *PP_FLAGS)),
                       ("cli_pp2_resume", _cli_argv(work / "pp2", "--epochs", "2", *PP_FLAGS,
                                                    "--log-dir", str(work / "resumed" / "logs"))),
                       ("cli_pp2_dense", _cli_argv(work / "dense", "--epochs", "2",
                                                   *PP_FLAGS))):
        cases[name] = dict(kind="cli", no_dropout=True, argv=argv)
    return work, ranks.launch(cases, 4, str(work / "ranks"), timeout=300)


# -- the layout ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,s", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (8, 3), (4, 0)])
def test_mesh_grid_equals_jax(n, s, eight_devices):
    """Rank r sits at data index r // S and stage r % S, as device r of the
    JAX (data, stage) mesh; a degree that does not split the devices is
    refused with JAX's message."""
    try:
        mesh = jpp.create_dp_pp_mesh(s, num_devices=n)
        want = np.vectorize(lambda d: d.id)(mesh.devices)
        assert mesh.axis_names == (pp.DATA_AXIS, pp.STAGE_AXIS)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            rank_grid(n, s, pp.STAGE_AXIS)
        assert str(got.value) == str(e)
        return
    np.testing.assert_array_equal(rank_grid(n, s, pp.STAGE_AXIS), want)
    assert pp.create_dp_pp_mesh(1).axis_names == mesh.axis_names


@pytest.mark.parametrize("args", [(12, 4, 4, 16), (12, 5, 4, 16), (12, 4, 3, 16), (12, 0, 4, 16),
                                  (4, 2, 0, 8), (2, 2, 2, 4)])
def test_validate_pp_equals_jax(args):
    try:
        jpp.validate_pp(*args)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        pp.validate_pp(*args)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("s", [1, 2, 4])
def test_stack_is_jax_layout_and_round_trips(s):
    """``stack_bert_layers`` of the port's state dict holds at [s, j] what
    JAX's stack holds there, converted; ``unstack_bert_layers`` gives the
    state dict back bit for bit; the whole model's ``pp_params`` too."""
    jstack = jpp.stack_bert_layers(_bert_params(), s)["pipeline_stack"]
    sd = {k: torch.from_numpy(v) for k, v in _port_state("bert").items()}
    stacked = pp.stack_bert_layers(sd, s)
    lps = 4 // s
    for si in range(s):
        for j in range(lps):
            layer = {"embeddings": _bert_params()["embeddings"],
                     "layer_0": jax.tree.map(lambda t: t[si, j], jstack)}
            for name, t in convert._bert(layer, "x").items():
                if ".encoder.layer.0." in name:
                    inner = name.split(".encoder.layer.0.")[1]
                    assert torch.equal(stacked[f"pipeline_stack.{inner}"][si, j], t), name
    assert not any(k.startswith("encoder.") for k in stacked)
    back = pp.unstack_bert_layers(stacked)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    whole = state_dict_from_jax(_step_variables()["params"], _step_variables()["batch_stats"])
    restacked = pp.unpp_params(pp.pp_params(whole, s))
    assert set(restacked) == set(whole) and all(torch.equal(restacked[k], whole[k])
                                                for k in whole)


def test_stack_refuses_what_jax_refuses():
    sd = {k: torch.from_numpy(v) for k, v in _port_state("bert").items()}
    with pytest.raises(ValueError) as want:
        jpp.stack_bert_layers(_bert_params(), 3)
    with pytest.raises(ValueError) as got:
        pp.stack_bert_layers(sd, 3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no layer_<i> entries"):
        pp.stack_bert_layers({"embeddings.x": torch.zeros(1)}, 1)


def test_pp_spec_equals_jax():
    """The stage axis splits exactly the leaves JAX's ``pp_spec`` puts on
    it (the stack's) and replicates the rest; a layer's tensor of the
    per-layer form is marked with the same spec, a ViT layer's is not."""
    from jax.sharding import PartitionSpec as P

    jstacked = jpp.stack_bert_layers(_bert_params(), 2)
    leaves = jax.tree_util.tree_flatten_with_path(jstacked)[0]
    jsplit = sum(jpp.pp_spec(path, v) == P("stage") for path, v in leaves)
    sd = {k: torch.from_numpy(v) for k, v in _port_state("bert").items()}
    stacked = pp.stack_bert_layers(sd, 2)
    split = [n for n in stacked if pp.pp_spec(n).dim == 0]
    assert len(split) == jsplit and len(stacked) == len(leaves)
    assert all(n.startswith("pipeline_stack.") for n in split)
    assert pp.pp_spec("text_tower.encoder.layer.3.output.dense.weight").dim == 0
    assert pp.pp_spec("text_tower.embeddings.word_embeddings.weight").dim is None
    assert pp.pp_spec("image_tower.encoder.layers.encoder_layer_0.mlp.0.weight").dim is None


# -- the pipelined forwards ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pipelined(s, m):
    """JAX's pipelined BERT over a 1 x s mesh: its output and, at (4, 2),
    its gradients of Σ out · cot in the port's names."""
    bert = JBertEncoder(**BERT)
    mesh = jpp.create_dp_pp_mesh(s, num_devices=s)
    x = _bert_inputs()
    ids, mask = jnp.asarray(x["ids"], jnp.int32), jnp.asarray(x["mask"], jnp.int32)
    cot = jnp.asarray(_cot((8, 12, 16), 3))

    def loss(p):
        out = jpp.pipelined_bert_forward(bert, p, ids, mask, mesh, m)
        return jnp.sum(out * cot), out

    stacked = jpp.stack_bert_layers(_bert_params(), s)
    if (s, m) != (4, 2):
        return np.asarray(jax.jit(lambda p: loss(p)[1])(stacked)), None
    grads, out = jax.jit(jax.grad(loss, has_aux=True))(stacked)
    grads = jax.tree.map(np.asarray, jpp.unstack_bert_layers(grads))
    return np.asarray(out), {k[2:]: v.numpy() for k, v in convert._bert(grads, "t").items()}


@functools.lru_cache(maxsize=None)
def _jax_plain(tower):
    """JAX's unpipelined tower: its output and gradients of Σ out · cot."""
    if tower == "bert":
        module, params, cot = JBertEncoder(**BERT), _bert_params(), _cot((8, 12, 16), 3)
        x = _bert_inputs()
        args = (jnp.asarray(x["ids"], jnp.int32), jnp.asarray(x["mask"], jnp.int32))
        conv = convert._bert
    else:
        module, params, cot = JViT(**VIT), _vit_params(), _cot((8, 16), 4)
        args = (jnp.asarray(_images()),)
        conv = convert._vit

    def loss(p):
        out = module.apply({"params": p}, *args)
        return jnp.sum(out * cot), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    grads = jax.tree.map(np.asarray, grads)
    return np.asarray(out), {k[2:]: v.numpy() for k, v in conv(grads, "t").items()}


def _rank_grads(out, name):
    """The tower's gradients from the ranks of data index 0 (each stage's
    layers from its rank; the rest from rank 0, after asserting that every
    rank holds the same)."""
    runs = [o[name] for o in out]
    grads = {}
    for r in runs:
        for k, g in r["grads"].items():
            if pp.pp_spec(k).dim is None and "encoder.layers." not in k:
                np.testing.assert_array_equal(g, runs[0]["grads"][k], err_msg=k)
                grads[k] = g
            elif r["data_index"] == 0:
                grads[k] = g
    return grads


def _assert_grads_close(got, want, rel, what):
    """Each gradient within ``rel`` of its tensor's largest entry; one that
    vanishes in exact arithmetic (the key bias's: softmax ignores a shift of
    a row's logits), below 1e-3 of the tower's largest entry, within
    ``rel`` of that."""
    assert set(got) == set(want), set(want) ^ set(got)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, atol=rel * (scale if scale >= 1e-3 * top else top),
                                   rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("world,s,m", [(2, *c) for c in TWO_RANKS] + [(4, *c) for c in FOUR_RANKS])
def test_pipelined_bert_matches_jax(world, s, m, two_ranks, four_ranks):
    """The pipelined BERT on every rank: the output JAX's pipelined forward
    at (S, M) = (2, 2), (4, 2), (4, 4) and its plain forward at every (S,
    M), 1e-5; the gradients, embeddings included, JAX's plain gradients
    at 1e-5 of each tensor's largest entry and at (4, 2) its pipelined
    ones."""
    out = two_ranks if world == 2 else four_ranks[1]
    name = f"bert{s}{m}"
    want, jgrads = _jax_plain("bert")
    for o in out:
        np.testing.assert_allclose(o[name]["out"], want, atol=1e-5, rtol=0)
        if (s, m) in ((2, 2), (4, 2), (4, 4)):
            np.testing.assert_allclose(o[name]["out"], _jax_pipelined(s, m)[0], atol=1e-5, rtol=0)
    grads = _rank_grads(out, name)
    _assert_grads_close(grads, jgrads, 1e-5, name)
    if (s, m) == (4, 2):
        _assert_grads_close(grads, _jax_pipelined(4, 2)[1], 1e-5, f"{name} vs JAX's pipeline")


def _shares(tower, s):
    return [pp.shard_stage_(_port_tower(tower), k, s) for k in range(s)]


def _one_process(case):
    """The case in one process (``pipelined_*_shares``), its planted fault
    too: (output, every share's gradients by share)."""
    s, m = case["pp"], case["m"]
    shares = _shares(case["tower"], s)
    x = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    with ranks.pp_fault(case.get("fault")):
        if case["tower"] == "bert":
            out = pp.pipelined_bert_shares(shares, x["ids"], x["mask"], m)
        else:
            out = pp.pipelined_vit_shares(shares, x["images"], m)
        (out * torch.from_numpy(case["cot"])).sum().backward()
    return out.detach().numpy(), [{k: p.grad.numpy() for k, p in sh.named_parameters()
                                   if p.grad is not None} for sh in shares]


@pytest.mark.parametrize("name", [f"bert{s}{m}" for s, m in TWO_RANKS]
                         + [f"fault_{f}" for f in FAULTS] + ["bert41", "bert42", "bert44", "vit"])
def test_one_process_form_equals_the_ranks_bit_for_bit(name, two_ranks, four_ranks):
    """Every stage's share run one after another in this process, the hop
    handed over in memory: the output and each stage's gradients are the
    ranks' bit for bit (one data slice, one thread), the planted faults'
    too."""
    out = two_ranks if name.startswith(("bert2", "fault")) else four_ranks[1]
    case = (_vit_case() if name == "vit" else
            _forward_case(int(name[4]), int(name[5])) if name.startswith("bert") else
            _forward_case(2, 2, fault=name[len("fault_"):]))
    got, grads = _one_process(case)
    for o in out:
        r = o[name]
        np.testing.assert_array_equal(r["out"], got)
        share = dict(grads[r["stage"]])
        if name == "vit":  # its final LayerNorm runs on every rank, here on share 0
            share.update({k: g for k, g in grads[0].items() if k.startswith("encoder.ln.")})
        assert set(r["grads"]) == set(share)
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, share[k], err_msg=f"{name} {k}")


def test_pipelined_vit_matches_jax(four_ranks, eight_devices):
    """The pipelined ViT at S = 4, M = 2: the features JAX's pipelined and
    plain forward's, 1e-5; the gradients (stem, layers, final LayerNorm)
    JAX's plain ones at 1e-5 of each tensor's largest entry."""
    _, out = four_ranks
    vit = JViT(**VIT)
    stacked = jpp.stack_bert_layers(dict(_vit_params()), 4)
    mesh = jpp.create_dp_pp_mesh(4, num_devices=4)
    want = jax.jit(lambda p, im: jpp.pipelined_vit_forward(vit, p, im, mesh, 2))(
        stacked, jnp.asarray(_images()))
    plain, jgrads = _jax_plain("vit")
    for o in out:
        np.testing.assert_allclose(o["vit"]["out"], np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(o["vit"]["out"], plain, atol=1e-5, rtol=0)
    _assert_grads_close(_rank_grads(out, "vit"), jgrads, 1e-5, "vit")


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_comparison(fault, two_ranks):
    """The summing broadcast's backward (every text gradient S times) and
    the embeddings' stage sum left out (stage 1's embeddings see no
    gradient): each fails test_pipelined_bert_matches_jax's bounds."""
    _, jgrads = _jax_plain("bert")
    name = f"fault_{fault}"
    if fault == "summing_broadcast":
        grads = _rank_grads(two_ranks, name)
    else:  # stage 1's embeddings
        grads = {k: g for k, g in two_ranks[1][name]["grads"].items()
                 if k.startswith("embeddings.")}
        assert grads and not any(np.any(g) for g in grads.values())
    with pytest.raises(AssertionError):
        _assert_grads_close(grads, {k: jgrads[k] for k in grads}, 1e-5, fault)


def test_pipelined_layers_launch_neither_b3_nor_b4(monkeypatch):
    """A bf16 tower built with ``flash`` and ``fused_mlp`` (widths 128 and
    256, so that both kernels' gates open) in train mode: the plain forward
    calls B3's and B4's entry points in every layer, the pipelined one
    neither (JAX builds the pipelined layer without them); the switches and
    the train mode are the tower's again after."""
    calls = {"flash": 0, "mlp": 0}
    attention, mlp = fa.flash_attention_packed, mlp_train.dense_gelu_dense

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        return wrapped

    monkeypatch.setattr(fa, "flash_attention_packed", counting("flash", attention))
    monkeypatch.setattr(mlp_train, "dense_gelu_dense", counting("mlp", mlp))
    from clip_for_dl_tpu_torch.core.device import cast_in_forward

    tower = BertEncoder(vocab_size=64, hidden=128, layers=2, heads=2, intermediate=256,
                        max_position=16, dropout=0.1, flash=True, fused_mlp=True)
    tower = cast_in_forward(tower, torch.bfloat16).train()
    ids = torch.from_numpy(_bert_inputs()["ids"])
    mask = torch.from_numpy(_bert_inputs()["mask"])
    tower(ids, mask)
    assert calls == {"flash": 2, "mlp": 2}
    shares = [pp.shard_stage_(copy.deepcopy(tower), k, 2) for k in range(2)]
    pp.pipelined_bert_shares(shares, ids, mask, 2).float().sum().backward()
    assert calls == {"flash": 2, "mlp": 2}
    for share in shares:
        assert share.training and all(m.training for m in share.modules())
        assert all(layer.attention.self.flash and layer.fused_mlp
                   for layer in share.encoder.layer)


# -- the step ------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(s, n):
    """JAX's ``pipeline_parallel_step`` over an n-device (data, stage) mesh
    with SGD at lr 1 after the clip at 1.0: (loss, parameter change in the
    port's names)."""
    variables = _step_variables()
    jmodel = JCXRClip(JModelConfig(**STEP_CFG))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.identity())
    mesh = jpp.create_dp_pp_mesh(s, num_devices=n)
    raw = jpp.make_pp_clip_pretrain_step(jmodel, tx, jmake_label_fn(GROUPS), mesh, 2,
                                         temperature=2.0, compute_dtype=jnp.float32, **PREP)
    state = jpp.shard_state_pp(JTrainState.create(
        {**variables, "params": jpp.pp_params(variables["params"], s)}, tx), mesh)
    batch = {k: jnp.asarray(v) for k, v in _step_batch().items()}
    state, metrics = jpp.pipeline_parallel_step(raw, mesh, donate_state=False)(
        state, batch, LRS, jax.random.key(0))
    after = jax.device_get(state)
    params = jpp.unpp_params(after.params)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - b, params, variables["params"])
    return float(metrics["loss"]), state_dict_from_jax(delta, after.batch_stats)


def _whole_delta(runs, s):
    """The parameter change of the whole model from the ranks: each layer
    from a rank of its stage, the replicated tensors from rank 0 (every
    rank's the same)."""
    lps = STEP_CFG["text_layers"] // s
    delta = {}
    for r in runs:
        for k, d in r["delta"].items():
            if pp.pp_spec(k).dim is None:
                np.testing.assert_array_equal(d, runs[0]["delta"][k], err_msg=k)
                delta[k] = d
            else:
                assert int(k.split(".")[3]) // lps == r["stage"], k
                delta[k] = d
    return delta


@pytest.mark.parametrize("name,s", [("step_dp2xpp2", 2), ("step_pp4", 4)])
def test_pp_step_matches_jax(name, s, four_ranks, eight_devices):
    """``make_pp_clip_pretrain_step`` through ``pipeline_parallel_step`` at
    dp 2 x pp 2 and at pp 4 against JAX's on a mesh of the same shape: the
    loss on every rank at 1e-5 relative, every parameter's change after one
    update at 1e-5 of its tensor's largest (the ResNet's 1e-4)."""
    _, out = four_ranks
    runs = [o[name] for o in out]
    loss, jdelta = _jax_step(s, 4)
    for r in runs:
        assert r["loss"] == pytest.approx(loss, rel=1e-5)
    delta = _whole_delta(runs, s)
    assert set(delta) == {k for k in jdelta if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    assert_delta_close(delta, jdelta, 1e-5, name)


def test_each_rank_holds_only_its_stage(four_ranks):
    """After an AdamW step at dp 2 x pp 2 a rank holds its stage's layers
    and their two moments, and of every other layer nothing: no element, no
    moment; everything else whole. The checkpoint it wrote through
    ``WholeCheckpoints`` is whole (every layer from its stage's ranks, the
    moments of every layer), and the rank holds only its stage again
    after."""
    work, out = four_ranks
    saved = torch.load(str(work / "adamw_ckpt" / "0.pt"), weights_only=False)
    for o in out:
        r = o["adamw"]
        for k, n in r["held"].items():
            other = pp.pp_spec(k).dim == 0 and int(k.split(".")[3]) // 2 != r["stage"]
            assert (n == 0) == other, k
            assert set(r["moments"][k]) == (set() if other else {"exp_avg", "exp_avg_sq"}), k
            assert r["after_save"][k] == n, k
        for k, t in r["state"].items():
            if t.size:
                np.testing.assert_array_equal(saved["model"][k].numpy(), t, err_msg=k)
    assert all(saved["model"][k].numel() for k in saved["model"]
               if not k.endswith("num_batches_tracked"))
    moments = saved["optimizer"]["state"]
    assert len(moments) == len(out[0]["adamw"]["held"])
    assert all(m["exp_avg"].numel() for m in moments.values())


# -- the command line ------------------------------------------------------------------------


def _history(run_dir):
    with open(run_dir / "logs" / "training_history.csv") as f:
        head, *rows = f.read().splitlines()
    return [dict(zip(head.split(","), map(float, row.split(",")))) for row in rows]


def test_pretrain_pp_command_equals_one_process(four_ranks, monkeypatch):
    """``pretrain --num-devices 4 --pp 2`` on four ranks (2 x 2) against
    the command without ``--pp`` in one process, dropout 0: the first
    epoch's train loss (its first step's) at 1e-5 relative; the
    ``unstacked/`` checkpoint holds the unsharded names and shapes and the
    run's last weights, and ``zeroshot`` reads it; the run resumed at
    ``--epochs 2`` trains epoch 1 from its checkpoint, and so does the same
    command from the dense checkpoint of the run without ``--pp``."""
    work, out = four_ranks
    for name in ("cli_pp2", "cli_pp2_resume", "cli_pp2_dense"):
        assert [o[name]["rc"] for o in out] == [0, 0, 0, 0], name
    single = _history(work / "single")
    got = _history(work / "pp2")
    assert got[0]["train_loss"] == pytest.approx(single[0]["train_loss"], rel=1e-5)
    assert [r["epoch"] for r in got] == [0]
    assert [r["epoch"] for r in _history(work / "resumed")] == [1]
    assert [r["epoch"] for r in _history(work / "dense")] == [1]
    ref = torch.load(str(work / "single" / "ckpt" / "0.pt"), weights_only=False)["model"]
    canon = torch.load(str(work / "pp2" / "ckpt" / "unstacked" / "0.pt"), weights_only=False)
    last = torch.load(str(work / "pp2" / "ckpt" / "1.pt"), weights_only=False)["model"]
    assert {k: v.shape for k, v in canon["model"].items()} == {k: v.shape for k, v in ref.items()}
    assert all(torch.equal(canon["model"][k], last[k]) for k in last)
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    assert cli.main(["zeroshot", "--tiny", "--fp32", "--synthetic", "--checkpoint",
                     str(work / "pp2" / "ckpt" / "unstacked"), "--log-dir",
                     str(work / "zs")]) == 0
    assert (work / "zs" / "zero_shot_results.csv").exists()
