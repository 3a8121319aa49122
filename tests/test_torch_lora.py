"""LoRA on the port (``clip_for_dl_tpu_torch/models/lora.py``, ``pretrain
--lora``) against the JAX package's ``models/lora.py`` and CLI, on the CPU.

Tiny geometry (ResNet stages (1, 1, 1, 1) at width 8 or a ViT at image 32,
2 layers, hidden 128, MLP 256; a 2-layer BERT at hidden 128; dropout 0).
JAX variables are drawn from a seed with numpy and carried into the port by
``state_dict_from_jax``; JAX's draws of the factors A and B are carried by
``lora_from_jax``. The JAX side runs its Pallas kernels in interpret mode,
the port its kernels' plain versions. Tolerances are stated per test.
"""

import argparse
import ast
import contextlib
import functools
import importlib
import inspect
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models import lora as jlora
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, ModelConfig, get_preset
from clip_for_dl_tpu_torch.core.device import cast_in_forward, plain_name
from clip_for_dl_tpu_torch.models import (
    CXRClip,
    fold_lora,
    init_lora,
    lora_from_jax,
    lora_param_count,
    lora_paths,
    make_lora_pretrain_step,
    merge_lora,
    state_dict_from_jax,
)
from clip_for_dl_tpu_torch.models.convert import lora_path_from_jax
from clip_for_dl_tpu_torch.models.lora import _merged_call
from clip_for_dl_tpu_torch.ops import mlp_block
from clip_for_dl_tpu_torch.train import TrainState, make_label_fn, make_optimizer
from clip_for_dl_tpu_torch.train.checkpoint import load_model, model_state

jcli = importlib.import_module("clip_for_dl_tpu.cli.main")
cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")

torch.set_num_threads(1)

PRESET = get_preset("pretrain_clip")
GROUPS = [g.name for g in PRESET.train.groups]
LRS = {**{g.name: g.lr for g in PRESET.train.groups}, "default": PRESET.train.lr}
ALPHA = 16.0
RANK = 4
BASE = dict(image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=128,
            text_layers=2, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
            text_max_position=32, dropout=0.0, flash_attention=True, bert_fused_mlp=True)
TOWERS = {
    "resnet": dict(resnet_stages=(1, 1, 1, 1), resnet_width=8),
    "vit": dict(image_tower="vit_b16", image_embedding_dim=128, vit_patch=16, vit_layers=2,
                vit_heads=2, vit_hidden=128, vit_mlp_dim=256, vit_fused_mlp=True),
}


def _fill(tree, rng, path=()):
    """Fan-in-scaled kernels, non-zero biases, norm scales near 1 and
    BatchNorm statistics away from (0, 1)."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "var"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        v = rng.uniform(-0.5, 0.5, shape)
    elif name == "embedding":
        v = rng.standard_normal(shape) * 0.5
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


def _cfg(tower):
    return dict(BASE, **TOWERS[tower])


@functools.lru_cache(maxsize=None)
def _variables(tower):
    shapes = jax.eval_shape(JCXRClip(JModelConfig(**_cfg(tower))).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(41)
    return {k: _fill(v, rng) for k, v in shapes.items()}


def _port_model(tower, bf16=False):
    variables = _variables(tower)
    model = CXRClip(ModelConfig(**_cfg(tower)))
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats", {})), strict=True)
    if bf16:
        cast_in_forward(model, torch.bfloat16)
    return model


@functools.lru_cache(maxsize=None)
def _jax_lora(tower, random_b: bool):
    """JAX's init_lora draws at RANK; with ``random_b`` B is drawn too (at
    init B = 0 and a merge would change nothing)."""
    lora = jlora.init_lora(jax.random.key(5), _variables(tower)["params"], rank=RANK)
    lora = jax.tree.map(np.asarray, lora)
    if random_b:
        rng = np.random.default_rng(6)
        lora = {p: {"a": ab["a"], "b": (rng.standard_normal(ab["b"].shape) * 0.05)
                    .astype(np.float32)} for p, ab in lora.items()}
    return lora


def _batch(seed=2, b=4):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 12), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return {"images": rng.integers(0, 256, (b, 48, 48, 1), dtype=np.uint8),
            "input_ids": rng.integers(5, 64, (b, 12)).astype(np.int32),
            "attention_mask": mask}


# -- the targets ---------------------------------------------------------------------


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_targets_and_count_match_jax(tower):
    """The port's targets are JAX's lora_paths under the port's names (the
    ViT's q/k/v as the row blocks of its packed projection), for a model
    built with cast_in_forward's parametrizations too; the trainable count
    is equal; A ~ N(0, 1/r) and B = 0."""
    params = _variables(tower)["params"]
    want = sorted(lora_path_from_jax(p) for p in jlora.lora_paths(params))
    assert lora_paths(_port_model(tower)) == want
    assert lora_paths(_port_model(tower, bf16=True)) == want
    port = init_lora(torch.Generator().manual_seed(0), _port_model(tower), rank=RANK)
    jax_lora = jlora.init_lora(jax.random.key(5), params, rank=RANK)
    assert port.paths == want
    assert lora_param_count(port) == jlora.lora_param_count(jax_lora)
    for path, (a, b) in port.items():
        assert tuple(a.shape) == jax_lora[_jax_path(path)]["a"].shape, path
        assert tuple(b.shape) == jax_lora[_jax_path(path)]["b"].shape and not b.any(), path
    a_all = torch.cat([a.detach().flatten() for _, (a, _) in port.items()])
    assert float(a_all.std()) == pytest.approx(RANK ** -0.5, rel=0.05)


def _jax_path(port_path):
    return next(p for p in jlora.lora_paths(_variables(
        "vit" if "encoder.layers" in port_path else "resnet")["params"])
        if lora_path_from_jax(p) == port_path)


def test_lora_path_from_jax_refuses_an_unknown_path():
    with pytest.raises(ValueError, match="no port target"):
        lora_path_from_jax("text_tower/embeddings/word_embeddings/embedding")


# -- merge and fold ------------------------------------------------------------------


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_merge_and_fold_match_jax(tower):
    """merge_lora and fold_lora with B drawn nonzero against
    state_dict_from_jax of JAX's merge_lora / fold_lora: 1e-6 in fp32 (the
    same fp32 product A·B, scaled and added); every weight outside the
    targets, and the BatchNorm statistics, passed through unchanged."""
    variables = _variables(tower)
    jl = _jax_lora(tower, True)
    want = state_dict_from_jax(jlora.merge_lora(variables["params"], jl, ALPHA),
                               variables.get("batch_stats", {}))
    model = _port_model(tower)
    lora = lora_from_jax(jl)
    base = model_state(model)
    merged = merge_lora({plain_name(n): p for n, p in model.named_parameters()}, lora, ALPHA)
    folded = fold_lora(base, lora, ALPHA)
    assert set(folded) == set(base)
    targets = {lora_path_from_jax(p) for p in jl}
    for name, w in want.items():
        np.testing.assert_allclose(folded[name].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        if name in merged:
            np.testing.assert_allclose(merged[name].detach().numpy(), w.numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)
        moved = not torch.equal(folded[name], base[name])
        in_target = name in targets or (name.endswith("in_proj_weight") and tower == "vit")
        assert moved == in_target, name


# -- the LoRA step ---------------------------------------------------------------------


def _jax_steps(tower, steps, bf16=False):
    """JAX's make_lora_pretrain_step for ``steps`` steps from _jax_lora's
    init draws: [(loss, the factors after the step, the clipped gradient
    of the step)]."""
    variables = _variables(tower)
    jmodel = JCXRClip(JModelConfig(**_cfg(tower)), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tx = base_transform(max_grad_norm=PRESET.train.max_grad_norm,
                        weight_decay=PRESET.train.weight_decay)
    step = jax.jit(jlora.make_lora_pretrain_step(
        jmodel, tx, "clip_self_distill", 2.0, ALPHA, 32, CLIP_MEAN, CLIP_STD,
        jnp.bfloat16 if bf16 else jnp.float32))
    lora = _jax_lora(tower, False)
    state = JTrainState(params=lora, batch_stats={}, opt_state=tx.init(lora),
                        step=jnp.zeros((), jnp.int32))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out, mu_before = [], jax.tree.map(np.zeros_like, lora)
    for i in range(steps):
        state, metrics = step(state, variables, batch, LRS, jax.random.key(i))
        mu = jax.tree.map(np.asarray, jax.device_get(state.opt_state[1].mu))
        # the clipped gradient the step applied: mu = 0.9·mu_before + 0.1·g
        grad = jax.tree.map(lambda m, m0: (m - 0.9 * m0) / 0.1, mu, mu_before)
        mu_before = mu
        out.append((float(metrics["loss"]), jax.tree.map(np.asarray, state.params), grad))
    return out


def _port_steps(tower, steps, bf16=False, on_backward=None):
    """The port's LoRA step for ``steps`` steps from the same draws:
    [(loss, the factors after the step, their clipped gradients)], and the
    model's state dict before and after."""
    model = _port_model(tower, bf16)
    lora = lora_from_jax(_jax_lora(tower, False))
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(lora, label_fn, weight_decay=PRESET.train.weight_decay)
    step = make_lora_pretrain_step(
        model, lora, opt, temperature=2.0, alpha=ALPHA, image_size=32, mean=CLIP_MEAN,
        std=CLIP_STD, compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        max_grad_norm=PRESET.train.max_grad_norm)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(lora, opt)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = []
    for _ in range(steps):
        state, metrics = step(state, batch, LRS)
        out.append((float(metrics["loss"]),
                    {p: (a.detach().clone(), b.detach().clone()) for p, (a, b) in lora.items()},
                    {p: (a.grad.clone(), b.grad.clone()) for p, (a, b) in lora.items()}))
    return out, before, model.state_dict(), state


@functools.lru_cache(maxsize=None)
def _two_resnet_steps():
    return _jax_steps("resnet", 2), _port_steps("resnet", 2)


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_two_lora_steps_match_jax_on_resnet(i):
    """Two LoRA steps in fp32 on the ResNet model (its text tower and heads
    adapted): the loss within 5e-5 and every factor after the step within
    1e-4 (at init B = 0, so A gets no gradient on step 1 and only decays;
    step 2 moves it); the clipped gradient of each factor within 1e-4 of
    its largest entry. Step 1 moves every B and no A's direction."""
    jax_out, (port_out, _, _, state) = _two_resnet_steps()
    (jl, jfactors, jgrads), (pl, factors, grads) = jax_out[i], port_out[i]
    np.testing.assert_allclose(pl, jl, atol=5e-5, rtol=0)
    for jpath, ab in jfactors.items():
        path = lora_path_from_jax(jpath)
        for k, got, grad in zip("ab", factors[path], grads[path]):
            np.testing.assert_allclose(got.numpy(), ab[k], atol=1e-4, rtol=0,
                                       err_msg=f"{path}.{k}")
            w = jgrads[jpath][k]
            np.testing.assert_allclose(grad.numpy(), w, atol=1e-4 * np.abs(w).max() + 1e-12,
                                       rtol=0, err_msg=f"{path}.{k} gradient")
    if i == 0:
        assert all(not g[0].any() for g in grads.values())  # A's gradient, B = 0
        assert all(g[1].any() for p, g in grads.items() if not p.startswith("view_fusion"))
    assert state.step == 2


def test_lora_step_leaves_the_frozen_model_bit_equal():
    """The frozen base in inference mode: every weight and the BatchNorm
    running statistics (and their step counters) bit-equal after two
    steps; no gradient formed for a base weight."""
    _, (_, before, after, _) = _two_resnet_steps()
    stats = [k for k in before if "running" in k or "num_batches" in k]
    assert len(stats) == 3 * 17
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_lora_step_on_a_fused_mlp_vit_in_bf16_matches_jax():
    """One LoRA step on a --fused-mlp ViT in bf16: the frozen ViT runs in
    eval mode through B9's autograd function (its backward the plain
    version's autograd, as the JAX custom VJP's), the BERT MLP through
    dense_gelu_dense. Against JAX's step (fused_mlp_block_trainable,
    interpreted): the loss within 2e-2 relative and each group's factor
    gradient cosine at least 0.99 (the chip's bounds for bf16 routes,
    chip_smoke.py phase 4; the frameworks round bf16 at other places)."""
    calls = []
    real = mlp_block._MLPBlock.backward

    def counted(ctx, *g):
        calls.append(1)
        return real(ctx, *g)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mlp_block._MLPBlock, "backward", staticmethod(counted))
        (port,), _, _, _ = _port_steps("vit", 1, bf16=True)
    ((jl, _, jgrads),) = _jax_steps("vit", 1, bf16=True)
    assert len(calls) == TOWERS["vit"]["vit_layers"]
    loss, _, grads = port
    assert abs(loss - jl) <= 2e-2 * abs(jl)
    label_fn = make_label_fn(GROUPS)
    groups = {}
    for jpath, ab in jgrads.items():
        path = lora_path_from_jax(jpath)
        got, want = groups.setdefault(label_fn(tuple(path.split("."))), ([], []))
        for k, g in zip("ab", grads[path]):
            got.append(g.float().flatten())
            want.append(torch.from_numpy(np.asarray(ab[k], np.float32)).flatten())
    for label, (got, want) in groups.items():
        got, want = torch.cat(got), torch.cat(want)
        if not want.any():  # the fusion's factors: the forward does not reach them
            assert not got.any(), label
            continue
        cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
        assert cos >= 0.99, (label, cos)


# -- the command line --------------------------------------------------------------


def _jax_refusals():
    """Every message cmd_pretrain of the JAX CLI refuses with: the string
    constants of its SystemExit raises and its error prints (adjacent
    literals are one constant in the syntax tree)."""
    tree = ast.parse(inspect.getsource(jcli.cmd_pretrain).lstrip())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) in ("SystemExit",
                                                                             "print"):
            out |= {a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)}
    return out


@pytest.mark.parametrize("extra", [["--local-loss"], ["--ema-decay", "0.99"],
                                   ["--accum-steps", "2"], ["--learnable-temperature"]],
                         ids=["local_loss", "ema", "accum", "learnable_temperature"])
def test_lora_refusals_are_the_jax_clis(extra, capsys):
    """Each option JAX's pretrain refuses beside --lora, with its message
    word for word, before anything runs."""
    with pytest.raises(SystemExit) as e:
        cli.main(["pretrain", "--tiny", "--synthetic", "--lora", "4", *extra])
    assert e.value.code in _jax_refusals()
    assert extra[0] in e.value.code and "--lora" in e.value.code


def test_lora_rank_below_zero_exits_2_as_the_jax_cli(capsys):
    assert jcli.main(["pretrain", "--tiny", "--synthetic", "--lora", "-1"]) == 2
    want = capsys.readouterr().err
    assert cli.main(["pretrain", "--tiny", "--synthetic", "--lora", "-1"]) == 2
    assert capsys.readouterr().err == want


@pytest.mark.parametrize("extra", [["--pp", "2"], ["--num-devices", "2"]], ids=["pp", "dp"])
def test_lora_leaves_the_multi_device_flags_unported(extra, capsys):
    """--pp and --num-devices are refused beside --lora with the JAX CLI's
    messages, before any rank starts."""
    argv = ["pretrain", "--tiny", "--synthetic", "--lora", "4", *extra]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    want = {"--pp": "--pp does not compose with --lora",
            "--num-devices": "--num-devices is not supported with --lora"}[extra[0]]
    assert e.value.code == want
    assert e.value.code in _jax_refusals()


@pytest.fixture(scope="module")
def lora_run(tmp_path_factory):
    """``pretrain --tiny --fp32 --lora 4`` on synthetic data (two epochs, a
    checkpoint directory), with the model, factors and frozen weights the
    command trained kept."""
    root = tmp_path_factory.mktemp("lora")
    made = {}
    module = importlib.import_module("clip_for_dl_tpu_torch.models.lora")
    real = module.make_lora_pretrain_step

    def keep(model, lora, *a, **kw):
        made.update(model=model, lora=lora, frozen={k: v.clone() for k, v in
                                                    model_state(model).items()})
        return real(model, lora, *a, **kw)

    argv = ["pretrain", "--tiny", "--fp32", "--synthetic", "--synthetic-samples", "16",
            "--batch-size", "4", "--epochs", "2", "--lora", "4",
            "--checkpoint-dir", str(root / "ck"), "--log-dir", str(root / "logs")]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
        mp.setattr(module, "make_lora_pretrain_step", keep)
        with contextlib.redirect_stdout(out):
            assert cli.main(argv) == 0
    return dict(root=root, stdout=out.getvalue(), **made)


def test_pretrain_lora_writes_the_factors_and_folded(lora_run):
    """The epoch checkpoints hold only the factors and their optimizer
    state; ``folded/`` holds the whole model with the deltas baked in."""
    ck = lora_run["root"] / "ck"
    saved = torch.load(ck / "1.pt", weights_only=True)
    assert set(saved["model"]) == {f"{p}.{k}" for p in lora_run["lora"].paths for k in "ab"}
    assert saved["optimizer"]["state"]
    folded = torch.load(ck / "folded" / "0.pt", weights_only=True)["model"]
    want = fold_lora(lora_run["frozen"], lora_run["lora"], ALPHA)
    assert set(folded) == set(want)
    for k, v in want.items():
        assert torch.equal(folded[k], v), k
    assert "folded LoRA model saved to" in lora_run["stdout"]
    assert any(not torch.equal(folded[k], lora_run["frozen"][k]) for k in folded)


def test_folded_model_scores_as_the_merged_model(lora_run, monkeypatch):
    """``zeroshot --checkpoint <dir>/folded`` runs from it, and the folded
    model's zero-shot probabilities are bit-equal to the merged in-memory
    model's (the frozen weights with the trained factors merged inside the
    forward, as the LoRA step and eval step run it), fp32."""
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.inference import load_trained_model
    from clip_for_dl_tpu_torch.ops.similarity import similarity
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
    from clip_for_dl_tpu_torch.zeroshot import prompts_for_family

    folded_dir = str(lora_run["root"] / "ck" / "folded")
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["zeroshot", "--tiny", "--fp32", "--synthetic", "--synthetic-samples",
                         "8", "--batch-size", "4", "--checkpoint", folded_dir, "--log-dir",
                         str(lora_run["root"] / "zs")]) == 0
    model = lora_run["model"]
    cfg = cli._apply_tiny(get_preset("zero_shot"), argparse.Namespace(tiny=True),
                          model.config.vocab_size)
    folded = load_trained_model(folded_dir, cfg, torch.float32, device="cpu").eval()
    merged = model.eval()
    load_model(merged, lora_run["frozen"])  # the command folded it in place at the end
    tok = BertTokenizer(build_dev_vocab(DISEASE_LABELS))
    enc = tok.encode([p for ps in prompts_for_family("basic", DISEASE_LABELS).values()
                      for p in ps], max_length=cfg.model.max_text_length)
    images = torch.randn(5, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    args = (images, torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
    with torch.no_grad():
        feats_m = _merged_call(merged, lora_run["lora"], ALPHA)(*args)
        feats_f = folded(*args)
    for got, want in zip(feats_f, feats_m):
        assert torch.equal(got, want)
    probs = [torch.sigmoid(similarity(i, t, cfg.model.temperature)) for i, t in
             (feats_f, feats_m)]
    assert torch.equal(*probs)
    assert not os.path.exists(os.path.join(folded_dir, "1.pt"))
