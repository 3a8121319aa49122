"""One step of the ``vit`` preset (ViT-B/16 image tower) on the port against
the JAX package's ``make_clip_pretrain_step``, on the CPU.

Tiny geometry: a ViT at image 32, patch 16 (4 patches and the class
token), 2 layers, hidden 128, MLP 256, 4 heads (both widths multiples of
128, so the JAX gate of ``vit_fused_mlp_train`` opens in bf16), with a
2-layer BERT at hidden 128; dropout 0. JAX variables are drawn from a seed
with numpy and carried into the port by ``state_dict_from_jax``. The same
numpy batch then goes through one step on both sides, with the preset's
group learning rates, weight decay and clipping at 1.0:

- fp32 on the plain route (no flash attention, no fused MLP): loss and
  every (clipped) gradient, as the ResNet step of tests/test_torch_train.py;
- bf16 with ``flash_attention`` and ``vit_fused_mlp_train`` on both sides,
  exact and tanh GELU: the JAX side runs its Pallas kernels in interpret
  mode, the port its kernels' plain versions, and the port's ViT MLP goes
  through ``dense_gelu_dense`` (B4 forward, B8 backward).

Tolerances are stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_step
from clip_for_dl_tpu.train.optim import make_label_fn as jmake_label_fn
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, ModelConfig, get_preset
from clip_for_dl_tpu_torch.core.device import cast_in_forward, plain_name
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.ops import mlp_train
from clip_for_dl_tpu_torch.train import (
    TrainState,
    make_clip_pretrain_step,
    make_label_fn,
    make_optimizer,
)

torch.set_num_threads(1)

PRESET = get_preset("vit")
TINY = dict(
    image_tower="vit_b16", image_embedding_dim=128, image_size=32, vit_patch=16,
    vit_layers=2, vit_heads=4, vit_hidden=128, vit_mlp_dim=256, max_text_length=12,
    vocab_size=64, text_embedding_dim=128, text_layers=2, text_heads=2,
    text_intermediate_dim=256, shared_embedding_dim=64, text_max_position=32, dropout=0.0,
)
GROUPS = [g.name for g in PRESET.train.groups]
LRS = {**{g.name: g.lr for g in PRESET.train.groups}, "default": PRESET.train.lr}
T = PRESET.model.temperature
# the route cases: (model switches, bf16 compute)
CASES = {
    "fp32_plain": ({}, False),
    "bf16_kernels_erf": (dict(flash_attention=True, vit_fused_mlp_train=True), True),
    "bf16_kernels_tanh": (dict(flash_attention=True, vit_fused_mlp_train=True,
                               vit_gelu_approximate=True), True),
}


def _fill(tree, rng, path=()):
    """Fan-in-scaled kernels, non-zero biases, norm scales near 1."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "scale":
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "embedding":
        v = rng.standard_normal(shape) * 0.5
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params():
    """The tiny ViT CXRClip's params; the switches leave the tree unchanged
    and the model has no batch statistics."""
    shapes = jax.eval_shape(JCXRClip(JModelConfig(**TINY)).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 12), jnp.int32))
    assert "batch_stats" not in shapes
    return _fill(shapes["params"], np.random.default_rng(31))


def _batch(seed=3, b=4):
    """48x48 grey uint8 images (resized to 32 in the step) and token ids
    with padded tails of different lengths."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 12), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return {"images": rng.integers(0, 256, (b, 48, 48, 1), dtype=np.uint8),
            "input_ids": rng.integers(5, 64, (b, 12)).astype(np.int32),
            "attention_mask": mask}


@functools.lru_cache(maxsize=None)
def _jax_run(case: str):
    """The JAX side of ``case``: the step's loss and the clipped gradient,
    in the port's names and layouts."""
    switches, bf16 = CASES[case]
    jmodel = JCXRClip(JModelConfig(**dict(TINY, **switches)),
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
    variables = {"params": _params()}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    compute = jnp.bfloat16 if bf16 else jnp.float32
    tx = base_transform(max_grad_norm=PRESET.train.max_grad_norm,
                        weight_decay=PRESET.train.weight_decay)
    step = jax.jit(jmake_step(jmodel, tx, jmake_label_fn(GROUPS), temperature=T,
                              image_size=32, mean=CLIP_MEAN, std=CLIP_STD,
                              compute_dtype=compute))
    state = JTrainState.create(variables, tx)
    # the gradient the step applied: the first Adam moment holds (1 - b1)·g
    new, metrics = step(state, batch, LRS, jax.random.key(0))
    mu = jax.device_get(new.opt_state[1].mu)
    grads = jax.tree.map(lambda m: np.asarray(m, np.float32) / 0.1, mu)
    return float(metrics["loss"]), state_dict_from_jax(grads, {})


@functools.lru_cache(maxsize=None)
def _port_run(case: str):
    """The port side of ``case``: the step's loss, its clipped gradients by
    the reference's names, and the ViT MLP's launches of dense_gelu_dense."""
    switches, bf16 = CASES[case]
    model = CXRClip(ModelConfig(**dict(TINY, **switches)))
    model.load_state_dict(state_dict_from_jax(_params(), {}), strict=True)
    if bf16:
        cast_in_forward(model, torch.bfloat16)
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(model, label_fn, weight_decay=PRESET.train.weight_decay)
    step = make_clip_pretrain_step(
        model, opt, label_fn, temperature=T, image_size=32, mean=CLIP_MEAN, std=CLIP_STD,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        max_grad_norm=PRESET.train.max_grad_norm)
    calls = []
    real = mlp_train.dense_gelu_dense

    def counted(*a, **kw):
        calls.append(kw.get("approximate", False))
        return real(*a, **kw)

    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mlp_train, "dense_gelu_dense", counted)
        _, metrics = step(TrainState(model, opt), batch, LRS)
    grads = {plain_name(n): p.grad.float().clone() for n, p in model.named_parameters()}
    return float(metrics["loss"]), grads, calls


def test_vit_preset_step_fp32_matches_jax():
    """fp32, the plain route: the loss (≈ 2) within 5e-5 and every clipped
    gradient within 1e-4 of its tensor's largest entry (fp32 sums in other
    orders), as the ResNet step (A3); no fused MLP ran."""
    jloss, jgrads = _jax_run("fp32_plain")
    loss, grads, calls = _port_run("fp32_plain")
    assert calls == []
    np.testing.assert_allclose(loss, jloss, atol=5e-5, rtol=0)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        w = jgrads[name]
        tol = 1e-4 * float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=name)


def _cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))


@pytest.mark.parametrize("case", ["bf16_kernels_erf", "bf16_kernels_tanh"])
def test_vit_preset_step_bf16_fused_mlp_train_matches_jax(case):
    """bf16 compute over fp32 masters on both sides, flash attention and
    the ViT's training MLP through dense_gelu_dense, one call a layer with
    the layer's GELU form. The frameworks round bf16 at other
    places (flax casts each Dense's output, the port's plain versions round
    where the kernels do), so: the loss (≈ 2) within 2e-2 relative and each
    parameter group's gradient cosine at least 0.99, the chip's bounds for
    the kernels against their plain versions (chip_smoke.py phase 4)."""
    switches, _ = CASES[case]
    jloss, jgrads = _jax_run(case)
    loss, grads, calls = _port_run(case)
    approximate = switches.get("vit_gelu_approximate", False)
    assert calls == [approximate] * TINY["vit_layers"]
    assert abs(loss - jloss) <= 2e-2 * abs(jloss)
    label_fn = make_label_fn(GROUPS)
    by_group = {}
    for name, g in grads.items():
        label = label_fn(tuple(name.split(".")))
        by_group.setdefault(label, ([], []))
        by_group[label][0].append(g.flatten())
        by_group[label][1].append(jgrads[name].flatten())
    for label, (got, want) in by_group.items():
        got, want = torch.cat(got), torch.cat(want)
        if not want.any():  # the heads the pretrain forward skips
            assert not got.any(), label
            continue
        assert _cosine(got, want) >= 0.99, (label, _cosine(got, want))


def test_pretrain_vit_takes_every_kernel_flag(tmp_path, monkeypatch):
    """``pretrain --preset vit`` with --fast-gelu, --fused-mlp,
    --flash-attention, --bert-fused-mlp and --vit-fused-mlp-train together
    (the flags that exited 2 before) runs one epoch on the CPU in bf16, and
    the model it trains carries every switch (at --tiny's hidden 64 the
    kernels' gates stay shut, so the plain routes run)."""
    import contextlib
    import importlib
    import io

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    built = []
    real = cli._model

    def keep(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    monkeypatch.setattr(cli, "_model", keep)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["pretrain", "--preset", "vit", "--tiny", "--synthetic",
                       "--synthetic-samples", "8", "--batch-size", "4", "--epochs", "1",
                       "--fast-gelu", "--fused-mlp", "--flash-attention", "--bert-fused-mlp",
                       "--vit-fused-mlp-train", "--log-dir", str(tmp_path)])
    assert rc == 0 and "pretrain done: 1 epochs" in out.getvalue()
    (model,) = built
    cfg = model.config
    assert (cfg.vit_gelu_approximate, cfg.vit_fused_mlp, cfg.flash_attention,
            cfg.bert_fused_mlp, cfg.vit_fused_mlp_train) == (True,) * 5
    layer = model.image_tower.encoder.layers[0]
    assert layer.fused_mlp_train and layer.fused_mlp and layer.gelu_approximate
