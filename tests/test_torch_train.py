"""Parity of the port's phase-A train step (clip_for_dl_tpu_torch/train,
losses, the models in train mode) with the JAX package's, on the CPU in fp32.

A tiny JAX CXRClip (ResNet stages (1, 1, 1, 1) at width 8; BERT with 2
layers, hidden 128, 2 heads, intermediate 256; 32 px images; flash
attention on, dropout 0) gets its variables from a seed; ``state_dict_from_jax``
carries them, and the JAX gradient and state trees, into the port. The same
numpy batch then goes through ``make_clip_pretrain_step`` on both sides, with
the preset's group learning rates, weight decay 1e-3 and clipping at 1.0.
Tolerances are stated per test.
"""

import dataclasses
import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.losses import clip_self_distill_loss as jclip_loss
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.ops.image_prep import preprocess_images as jpreprocess
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform
from clip_for_dl_tpu.train import make_clip_eval_step as jmake_eval_step
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_step
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, ModelConfig, get_preset
from clip_for_dl_tpu_torch.core.device import cast_in_forward, cast_matmul_weights, plain_name
from clip_for_dl_tpu_torch.losses import clip_self_distill_loss
from clip_for_dl_tpu_torch.models import CXRClip, init_weights, state_dict_from_jax
from clip_for_dl_tpu_torch.models.resnet import _bn
from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.ops import mlp_train as mlp
from clip_for_dl_tpu_torch.ops.image_prep import preprocess_images
from clip_for_dl_tpu_torch.train import (
    TrainState,
    clip_by_global_norm_,
    make_clip_eval_step,
    make_clip_pretrain_step,
    make_label_fn,
    make_optimizer,
)
from clip_for_dl_tpu_torch.train import optim as port_optim

joptim = importlib.import_module("clip_for_dl_tpu.train.optim")

torch.set_num_threads(1)

TINY = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=128,
    text_layers=2, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    dropout=0.0, flash_attention=True,
)
PRESET = get_preset("pretrain_clip")
GROUPS = [g.name for g in PRESET.train.groups]
LRS = {**{g.name: g.lr for g in PRESET.train.groups}, "default": PRESET.train.lr}
WEIGHT_DECAY = PRESET.train.weight_decay
STEPS = 3


def _fill(tree, rng, path=()):
    """Random values for every leaf: fan-in-scaled kernels, non-zero biases,
    norm scales near 1 and BatchNorm statistics away from (0, 1)."""
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


def _batch(seed=2, b=4):
    """48x48 grey uint8 images (resized to 32 in the step) and token ids
    with padded tails of different lengths."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 12), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    mask[3, 9:] = 0
    return {"images": rng.integers(0, 256, (b, 48, 48, 1), dtype=np.uint8),
            "input_ids": rng.integers(5, 64, (b, 12)).astype(np.int32),
            "attention_mask": mask}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX side: variables, the unclipped loss gradient on the batch,
    the state after one step, the losses of STEPS steps and the eval loss."""
    jmodel = JCXRClip(JModelConfig(**TINY))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(1)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(params):
        images = jpreprocess(batch["images"], 32, 32, CLIP_MEAN, CLIP_STD, jnp.float32)
        (img, txt), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, images,
            batch["input_ids"], batch["attention_mask"], train=True,
            mutable=["batch_stats", "losses"], rngs={"dropout": jax.random.key(0)})
        return jclip_loss(txt, img, 2.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    tx = base_transform(max_grad_norm=PRESET.train.max_grad_norm, weight_decay=WEIGHT_DECAY)
    step = jax.jit(jmake_step(jmodel, tx, joptim.make_label_fn(GROUPS), temperature=2.0,
                              image_size=32, mean=CLIP_MEAN, std=CLIP_STD,
                              compute_dtype=jnp.float32))
    state = JTrainState.create(variables, tx)
    eval_loss = jmake_eval_step(jmodel, temperature=2.0, image_size=32, mean=CLIP_MEAN,
                                std=CLIP_STD, compute_dtype=jnp.float32)(state, batch)["loss"]
    losses, after_one = [], None
    for i in range(STEPS):
        state, metrics = step(state, batch, LRS, jax.random.key(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            after_one = jax.device_get(state)
    return dict(variables=variables, loss=float(loss), grads=jax.device_get(grads),
                after_one=after_one, losses=losses, eval_loss=float(eval_loss))


def _port_model(variables):
    model = CXRClip(ModelConfig(**TINY))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def _port_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


@functools.lru_cache(maxsize=None)
def _port_run():
    """The port side: STEPS steps; after the first, every gradient (clipped,
    as the step leaves it) and the state dict."""
    jr = _jax_run()
    model = _port_model(jr["variables"])
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
    step = make_clip_pretrain_step(model, opt, label_fn, temperature=2.0, image_size=32,
                                   mean=CLIP_MEAN, std=CLIP_STD, compute_dtype=torch.float32,
                                   max_grad_norm=PRESET.train.max_grad_norm)
    state, batch = TrainState(model, opt), _port_batch()
    losses, grads, after_one = [], None, None
    for i in range(STEPS):
        state, metrics = step(state, batch, LRS)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            after_one = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(losses=losses, grads=grads, after_one=after_one, steps=state.step)


def _clipped_jax_grads():
    """The JAX gradient after optax's clip_by_global_norm(1.0), in the
    port's names and layouts."""
    jr = _jax_run()
    norm = float(optax.global_norm(jr["grads"]))
    scale = 1.0 / max(norm, 1.0)
    assert norm > 1.0  # the clip is active, so the test also checks it
    grads = jax.tree.map(lambda g: np.asarray(g) * scale, jr["grads"])
    return state_dict_from_jax(grads, jr["variables"]["batch_stats"])


def test_pretrain_step_loss_matches_jax():
    """Loss of the first step (|loss| ≈ 4): 5e-5 absolute, fp32 sums in
    other orders through BatchNorm over 4 samples (measured 1.9e-5)."""
    jr, pr = _jax_run(), _port_run()
    assert jr["losses"][0] == pytest.approx(jr["loss"], abs=1e-6)
    np.testing.assert_allclose(pr["losses"][0], jr["loss"], atol=5e-5, rtol=0)


def test_pretrain_step_gradients_match_jax():
    """Every parameter's clipped gradient: within 1e-4 of the tensor's
    largest entry (fp32 sums in other orders through BatchNorm on a batch
    of 4 and the attention backward; measured ≤ 4e-5)."""
    want, got = _clipped_jax_grads(), _port_run()["grads"]
    assert set(got) <= set(want)
    for name, g in got.items():
        w = want[name]
        tol = 1e-4 * float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=name)


def test_pretrain_step_updated_parameters_match_jax():
    """Every parameter after the clip, Adam and decoupled decay of the first
    step, with the preset's group learning rates. Adam's first update is
    g / (|g| + eps), so it is ill-conditioned where |g| is near eps: there
    a difference in the gradient's last bits can flip the step's sign. So:
    1e-6 where |g| > 1e-4 · max|g| of the tensor (measured ≤ 6e-8), and at
    most one learning rate's step of either sign (2 · lr) elsewhere."""
    jr, pr = _jax_run(), _port_run()
    after = jr["after_one"]
    want = state_dict_from_jax(after.params, after.batch_stats)
    grads = _clipped_jax_grads()
    label_fn = make_label_fn(GROUPS)
    names = dict(_port_model(jr["variables"]).named_parameters())
    for name in names:
        got, w, g = pr["after_one"][name], want[name], grads[name]
        lr = LRS[label_fn(tuple(name.split(".")))]
        diff = (got - w).abs()
        big = g.abs() > 1e-4 * g.abs().max()
        assert not big.any() or float(diff[big].max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * lr, name


def test_pretrain_step_batchnorm_running_stats_match_jax():
    """Every running mean and variance after one step (flax momentum 0.9,
    biased batch variance; values ~1): 1e-5."""
    jr, pr = _jax_run(), _port_run()
    want = state_dict_from_jax(jr["after_one"].params, jr["after_one"].batch_stats)
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 17  # stem + 4 blocks x (3 convs + downsample)
    before = state_dict_from_jax(jr["variables"]["params"], jr["variables"]["batch_stats"])
    for k in keys:
        assert not torch.equal(pr["after_one"][k], before[k]), k
        np.testing.assert_allclose(pr["after_one"][k].numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_three_step_loss_trajectory_matches_jax():
    """Losses of three steps on one batch (≈ 4.0, 2.1, 0.75): 5e-4, the
    second and third inheriting the first update's near-zero-gradient
    elements (see above)."""
    jr, pr = _jax_run(), _port_run()
    assert pr["steps"] == STEPS
    np.testing.assert_allclose(pr["losses"], jr["losses"], atol=5e-4, rtol=0)
    assert pr["losses"][-1] < pr["losses"][0]


def test_eval_step_matches_jax():
    """Eval-mode loss (running BatchNorm statistics, no dropout): 1e-5."""
    jr = _jax_run()
    model = _port_model(jr["variables"])
    opt = make_optimizer(model, make_label_fn(GROUPS))
    step = make_clip_eval_step(model, temperature=2.0, image_size=32, mean=CLIP_MEAN,
                               std=CLIP_STD, compute_dtype=torch.float32)
    got = float(step(TrainState(model, opt), _port_batch())["loss"])
    assert not model.training
    np.testing.assert_allclose(got, jr["eval_loss"], atol=1e-5, rtol=0)


def test_clip_self_distill_loss_matches_jax():
    """Raw bf16 features in, fp32 loss out: 1e-6."""
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((6, 32)).astype(np.float32)
    img = rng.standard_normal((6, 32)).astype(np.float32)
    want = float(jclip_loss(jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16), 2.0))
    got = clip_self_distill_loss(torch.from_numpy(txt).bfloat16(),
                                 torch.from_numpy(img).bfloat16(), 2.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["make_label_fn", "cosine_annealing_lr", "warmup_scale",
                                  "ReduceLROnPlateau", "CosineSchedule", "EarlyStopping"])
def test_copied_optimizer_helpers_equal_originals(name):
    """The host-side helpers are copies: same source text."""
    assert inspect.getsource(getattr(port_optim, name)) == inspect.getsource(
        getattr(joptim, name))


def test_copied_schedules_behave_as_originals():
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8, 0.9]
    lrs = {"a": 1e-3, "b": 1e-4}
    ours, theirs = port_optim.ReduceLROnPlateau(lrs), joptim.ReduceLROnPlateau(lrs)
    es_ours, es_theirs = port_optim.EarlyStopping(3), joptim.EarlyStopping(3)
    for m in metrics:
        assert ours.step(m) == theirs.step(m)
        assert es_ours.step(m) == es_theirs.step(m)
    cs, jcs = port_optim.CosineSchedule(lrs, 10, 1e-6), joptim.CosineSchedule(lrs, 10, 1e-6)
    assert [cs.at_epoch(e) for e in range(11)] == [jcs.at_epoch(e) for e in range(11)]
    label = port_optim.make_label_fn(GROUPS)
    assert label(("text_tower", "embeddings")) == "text_tower"
    assert label(("view_fusion", "fusion")) == "default" == label(())


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below_max", "above_max"])
def test_clip_by_global_norm_matches_optax(scale):
    """optax's form t / max(norm, max) · max, both sides of the bound: 1e-7."""
    rng = np.random.default_rng(6)
    grads = [np.asarray(rng.standard_normal(s) * scale, np.float32) for s in ((5, 3), (7,), ())]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_(params, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), atol=1e-7, rtol=0)


def test_make_optimizer_groups_labels_and_decay_mask():
    """One group per (label, ndim > 0); 0-dim parameters are not decayed."""
    model = torch.nn.Module()
    model.image_tower = torch.nn.Linear(3, 2)
    model.view_fusion = torch.nn.Linear(2, 2)
    model.logit_scale = torch.nn.Parameter(torch.tensor(1.0))
    opt = make_optimizer(model, make_label_fn(["image_tower"]), weight_decay=1e-3)
    groups = {(g["label"], g["weight_decay"]): len(g["params"]) for g in opt.param_groups}
    assert groups == {("image_tower", 1e-3): 2, ("default", 1e-3): 2, ("default", 0.0): 1}


def test_batchnorm_train_mode_uses_batch_stats_and_biased_variance():
    """flax: running ← 0.9·running + 0.1·batch with the biased variance
    (n = 4 samples here, where the unbiased one is 4/3 larger)."""
    bn = torch.nn.BatchNorm2d(3).train()
    x = torch.randn(4, 3, 1, 1, generator=torch.Generator().manual_seed(0))
    out = _bn(bn, x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, atol=1e-7, rtol=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, atol=1e-7, rtol=0)
    torch.testing.assert_close(out, (x - mean[:, None, None]) / torch.sqrt(
        var[:, None, None] + bn.eps), atol=1e-6, rtol=0)


def test_cast_in_forward_keeps_serving_numbers_and_fp32_gradients():
    """bf16 compute with fp32 masters gives the eval forward of the model
    whose weights were cast (bit for bit), and fp32 gradients."""
    cfg = ModelConfig(**dict(TINY, bert_fused_mlp=True, dropout=0.1))
    a = init_weights(CXRClip(cfg), torch.Generator().manual_seed(3))
    b = CXRClip(cfg)
    b.load_state_dict(a.state_dict())
    cast_matmul_weights(a, torch.bfloat16).eval()
    cast_in_forward(b, torch.bfloat16).eval()
    images = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(4)).bfloat16()
    ids = torch.randint(5, 64, (2, 12), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        assert torch.equal(a.encode_image(images), b.encode_image(images))
        assert torch.equal(a.encode_text(ids), b.encode_text(ids))
    masters = dict(b.named_parameters())
    assert "image_tower.conv1.parametrizations.weight.original" in masters
    assert all(p.dtype == torch.float32 for p in masters.values())
    img, txt = b.train()(images, ids)
    assert img.dtype == txt.dtype == torch.bfloat16
    clip_self_distill_loss(txt, img).backward()
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in masters.values())


def test_bf16_step_with_dropout_runs_both_autograd_functions(monkeypatch):
    """The chip's configuration at tiny size on the CPU: bf16 compute over
    fp32 masters, flash attention with in-kernel dropout 0.1 and the fused
    MLP, each through its autograd function; finite losses, every group
    and the BatchNorm statistics move, and the loss falls over 4 steps
    (measured 3.52 → 0.63)."""
    calls = {"flash": 0, "mlp": 0}
    for mod, cls, key in ((fa, "_FlashPacked", "flash"), (mlp, "_MLP", "mlp")):
        orig = getattr(mod, cls).backward

        def counted(ctx, *g, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(ctx, *g)

        monkeypatch.setattr(getattr(mod, cls), "backward", staticmethod(counted))
    cfg = ModelConfig(**dict(TINY, bert_fused_mlp=True, dropout=0.1))
    model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(8))
    cast_in_forward(model, torch.bfloat16)
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
    step = make_clip_pretrain_step(model, opt, label_fn, image_size=32, mean=CLIP_MEAN,
                                   std=CLIP_STD)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, batch, gen = TrainState(model, opt), _port_batch(), torch.Generator().manual_seed(9)
    losses = [float(step(state, batch, LRS, gen)[1]["loss"]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert calls == {"flash": 4 * TINY["text_layers"], "mlp": 4 * TINY["text_layers"]}
    after = model.state_dict()
    for group in GROUPS:
        assert any(not torch.equal(after[k], before[k]) for k in after
                   if k.startswith(group + ".") and "running" not in k), group
    assert not torch.equal(after["image_tower.bn1.running_var"],
                           before["image_tower.bn1.running_var"])


@pytest.mark.parametrize("case", ["local_loss"])
def test_unported_step_options_raise(case):
    """The local-loss form is ported (losses/global_batch.py) and is a form
    of the loss over a process group's global batch: without a group the
    step refuses it, as the JAX CLI refuses --local-loss without a dp
    mesh (tests/test_torch_dp.py runs it over gloo ranks)."""
    model = CXRClip(ModelConfig(**TINY))
    opt = make_optimizer(model, make_label_fn(GROUPS))
    with pytest.raises(ValueError, match="needs a process group"):
        make_clip_pretrain_step(model, opt, make_label_fn(GROUPS), local_loss=True)


def test_step_refuses_a_state_with_another_model():
    model = CXRClip(ModelConfig(**TINY))
    opt = make_optimizer(model, make_label_fn(GROUPS))
    step = make_clip_pretrain_step(model, opt, make_label_fn(GROUPS), image_size=32)
    other = dataclasses.replace(TrainState(model, opt), model=CXRClip(ModelConfig(**TINY)))
    with pytest.raises(ValueError, match="another model"):
        step(other, _port_batch(), LRS)



def test_pretrain_step_repeats_with_only_the_step_generator_seeded():
    """Every dropout of the pretrain step (BERT's embeddings, attention
    output and MLP output, the attention kernel's seeds, both projection
    heads) draws from the step's generator, as flax draws each from the
    step's key: two runs from the same weights and generator seed, with
    torch's global generator seeded differently, end bit-equal; a third
    with another generator seed differs."""
    cfg = ModelConfig(**dict(TINY, dropout=0.1))
    runs = []
    for global_seed, step_seed in ((0, 9), (1, 9), (0, 10)):
        model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(8))
        label_fn = make_label_fn(GROUPS)
        opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
        step = make_clip_pretrain_step(model, opt, label_fn, image_size=32, mean=CLIP_MEAN,
                                       std=CLIP_STD, compute_dtype=torch.float32)
        torch.manual_seed(global_seed)
        state, gen = TrainState(model, opt), torch.Generator().manual_seed(step_seed)
        losses = [float(step(state, _port_batch(), LRS, gen)[1]["loss"]) for _ in range(2)]
        runs.append((losses, model.state_dict()))
    (losses_a, sd_a), (losses_b, sd_b), (losses_c, _) = runs
    assert losses_a == losses_b and losses_a != losses_c
    for k, v in sd_a.items():
        assert torch.equal(v, sd_b[k]), k


def _image_tower_departure(jax_side: bool, seed: int) -> float:
    """1 − cosine between the first-step image-tower gradient in bf16
    compute and in fp32, in one framework, on seeded weights and batch."""
    shapes = _jax_shapes()
    rng = np.random.default_rng(100 + seed)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    batch = _batch(seed=10 + seed)
    grads = []
    for bf16 in (False, True):
        if jax_side:
            g = _jax_image_tower_grad(bf16)(variables, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
            grads.append(np.concatenate([np.asarray(x, np.float32).ravel()
                                         for x in jax.tree.leaves(g)]))
            continue
        model = _port_model(variables)
        if bf16:
            cast_in_forward(model, torch.bfloat16)
        images = preprocess_images(torch.from_numpy(batch["images"]), 32, 32, CLIP_MEAN,
                                   CLIP_STD, torch.bfloat16 if bf16 else torch.float32)
        img, txt = model.train()(images, torch.from_numpy(batch["input_ids"]),
                                 torch.from_numpy(batch["attention_mask"]))
        clip_self_distill_loss(txt, img, 2.0).backward()
        named = {plain_name(n): p.grad.float() for n, p in model.named_parameters()
                 if n.startswith("image_tower.")}
        grads.append(torch.cat([named[n].flatten() for n in sorted(named)]).numpy())
    a, b = grads
    return 1.0 - float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _jax_shapes():
    return jax.eval_shape(JCXRClip(JModelConfig(**TINY)).init, jax.random.key(0),
                          jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 12), jnp.int32))


@functools.lru_cache(maxsize=None)
def _jax_image_tower_grad(bf16: bool):
    jmodel = JCXRClip(JModelConfig(**TINY), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    dt = jnp.bfloat16 if bf16 else jnp.float32

    def grad(variables, batch):
        def loss_fn(params):
            images = jpreprocess(batch["images"], 32, 32, CLIP_MEAN, CLIP_STD, dt)
            (img, txt), _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]}, images,
                batch["input_ids"], batch["attention_mask"], train=True,
                mutable=["batch_stats", "losses"], rngs={"dropout": jax.random.key(0)})
            return jclip_loss(txt, img, 2.0)

        return jax.grad(loss_fn)(variables["params"])["image_tower"]

    return jax.jit(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_image_tower_gradient_departs_from_fp32_as_in_jax(seed):
    """ROADMAP C's "to settle" item: the bf16 image tower's first-step
    gradient against the same framework's fp32 one, at random weights, on
    the same seeded weights and batch in both frameworks (JAX's step
    jitted, as the JAX package runs it). Both depart: over seeds 0-5 here
    JAX by 1 - cos = 0.048-0.226 and the port by 0.084-0.277, 0.82-1.97
    times JAX's (run op by op, unjitted, JAX departs by as much as the
    port: 0.87-1.10 times over seeds 0-3; under jit XLA keeps some fused
    intermediates in fp32). So the port's departure is JAX's own, within a
    factor 2.5, and the near-orthogonal gradient the card shows at full
    width belongs to bf16 compute at random init, not to the port's dtype
    policy."""
    jax_dep = _image_tower_departure(True, seed)
    port_dep = _image_tower_departure(False, seed)
    assert jax_dep > 0.01
    assert port_dep <= 2.5 * jax_dep, (port_dep, jax_dep)
