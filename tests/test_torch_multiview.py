"""Parity of the port's multi-view step (the scripts' training, with and
without the cross-modal attention), its eval step and the shared-embedding
adapter's steps with the JAX package's, on the CPU in fp32.

A tiny JAX CXRClip (ResNet stages (1, 1, 1, 1) at width 16; BERT with 2
layers, hidden 64, 2 heads, intermediate 128; shared 64; 32 px images;
dropout 0) gets its variables from a seed; ``state_dict_from_jax`` carries
them, and the JAX gradient and state trees, into the port. The same numpy
batch and prompt-bank features then go through both steps. The multi-view
fusion's dropout (0.2) has no configuration knob, so these tests switch it
off on both sides: ``flax.linen.Dropout.__call__`` is the identity while
the JAX functions are traced, and the port's ``view_fusion.fusion[2].p``
is 0. Augmentation is off here; ``tests/test_torch_augment.py`` holds the
warp against JAX's on JAX's draws. Tolerances are stated per test.
"""

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
from clip_for_dl_tpu.losses import asymmetric_loss as jasymmetric_loss
from clip_for_dl_tpu.losses import bce_with_logits_loss as jbce_loss
from clip_for_dl_tpu.losses import multilabel_contrastive_loss as jmultilabel_loss
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.ops.image_prep import preprocess_images as jpreprocess
from clip_for_dl_tpu.ops.similarity import l2_normalize as jl2_normalize
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform, freeze_mask
from clip_for_dl_tpu.train import make_multiview_eval_step as jmake_eval_step
from clip_for_dl_tpu.train import make_multiview_train_step as jmake_step
from clip_for_dl_tpu.train import make_shared_adapter_eval_step as jmake_shared_eval_step
from clip_for_dl_tpu.train import make_shared_adapter_train_step as jmake_shared_step
from clip_for_dl_tpu_torch.core.config import IMAGENET_MEAN, IMAGENET_STD, ModelConfig, get_preset
from clip_for_dl_tpu_torch.core.device import cast_in_forward
from clip_for_dl_tpu_torch.models import CXRClip, init_weights, state_dict_from_jax
from clip_for_dl_tpu_torch.models.heads import MultiViewFusion
from clip_for_dl_tpu_torch.train import (
    TrainState,
    make_label_fn,
    make_multiview_eval_step,
    make_multiview_train_step,
    make_optimizer,
    make_shared_adapter_eval_step,
    make_shared_adapter_train_step,
)

joptim = importlib.import_module("clip_for_dl_tpu.train.optim")

torch.set_num_threads(1)

TINY = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=64,
    text_layers=2, text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=16,
    dropout=0.0, flash_attention=True,
)
PRESET = get_preset("scripts_train")
T = PRESET.model.temperature  # 0.07
LR = 1e-3  # above the preset's 1e-4, so that three steps move the loss
WEIGHT_DECAY = PRESET.train.weight_decay  # 0.01
CLIP = PRESET.train.max_grad_norm  # 1.0
PREP = dict(image_size=32, mean=IMAGENET_MEAN, std=IMAGENET_STD)
STEPS = 3
B = 4


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


def _config(enhance: bool) -> dict:
    return dict(TINY, use_multimodal_attention=enhance)


def _variables(enhance: bool, seed: int = 1):
    jmodel = JCXRClip(JModelConfig(**_config(enhance)))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(seed)
    return jmodel, {"params": _fill(shapes["params"], rng),
                    "batch_stats": _fill(shapes["batch_stats"], rng)}


def _batch(seed=2):
    """(frontal, lateral) 48x48 grey uint8 exams (resized to 32), 16-label
    multi-hot targets with every exam and most classes positive somewhere;
    report token ids with padded tails, and the frontal views alone, for
    the shared adapter."""
    rng = np.random.default_rng(seed)
    labels = (rng.random((B, 16)) < 0.3).astype(np.float32)
    labels[np.arange(B), np.arange(B)] = 1.0
    mask = np.ones((B, 12), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    images = rng.integers(0, 256, (B, 2, 48, 48, 1), dtype=np.uint8)
    return {"images": images, "labels": labels,
            "input_ids": rng.integers(5, 64, (B, 12)).astype(np.int32),
            "attention_mask": mask}


def _bank(seed=3):
    """Unit prompt-bank features [16, 64], as encode_prompt_bank gives them."""
    f = np.random.default_rng(seed).standard_normal((16, 64)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


@mock.patch.object(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
def _jax_multiview(enhance: bool):
    """The JAX side with the fusion's dropout the identity: variables, the
    unclipped gradient of the first step's loss, the state after one step,
    the losses of STEPS steps and the eval step's outputs."""
    jmodel, variables = _variables(enhance)
    b = _batch()
    batch = {"images": jnp.asarray(b["images"]), "labels": jnp.asarray(b["labels"])}
    bank = jnp.asarray(_bank())

    def loss_fn(params):
        flat = batch["images"].reshape((2 * B, 48, 48, 1))
        images = jpreprocess(flat, 32, 32, IMAGENET_MEAN, IMAGENET_STD, jnp.float32)
        feats, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            images.reshape((B, 2, 32, 32, 3)), train=True,
            mutable=["batch_stats", "losses"], rngs={"dropout": jax.random.key(0)},
            method="encode_multiview")
        if enhance:
            enhanced, _ = jmodel.apply({"params": params}, feats, bank, method="enhance")
            return jasymmetric_loss(jl2_normalize(enhanced) @ bank.T / T, batch["labels"])
        return jmultilabel_loss(feats, bank, batch["labels"], T)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    tx = base_transform(max_grad_norm=CLIP, weight_decay=WEIGHT_DECAY)
    step = jax.jit(jmake_step(jmodel, tx, joptim.make_label_fn([]), temperature=T,
                              compute_dtype=jnp.float32, use_enhance=enhance, augment=False,
                              **PREP))
    state = JTrainState.create(variables, tx)
    evaluated = jax.device_get(jmake_eval_step(jmodel, T, compute_dtype=jnp.float32,
                                               use_enhance=enhance, **PREP)(state, batch, bank))
    losses, after_one = [], None
    for i in range(STEPS):
        state, metrics = step(state, batch, bank, {"default": LR}, jax.random.key(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            after_one = jax.device_get(state)
    return dict(variables=variables, loss=float(loss), grads=jax.device_get(grads),
                after_one=after_one, losses=losses, evaluated=evaluated)


_jax_run = functools.lru_cache(maxsize=None)(_jax_multiview)


def _port_model(variables, enhance: bool):
    model = CXRClip(ModelConfig(**_config(enhance)))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    model.view_fusion.fusion[2].p = 0.0
    return model


def _port_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


@functools.lru_cache(maxsize=None)
def _port_run(enhance: bool):
    """The port side: STEPS steps; after the first, every gradient (clipped,
    as the step leaves it) and the state dict."""
    jr = _jax_run(enhance)
    model = _port_model(jr["variables"], enhance)
    label_fn = make_label_fn([])
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
    step = make_multiview_train_step(model, opt, label_fn, T, compute_dtype=torch.float32,
                                     use_enhance=enhance, augment=False, max_grad_norm=CLIP,
                                     **PREP)
    state, batch, bank = TrainState(model, opt), _port_batch(), torch.from_numpy(_bank())
    losses, grads, after_one = [], None, None
    for i in range(STEPS):
        state, metrics = step(state, batch, bank, {"default": LR})
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            after_one = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(losses=losses, grads=grads, after_one=after_one, steps=state.step)


def _clipped_jax_grads(jr):
    """The JAX gradient after optax's clip_by_global_norm, in the port's
    names and layouts."""
    norm = float(optax.global_norm(jr["grads"]))
    scale = CLIP / max(norm, CLIP)
    grads = jax.tree.map(lambda g: np.asarray(g) * scale, jr["grads"])
    return state_dict_from_jax(grads, jr["variables"]["batch_stats"])


ENHANCE = pytest.mark.parametrize("enhance", [False, True], ids=["multilabel", "enhance"])


@ENHANCE
def test_multiview_step_loss_matches_jax(enhance):
    """The first step's loss (multilabel contrastive at T = 0.07 ≈ 1-3;
    asymmetric ≈ 0.5): 5e-5 absolute."""
    jr, pr = _jax_run(enhance), _port_run(enhance)
    assert jr["losses"][0] == pytest.approx(jr["loss"], abs=1e-6)
    np.testing.assert_allclose(pr["losses"][0], jr["loss"], atol=5e-5, rtol=0)


@ENHANCE
def test_multiview_step_gradients_match_jax(enhance):
    """Every parameter's clipped gradient, the zero ones of the text tower,
    its projector and the adapters included: within 1e-3 of the tensor's
    largest entry, + 1e-9 (fp32 sums in other orders through BatchNorm over
    the 8 views and the attention's softmax; measured ≤ 2.1e-4 of it, at
    most 1.2e-6 absolute, where the largest entries are 5e-4 to 1e-2; the
    attention's score bias has a gradient of zero up to rounding, ~1e-10)."""
    want, got = _clipped_jax_grads(_jax_run(enhance)), _port_run(enhance)["grads"]
    assert set(got) <= set(want)
    zero = [n for n in got if n.startswith(("text_tower.", "text_projector.", "adapter.",
                                            "shared_adapter."))]
    assert zero and all(not got[n].any() and not want[n].any() for n in zero)
    assert enhance == any(n.startswith("multimodal_attention.") and got[n].any() for n in got)
    for name, g in got.items():
        w = want[name]
        tol = 1e-3 * float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=name)


@ENHANCE
def test_multiview_step_updated_parameters_match_jax(enhance):
    """Every parameter after the clip, Adam and decoupled decay of the first
    step. Adam's first update lr · g / (|g| + eps) moves by lr · eps · δg /
    |g|² for a gradient difference δg, so: 1e-6 where |g| > 1e-3 · max|g|
    of the tensor and |g| > 1e-6 (measured ≤ 1.2e-7), and at most one
    learning rate's step of either sign (2 · lr) elsewhere, where the
    update's sign can flip (the attention's score bias, whose gradient is
    zero up to rounding, among them). The parameters with zero gradients
    move by the decay alone, p·(1 − lr·wd), on both sides: two fp32
    rounding steps (2^-22 relative; optax computes p − lr·wd·p)."""
    jr, pr = _jax_run(enhance), _port_run(enhance)
    after = jr["after_one"]
    want = state_dict_from_jax(after.params, after.batch_stats)
    before = state_dict_from_jax(jr["variables"]["params"], jr["variables"]["batch_stats"])
    grads = _clipped_jax_grads(jr)
    names = dict(_port_model(jr["variables"], enhance).named_parameters())
    decayed = 0
    for name in names:
        got, w, g = pr["after_one"][name], want[name], grads[name]
        if not g.any():
            decay = before[name] * (1 - LR * WEIGHT_DECAY)
            torch.testing.assert_close(got, decay, atol=0, rtol=2.0 ** -22)
            torch.testing.assert_close(w, decay, atol=0, rtol=2.0 ** -22)
            decayed += bool(before[name].any())
            continue
        diff = (got - w).abs()
        big = (g.abs() > 1e-3 * g.abs().max()) & (g.abs() > 1e-6)
        assert not big.any() or float(diff[big].max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR, name
    assert decayed > 10  # the text tower's tensors, among others


@ENHANCE
def test_multiview_step_batchnorm_running_stats_match_jax(enhance):
    """Every running mean and variance after one step, their batch
    statistics taken over all 2B views in one call: 1e-5."""
    jr, pr = _jax_run(enhance), _port_run(enhance)
    want = state_dict_from_jax(jr["after_one"].params, jr["after_one"].batch_stats)
    before = state_dict_from_jax(jr["variables"]["params"], jr["variables"]["batch_stats"])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 17
    for k in keys:
        assert not torch.equal(pr["after_one"][k], before[k]), k
        np.testing.assert_allclose(pr["after_one"][k].numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


@ENHANCE
def test_multiview_three_step_trajectory_matches_jax(enhance):
    """Losses of three steps on one batch at lr 1e-3: 5e-4 (the later steps
    inherit the first update's near-eps elements, see above), falling."""
    jr, pr = _jax_run(enhance), _port_run(enhance)
    assert pr["steps"] == STEPS
    np.testing.assert_allclose(pr["losses"], jr["losses"], atol=5e-4, rtol=0)
    assert pr["losses"][-1] < pr["losses"][0]


@ENHANCE
def test_multiview_eval_step_matches_jax(enhance):
    """The eval step's loss, probabilities [B, 16], sample accuracy (%) and
    per-class accuracy from the initial weights in eval mode: 1e-5 (the
    accuracies exactly, no probability lies near the 0.5 threshold)."""
    jr = _jax_run(enhance)
    model = _port_model(jr["variables"], enhance)
    opt = make_optimizer(model, make_label_fn([]))
    step = make_multiview_eval_step(model, T, compute_dtype=torch.float32, use_enhance=enhance,
                                    **PREP)
    got = step(TrainState(model, opt), _port_batch(), torch.from_numpy(_bank()))
    want = jr["evaluated"]
    assert not model.training and set(got) == set(want)
    probs = np.asarray(want["probs"])
    assert probs.shape == (B, 16) and np.abs(probs - 0.5).min() > 1e-4
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_multiview_eval_step_scores_the_ema_parameters():
    """``use_ema`` scores ``state.ema_params`` with the live BatchNorm
    statistics: the same outputs (exactly) as a model that holds those
    parameters."""
    _, variables = _variables(True, seed=4)
    model = _port_model(variables, True)
    opt = make_optimizer(model, make_label_fn([]))
    state = TrainState.create(model, opt, ema=True)
    g = torch.Generator().manual_seed(0)
    for v in state.ema_params.values():
        v.add_(torch.randn(v.shape, generator=g) * 0.01)
    kw = dict(compute_dtype=torch.float32, use_enhance=True, **PREP)
    batch, bank = _port_batch(), torch.from_numpy(_bank())
    got = make_multiview_eval_step(model, T, use_ema=True, **kw)(state, batch, bank)
    live = make_multiview_eval_step(model, T, **kw)(state, batch, bank)
    twin = _port_model(variables, True)
    twin.load_state_dict(state.ema_params, strict=False)
    want = make_multiview_eval_step(twin, T, **kw)(TrainState(twin, opt), batch, bank)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    assert not torch.equal(got["probs"], live["probs"])


@mock.patch.object(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
def test_multiview_step_ema_matches_jax():
    """``ema_decay`` moves ``state.ema_params`` after the update as the JAX
    step does, the cross-modal variant at decay 0.9. After the first step
    (warmup-capped d = 0.1) the EMA takes 0.9 of the update, so the bounds
    of the updated-parameters test hold against JAX's: 1e-6 where
    |g| > 1e-3 · max|g| of the tensor and |g| > 1e-6, 2 · lr elsewhere, and
    2^-21 relative for a parameter with zero gradients (the decay alone).
    After the second (d = 2/11) it is d · EMA + (1 − d) · parameters of the
    port's own values: 1e-7."""
    jmodel, variables = _variables(True, seed=6)
    b = _batch()
    jbatch = {"images": jnp.asarray(b["images"]), "labels": jnp.asarray(b["labels"])}
    tx = base_transform(max_grad_norm=CLIP, weight_decay=WEIGHT_DECAY)
    kw = dict(temperature=T, use_enhance=True, augment=False, **PREP)
    jstep = jmake_step(jmodel, tx, joptim.make_label_fn([]), compute_dtype=jnp.float32,
                       ema_decay=0.9, **kw)
    bank = _bank()
    jstate, _ = jax.jit(jstep)(JTrainState.create(variables, tx, ema=True), jbatch,
                               jnp.asarray(bank), {"default": LR}, jax.random.key(0))
    want = state_dict_from_jax(jax.device_get(jstate.ema_params), variables["batch_stats"])

    model = _port_model(variables, True)
    label_fn = make_label_fn([])
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
    step = make_multiview_train_step(model, opt, label_fn, compute_dtype=torch.float32,
                                     max_grad_norm=CLIP, ema_decay=0.9, **kw)
    state = TrainState.create(model, opt, ema=True)
    state, _ = step(state, _port_batch(), torch.from_numpy(bank), {"default": LR})
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name, e in state.ema_params.items():
        w, g = want[name], grads[name]
        if not g.any():
            torch.testing.assert_close(e, w, atol=0, rtol=2.0 ** -21)
            continue
        diff = (e - w).abs()
        big = (g.abs() > 1e-3 * g.abs().max()) & (g.abs() > 1e-6)
        assert not big.any() or float(diff[big].max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR, name
    first = {n: e.clone() for n, e in state.ema_params.items()}
    state, _ = step(state, _port_batch(), torch.from_numpy(bank), {"default": LR})
    d = 2.0 / 11.0
    assert state.step == 2
    for name, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[name], d * first[name] + (1 - d) * p.detach(),
                                   atol=1e-7, rtol=0)


# -- the shared-embedding adapter ----------------------------------------------------------

SHARED_LRS = {"shared_adapter": LR, "default": 0.0}


@functools.lru_cache(maxsize=None)
def _jax_shared():
    jmodel, variables = _variables(False, seed=5)
    b = _batch()
    batch = {"images": jnp.asarray(b["images"][:, 0]), "labels": jnp.asarray(b["labels"]),
             "input_ids": jnp.asarray(b["input_ids"]),
             "attention_mask": jnp.asarray(b["attention_mask"])}

    def loss_fn(params):
        images = jpreprocess(batch["images"], 32, 32, IMAGENET_MEAN, IMAGENET_STD, jnp.float32)
        img = jmodel.apply(variables, images, method="encode_image")
        txt = jmodel.apply(variables, batch["input_ids"], batch["attention_mask"],
                           method="encode_text")
        logits = jmodel.apply({"params": params}, img, txt, method="shared_adapter_logits")
        return jbce_loss(logits, batch["labels"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    tx = base_transform(None, 0.0)
    step = jax.jit(jmake_shared_step(jmodel, tx, joptim.make_label_fn(["shared_adapter"]),
                                     freeze_mask(variables["params"], ["shared_adapter"]),
                                     compute_dtype=jnp.float32, **PREP))
    state = JTrainState.create(variables, tx)
    evaluated = jax.device_get(jmake_shared_eval_step(jmodel, compute_dtype=jnp.float32,
                                                      **PREP)(state, batch))
    losses, after_one = [], None
    for i in range(STEPS):
        state, metrics = step(state, batch, SHARED_LRS, jax.random.key(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            after_one = jax.device_get(state)
    return dict(variables=variables, loss=float(loss), grads=jax.device_get(grads),
                after_one=after_one, losses=losses, evaluated=evaluated)


def _port_shared_batch():
    b = _port_batch()
    return {**b, "images": b["images"][:, 0]}


@functools.lru_cache(maxsize=None)
def _port_shared():
    jr = _jax_shared()
    model = _port_model(jr["variables"], False)
    label_fn = make_label_fn(["shared_adapter"])
    opt = make_optimizer(model, label_fn, weight_decay=0.0)
    step = make_shared_adapter_train_step(model, opt, label_fn, compute_dtype=torch.float32,
                                          **PREP)
    state, batch = TrainState(model, opt), _port_shared_batch()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses, grads, after_one = [], None, None
    for i in range(STEPS):
        state, metrics = step(state, batch, SHARED_LRS)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            after_one = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(model=model, before=before, losses=losses, grads=grads, after_one=after_one,
                after=model.state_dict(), steps=state.step)


def test_shared_adapter_step_matches_jax():
    """The first loss (BCE ≈ 0.7): 5e-5; the shared adapter's gradient, the
    only one the port computes: 1e-4 of its largest entry; its weights
    after one step of Adam at lr 1e-3 without decay: 1e-6 where |g| >
    1e-4 · max|g|, 2 · lr elsewhere; three losses: 5e-4, falling."""
    jr, pr = _jax_shared(), _port_shared()
    assert jr["losses"][0] == pytest.approx(jr["loss"], abs=1e-6)
    np.testing.assert_allclose(pr["losses"][0], jr["loss"], atol=5e-5, rtol=0)
    want = state_dict_from_jax(jr["grads"], jr["variables"]["batch_stats"])
    assert set(pr["grads"]) == {"shared_adapter.classifier.weight",
                                "shared_adapter.classifier.bias"}
    after = state_dict_from_jax(jr["after_one"].params, jr["after_one"].batch_stats)
    for name, g in pr["grads"].items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * float(w.abs().max()),
                                   rtol=0, err_msg=name)
        diff = (pr["after_one"][name] - after[name]).abs()
        big = w.abs() > 1e-4 * w.abs().max()
        assert float(diff[big].max()) <= 1e-6 and float(diff.max()) <= 2 * LR, name
    assert pr["steps"] == STEPS
    np.testing.assert_allclose(pr["losses"], jr["losses"], atol=5e-4, rtol=0)
    assert pr["losses"][-1] < pr["losses"][0]


def test_shared_adapter_freezes_everything_else_bit_for_bit():
    """After three steps every tensor but the shared adapter's, BatchNorm
    statistics included, holds the bytes it started with, on both sides
    (the JAX ``freeze_mask`` and the port's groups without a gradient)."""
    jr, pr = _jax_shared(), _port_shared()
    jafter = state_dict_from_jax(jr["after_one"].params, jr["after_one"].batch_stats)
    jbefore = state_dict_from_jax(jr["variables"]["params"], jr["variables"]["batch_stats"])
    moved = set()
    for k, v in pr["after"].items():
        if k.startswith("shared_adapter."):
            moved.add(k)
            assert not torch.equal(v, pr["before"][k]), k
            continue
        assert torch.equal(v, pr["before"][k]), k
        assert torch.equal(jafter[k], jbefore[k]), k
    assert moved == {"shared_adapter.classifier.weight", "shared_adapter.classifier.bias"}


def test_shared_adapter_eval_step_matches_jax():
    """Loss and probabilities [B, 16] in eval mode: 1e-5."""
    jr = _jax_shared()
    model = _port_model(jr["variables"], False)
    opt = make_optimizer(model, make_label_fn(["shared_adapter"]))
    got = make_shared_adapter_eval_step(model, compute_dtype=torch.float32, **PREP)(
        TrainState(model, opt), _port_shared_batch())
    want = jr["evaluated"]
    assert not model.training and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)


# -- the port's own: the fusion's dropout, a bf16 step with augmentation -----------------------


def test_fusion_dropout_drops_a_fifth_from_the_step_generator():
    """In train mode the fusion drops about 20% of its hidden units (over
    16384 of them, 18.5-21.5%) and scales the rest by 1/0.8, its mask drawn
    from the generator it is given (torch's global one when none is): the
    same generator state, the same output; another state, another; eval
    mode drops nothing."""
    torch.manual_seed(0)
    fusion = MultiViewFusion(64).train()
    with torch.no_grad():
        fusion.fusion[3].weight.copy_(torch.eye(64))
        fusion.fusion[3].bias.zero_()
    x = torch.randn(256, 64), torch.randn(256, 64)
    hidden = torch.relu(fusion.fusion[0](torch.cat(x, -1))).detach()
    out = fusion(*x, generator=torch.Generator().manual_seed(3)).detach()
    again = fusion(*x, generator=torch.Generator().manual_seed(3)).detach()
    other = fusion(*x, generator=torch.Generator().manual_seed(4)).detach()
    live = hidden > 0
    dropped = float(((out == 0) & live).sum()) / float(live.sum())
    assert 0.185 < dropped < 0.215, dropped
    kept = (out != 0) & live
    torch.testing.assert_close(out[kept], hidden[kept] / 0.8, atol=1e-6, rtol=1e-6)
    assert torch.equal(out, again) and not torch.equal(out, other)
    torch.manual_seed(3)
    assert torch.equal(fusion(*x).detach(), out)
    torch.testing.assert_close(fusion.eval()(*x), hidden, atol=1e-6, rtol=1e-6)


def test_bf16_multiview_step_with_augmentation_and_dropout_repeats():
    """The step as the CLI runs it on the card, here on the CPU at tiny
    size: bf16 compute (cast_in_forward), the scripts' augmentation,
    dropout 0.1 and the fusion's 0.2, the cross-modal attention. Two runs
    from the same weights and generator seed give the same finite losses
    (the augmentation and every dropout mask come from the step's
    generator); the
    image tower and the attention move, the bank's text tower only by the
    decay."""
    cfg = ModelConfig(**dict(_config(True), dropout=0.1))
    losses = []
    for _ in range(2):
        torch.manual_seed(0)
        model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(0))
        cast_in_forward(model, torch.bfloat16)
        label_fn = make_label_fn([])
        opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
        step = make_multiview_train_step(model, opt, label_fn, T, use_enhance=True,
                                         augment=True, max_grad_norm=CLIP, **PREP)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, gen = TrainState(model, opt), torch.Generator().manual_seed(1)
        run = [float(step(state, _port_batch(), torch.from_numpy(_bank()), {"default": LR},
                          gen)[1]["loss"]) for _ in range(2)]
        losses.append(run)
    assert np.isfinite(losses).all() and losses[0] == losses[1]
    after = model.state_dict()
    conv = "image_tower.conv1.parametrizations.weight.original"
    attn = "multimodal_attention.image_proj.parametrizations.weight.original"
    assert not torch.equal(after[conv], before[conv])
    assert not torch.equal(after[attn], before[attn])
    word = "text_tower.embeddings.word_embeddings.parametrizations.weight.original"
    torch.testing.assert_close(after[word], before[word] * (1 - LR * WEIGHT_DECAY) ** 2,
                               atol=0, rtol=1e-6)


def test_multiview_step_repeats_with_only_the_step_generator_seeded():
    """Every dropout of the step (the image projection's and the fusion's)
    and the augmentation draw from the step's generator, as flax draws each
    from the step's key: two runs from the same weights and the same
    generator seed, with torch's global generator seeded differently, end
    bit-equal (losses and every tensor of the model)."""
    cfg = ModelConfig(**dict(_config(True), dropout=0.1))
    runs = []
    for global_seed in (0, 1):
        model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(0))
        label_fn = make_label_fn([])
        opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
        step = make_multiview_train_step(model, opt, label_fn, T, use_enhance=True,
                                         augment=True, max_grad_norm=CLIP, **PREP)
        torch.manual_seed(global_seed)
        state, gen = TrainState(model, opt), torch.Generator().manual_seed(1)
        losses = [float(step(state, _port_batch(), torch.from_numpy(_bank()), {"default": LR},
                             gen)[1]["loss"]) for _ in range(2)]
        runs.append((losses, model.state_dict()))
    (losses_a, sd_a), (losses_b, sd_b) = runs
    assert losses_a == losses_b
    for k, v in sd_a.items():
        assert torch.equal(v, sd_b[k]), k
