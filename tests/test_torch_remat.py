"""Rematerialization in the port (clip_for_dl_tpu_torch/models/remat.py,
``--remat`` / ``--remat-policy``) on the CPU in fp32.

As tests/test_remat.py holds the JAX package: a policy changes what the
backward recomputes, never a value. For every policy and tower (the ResNet
blocks under ``remat_conv``, the ViT and BERT layers, the MoE text tower)
the loss and every gradient equal the port's without remat bit for bit;
so do a train step's loss, parameters, BatchNorm running statistics and
generator at dropout 0.1. Planted faults show that the comparisons see the
two things a recompute must carry by hand: the explicit dropout generator
and BatchNorm's running-statistics update (the MoE routing group over
gloo ranks is tests/test_torch_multiprocess.py's). Which products each
policy saves is read off the operators the backward runs. Against JAX, the
``--remat`` step at tests/test_torch_train.py's bounds (loss 5e-5,
gradients 1e-4 of each tensor's largest).
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.losses import clip_self_distill_loss as jclip_loss
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.remat import REMAT_POLICIES as JREMAT_POLICIES
from clip_for_dl_tpu.ops.image_prep import preprocess_images as jpreprocess
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, ModelConfig
from clip_for_dl_tpu_torch.models import CXRClip, init_weights, remat, resnet, state_dict_from_jax
from clip_for_dl_tpu_torch.models.moe import routing
from clip_for_dl_tpu_torch.models.remat import REMAT_POLICIES, resolve_remat_policy
from clip_for_dl_tpu_torch.models.resnet import batch_norm_context
from clip_for_dl_tpu_torch.train import (
    TrainState,
    make_clip_pretrain_step,
    make_label_fn,
    make_optimizer,
)
from test_torch_train import GROUPS, LRS, PRESET, WEIGHT_DECAY, _batch, _fill

torch.set_num_threads(1)

TINY = ModelConfig(
    image_size=16, max_text_length=8, vocab_size=64, text_embedding_dim=16,
    text_layers=2, text_heads=2, text_intermediate_dim=32, shared_embedding_dim=32,
    resnet_stages=(1, 1, 1, 1), resnet_width=8,
)
VIT = dict(image_tower="vit_b16", image_embedding_dim=32, vit_patch=4, vit_layers=2,
           vit_hidden=32, vit_heads=2, vit_mlp_dim=64)
TOWERS = {"resnet50": {}, "vit_b16": VIT, "moe": dict(text_moe_experts=2)}
POLICIES = ["full", "dots", "dots_no_batch"]


def _config(tower, policy=None, **kw):
    cfg = dataclasses.replace(TINY, **TOWERS[tower], **kw)
    if policy is not None:
        cfg = dataclasses.replace(cfg, remat=True, remat_conv=True, remat_policy=policy)
    return cfg


def _model(cfg):
    model = CXRClip(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _inputs():
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (2, 8)))
    mask = torch.ones(2, 8, dtype=torch.int64)
    mask[1, 5:] = 0
    return images, ids, mask


def _loss_and_grads(cfg):
    """tests/test_remat.py's objective: Σ (img · txtᵀ)² of the normalized
    features, eval mode; with a MoE tower its aux losses added."""
    model = _model(cfg).eval()
    images, ids, mask = _inputs()
    with routing() as aux:
        img = model.encode_image(images, normalize=True)
        txt = model.encode_text(ids, mask, normalize=True)
    loss = ((img @ txt.T) ** 2).sum() + sum(aux, torch.zeros(()))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0]), (float(got[0]), float(want[0]))
    assert got[1].keys() == want[1].keys()
    for name, g in want[1].items():
        assert torch.equal(got[1][name], g), name


def test_policies_are_the_jax_packages():
    assert REMAT_POLICIES == JREMAT_POLICIES
    with pytest.raises(ValueError, match="unknown remat policy"):
        resolve_remat_policy("everything")
    for name in REMAT_POLICIES:
        resolve_remat_policy(name)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("tower", list(TOWERS))
def test_policy_matches_no_remat_bit_for_bit(policy, tower):
    """The loss and every gradient, bit for bit (tests/test_remat.py holds
    the JAX package at 1e-5)."""
    _assert_equal(_loss_and_grads(_config(tower, policy)), _loss_and_grads(_config(tower)))


# -- a train step at dropout 0.1 ----------------------------------------------------------


def _step(cfg, seed=5):
    """One pretrain step at the config's dropout from the generator seeded
    ``seed``: (loss, parameters and buffers after, the generator's state)."""
    model = _model(cfg)
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
    step = make_clip_pretrain_step(model, opt, label_fn, temperature=2.0, image_size=16,
                                   mean=CLIP_MEAN, std=CLIP_STD, compute_dtype=torch.float32,
                                   max_grad_norm=1.0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["input_ids"] = batch["input_ids"][:, :8]
    batch["attention_mask"] = batch["attention_mask"][:, :8]
    gen = torch.Generator().manual_seed(seed)
    _, metrics = step(TrainState(model, opt), batch, LRS, gen)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return float(metrics["loss"]), state, gen.get_state()


def _assert_steps_equal(got, want):
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("tower", list(TOWERS))
def test_train_step_with_dropout_matches_no_remat(policy, tower):
    """Dropout 0.1 (BERT's masks and the projections' from the step's
    generator), BatchNorm in train mode: the loss, every parameter and
    running statistic after the step and the generator's state, bit for
    bit."""
    want = _step(_config(tower, dropout=0.1))
    init = _model(_config(tower)).state_dict()
    stats = [k for k in want[1] if k.endswith("running_mean")]
    assert all(not torch.equal(want[1][k], init[k]) for k in stats)
    _assert_steps_equal(_step(_config(tower, policy, dropout=0.1)), want)


def test_a_recompute_with_fresh_dropout_masks_is_found():
    """Planted fault: the recompute draws from where the generator stands
    in the backward (what ``torch.utils.checkpoint`` alone would do with an
    explicit generator): the step's gradients, and so its parameters, are
    another forward's."""
    want = _step(_config("resnet50", dropout=0.1))

    def fresh_masks(fn, args, generator, start):
        remat._RECOMPUTING.set(True)
        return fn(*args)

    with mock.patch.object(remat, "_recompute", fresh_masks):
        got = _step(_config("resnet50", "full", dropout=0.1))
    assert got[0] == want[0]  # the forward is the same
    assert any(not torch.equal(got[1][k], v) for k, v in want[1].items()
               if k.startswith("text_tower.encoder"))


def test_a_recompute_that_updates_the_running_statistics_is_found():
    """Planted fault: BatchNorm updates its running statistics again in
    the recompute (flax updates them once): the statistics after the step
    differ, the loss does not."""
    want = _step(_config("resnet50"))
    with mock.patch.object(resnet, "recomputing", lambda: False):
        got = _step(_config("resnet50", "full"))
    assert got[0] == want[0]
    stats = [k for k in want[1] if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(got[1][k], want[1][k]) for k in stats
                         if k.startswith("image_tower.layer"))


# -- what each policy saves -------------------------------------------------------------


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket.__name__
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


PRODUCTS = ("convolution", "addmm", "mm", "bmm")


def _backward_products(cfg):
    """The products the backward runs ([convolution, addmm, mm, bmm]
    counts): the gradients' own, and those a recompute runs again."""
    model = _model(cfg).train()
    images, ids, mask = _inputs()
    with batch_norm_context(), routing():
        img, txt = model(images, ids, mask)
    loss = ((img @ txt.T) ** 2).sum()
    with _Count() as mode:
        loss.backward()
    return {k: mode.counts.get(k, 0) for k in PRODUCTS}


@pytest.mark.parametrize("tower", ["resnet50", "vit_b16"])
def test_each_policy_saves_the_products_jax_saves(tower):
    """``dots`` saves the products and convolutions (JAX's
    ``dots_saveable``): its backward runs the products no remat runs;
    ``dots_no_batch`` saves the products without a batch dimension
    (``mm``, ``addmm``) and recomputes the attention's ``bmm`` and the
    convolutions; ``full`` recomputes all four."""
    plain = _backward_products(_config(tower))
    extra = {p: {k: v - plain[k] for k, v in _backward_products(_config(tower, p)).items()}
             for p in POLICIES}
    assert extra["dots"] == dict.fromkeys(PRODUCTS, 0)
    assert extra["dots_no_batch"]["addmm"] == extra["dots_no_batch"]["mm"] == 0
    assert extra["dots_no_batch"]["bmm"] > 0
    if tower == "resnet50":
        assert extra["dots_no_batch"]["convolution"] > 0
    assert all(extra["full"][k] > 0 for k in ("addmm", "bmm"))
    assert (extra["full"]["convolution"] > 0) == (tower == "resnet50")


# -- against JAX's --remat step ---------------------------------------------------------


TRAIN_CFG = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=32,
    text_layers=2, text_heads=2, text_intermediate_dim=64, shared_embedding_dim=32,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8, dropout=0.0,
)


@functools.lru_cache(maxsize=None)
def _jax_remat_step(policy):
    """JAX's unclipped loss gradient of the phase-A objective with
    ``remat``, ``remat_conv`` and ``policy``, and the variables."""
    cfg = dict(TRAIN_CFG, remat=True, remat_conv=True, remat_policy=policy)
    jmodel = JCXRClip(JModelConfig(**cfg))
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
    return variables, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_matches_jaxs_remat_step(policy):
    """The port's ``--remat`` step from JAX's variables: its loss within
    5e-5 relative of JAX's, every clipped gradient within 1e-4 of the
    tensor's largest (tests/test_torch_train.py's bounds)."""
    variables, jloss, jgrads = _jax_remat_step(policy)
    cfg = ModelConfig(**TRAIN_CFG, remat=True, remat_conv=True, remat_policy=policy)
    model = CXRClip(cfg)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY)
    step = make_clip_pretrain_step(model, opt, label_fn, temperature=2.0, image_size=32,
                                   mean=CLIP_MEAN, std=CLIP_STD, compute_dtype=torch.float32,
                                   max_grad_norm=PRESET.train.max_grad_norm)
    _, metrics = step(TrainState(model, opt), {k: torch.from_numpy(v) for k, v in
                                               _batch().items()}, LRS)
    assert float(metrics["loss"]) == pytest.approx(jloss, rel=5e-5)
    scale = 1.0 / max(float(optax.global_norm(jgrads)), 1.0)
    want = state_dict_from_jax(jax.tree.map(lambda g: np.asarray(g) * scale, jgrads),
                               variables["batch_stats"])
    for name, p in model.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(),
                                   atol=1e-4 * float(w.abs().max()) + 1e-9, rtol=0,
                                   err_msg=name)
