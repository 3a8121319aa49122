"""Parity of the rest of the pretrain options (ROADMAP A3b) with the JAX
package, on the CPU in fp32: the info_nce and siglip losses, the learnable
temperature (``logit_scale`` / ``logit_bias``, the clamp at log 100), the EMA
of the parameters (``TrainState.create(ema=True)``, ``ema_decay``, the eval
step's ``use_ema``) and the bf16 first moment (``make_optimizer
(moment_dtype=torch.bfloat16)``).

The model is test_torch_train.py's tiny CXRClip with one BERT layer
(flash attention on, dropout 0) with weights from a seed, carried across by
``state_dict_from_jax``, at a batch of 8 (at 4, BatchNorm over four samples
in the last ResNet stage puts fp32 noise of up to 1.6e-4 into the
gradients of the sharper losses). Each case runs three steps of
``make_clip_pretrain_step`` on both sides with the preset's group rates,
weight decay and clip. Tolerances are stated per test.
"""

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
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform
from clip_for_dl_tpu.train import make_clip_eval_step as jmake_eval_step
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_step
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, ModelConfig, get_preset
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.train import (
    TrainState,
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
    text_layers=1, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    dropout=0.0, flash_attention=True,
)
PRESET = get_preset("pretrain_clip")
GROUPS = [g.name for g in PRESET.train.groups]
LRS = {**{g.name: g.lr for g in PRESET.train.groups}, "default": PRESET.train.lr}
WEIGHT_DECAY = PRESET.train.weight_decay
STEPS = 3
A3B_BATCH = 8


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


def _batch(seed=2, b=A3B_BATCH):
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


def _port_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


# case -> (loss, learnable temperature, EMA decay, bf16 first moment). The
# learnable info_nce case starts at s = 200, above the cap of 100, so that
# it also holds the clamp; siglip starts at the CLI's s = 10
A3B = {
    "info_nce": ("info_nce", False, 0.0, False),
    "siglip": ("siglip", False, 0.0, False),
    "learnable_info_nce": ("info_nce", True, 0.0, False),
    "learnable_siglip": ("siglip", True, 0.0, False),
    "ema": ("clip_self_distill", False, 0.9, False),
    "bf16_moments": ("clip_self_distill", False, 0.0, True),
    "all": ("siglip", True, 0.9, True),
}


def _a3b_config(case):
    loss, learnable, _, _ = A3B[case]
    scale_init = None if not learnable else 10.0 if loss == "siglip" else 200.0
    return dict(TINY, learnable_temperature=learnable, logit_scale_init=scale_init)


def _mu_tree(opt_state):
    """optax's first moments in a (nested) chain state."""
    for s in opt_state:
        if hasattr(s, "mu"):
            return s.mu
        if isinstance(s, tuple) and (found := _mu_tree(s)) is not None:
            return found
    return None


def _recording(tx):
    """``tx`` whose state also keeps the gradient of the last step as the
    step's ``value_and_grad`` gave it (before the clip): the first step's
    gradient without a second compiled function."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def _jax_a3b(case):
    """STEPS JAX steps of ``case``: the first step's unclipped gradient
    (kept by ``_recording``), the losses, and after every step the parameters, the EMA and the first
    moments; the EMA eval loss after the last. The projections' final
    LayerNorm is scaled by 0.1, so that the raw features (norm ~0.8) give
    the softmax losses a loss of a few units, as A3's tests have, at any
    learned scale."""
    loss_name, learnable, ema, bf16 = A3B[case]
    cfg = JModelConfig(**_a3b_config(case))
    jmodel = JCXRClip(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(1)
    params = _fill(shapes["params"], rng)
    for head in ("image_projector", "text_projector"):
        params[head]["layer_norm"] = {k: v * np.float32(0.1)
                                      for k, v in params[head]["layer_norm"].items()}
    if learnable:  # the init values CXRClip.setup gives them
        params["logit_scale"] = np.float32(np.log(cfg.logit_scale_init))
        params["logit_bias"] = np.float32(cfg.logit_bias_init)
    variables = {"params": params, "batch_stats": _fill(shapes["batch_stats"], rng)}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    tx = _recording(base_transform(PRESET.train.max_grad_norm, WEIGHT_DECAY,
                                   moment_dtype=jnp.bfloat16 if bf16 else None))
    kw = dict(temperature=2.0, image_size=32, mean=CLIP_MEAN, std=CLIP_STD,
              compute_dtype=jnp.float32)
    step = jax.jit(jmake_step(jmodel, tx, joptim.make_label_fn(GROUPS), loss_name,
                              ema_decay=ema, **kw))
    state = JTrainState.create(variables, tx, ema=bool(ema))
    losses, states = [], []
    for i in range(STEPS):
        state, metrics = step(state, batch, LRS, jax.random.key(i))
        losses.append(float(metrics["loss"]))
        states.append(jax.device_get(state))
    eval_loss = None
    if ema:
        eval_step = jax.jit(jmake_eval_step(jmodel, loss_name, use_ema=True, **kw))
        eval_loss = float(eval_step(state, batch)["loss"])
    return dict(variables=variables, loss=losses[0], grads=states[0].opt_state[0],
                losses=losses, states=states, eval_loss=eval_loss)


@functools.lru_cache(maxsize=None)
def _port_a3b(case):
    """The same STEPS steps in the port, recording what _jax_a3b records."""
    loss_name, _, ema, bf16 = A3B[case]
    jr = _jax_a3b(case)
    model = CXRClip(ModelConfig(**_a3b_config(case)))
    model.load_state_dict(state_dict_from_jax(jr["variables"]["params"],
                                              jr["variables"]["batch_stats"]), strict=True)
    label_fn = make_label_fn(GROUPS)
    opt = make_optimizer(model, label_fn, weight_decay=WEIGHT_DECAY,
                         moment_dtype=torch.bfloat16 if bf16 else None)
    kw = dict(temperature=2.0, image_size=32, mean=CLIP_MEAN, std=CLIP_STD,
              compute_dtype=torch.float32)
    step = make_clip_pretrain_step(model, opt, label_fn, loss_name,
                                   max_grad_norm=PRESET.train.max_grad_norm, ema_decay=ema,
                                   **kw)
    state, batch = TrainState.create(model, opt, ema=bool(ema)), _port_batch()
    named = dict(model.named_parameters())
    losses, grads, params, emas, mus = [], None, [], [], []
    for i in range(STEPS):
        state, metrics = step(state, batch, LRS)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in named.items()}
        params.append({n: p.detach().clone() for n, p in named.items()})
        if ema:
            emas.append({n: e.clone() for n, e in state.ema_params.items()})
        mus.append({n: opt.state[p]["exp_avg"].clone() for n, p in named.items()})
    eval_loss = None
    if ema:
        eval_loss = float(make_clip_eval_step(model, loss_name, use_ema=True, **kw)(
            state, batch)["loss"])
    return dict(losses=losses, grads=grads, params=params, emas=emas, mus=mus,
                eval_loss=eval_loss, state=state)


def _named(tree, stats):
    return state_dict_from_jax(tree, stats)


@pytest.mark.parametrize("case", list(A3B))
def test_a3b_step_losses_match_jax(case):
    """The first step's loss within 5e-5 (A3's tolerance); STEPS steps'
    losses within 5e-4, as the default loss's."""
    jr, pr = _jax_a3b(case), _port_a3b(case)
    np.testing.assert_allclose(pr["losses"][0], jr["loss"], atol=5e-5, rtol=0)
    np.testing.assert_allclose(pr["losses"], jr["losses"], atol=5e-4, rtol=0)


@pytest.mark.parametrize("case", list(A3B))
def test_a3b_step_gradients_match_jax(case):
    """Every clipped gradient, the calibration scalars' among them, within
    1e-4 of each tensor's largest entry (A3's tolerance)."""
    jr, pr = _jax_a3b(case), _port_a3b(case)
    norm = float(optax.global_norm(jr["grads"]))
    scale = 1.0 / max(norm, PRESET.train.max_grad_norm)
    want = _named(jax.tree.map(lambda g: np.asarray(g) * scale, jr["grads"]),
                  jr["variables"]["batch_stats"])
    got = pr["grads"]
    assert set(got) <= set(want)
    if A3B[case][1]:
        assert {"logit_scale", "logit_bias"} <= set(got)
        assert float(got["logit_bias"].abs()) > 0 or A3B[case][0] != "siglip"
    for name, g in got.items():
        w = want[name]
        tol = 1e-4 * float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", [c for c, o in A3B.items() if o[1]])
def test_calibration_scalars_after_the_steps_match_jax(case):
    """logit_scale and logit_bias after each of STEPS steps: 1e-6."""
    jr, pr = _jax_a3b(case), _port_a3b(case)
    for jstate, got in zip(jr["states"], pr["params"]):
        for name in ("logit_scale", "logit_bias"):
            np.testing.assert_allclose(float(got[name]), float(jstate.params[name]),
                                       atol=1e-6, rtol=0, err_msg=name)


def _agreeing(jr, pr, tol):
    """name -> the elements whose live parameters agree with JAX's within
    ``tol`` after every step. Adam's first update is g / (|g| + eps), so
    where |g| is near eps a gradient's last bits can flip a step's sign
    (test_pretrain_step_updated_parameters_match_jax); elsewhere the
    trajectories agree."""
    masks = None
    for jstate, got in zip(jr["states"], pr["params"]):
        want = _named(jstate.params, jstate.batch_stats)
        m = {n: (got[n] - want[n]).abs() <= tol for n in got}
        masks = m if masks is None else {n: masks[n] & m[n] for n in m}
    return masks


@pytest.mark.parametrize("case", [c for c, o in A3B.items() if o[2]])
def test_ema_matches_jax(case):
    """EMA after each of STEPS steps: equal to the decay rule
    d = min(D, (1 + t) / (10 + t)) applied to the port's own trajectory, and
    within 1e-6 of JAX's ``state.ema_params`` beyond the largest difference
    of the live parameters up to that step (the EMA is a convex combination
    of them, and Adam's first updates can differ by a step's sign where
    |g| is near eps: test_pretrain_step_updated_parameters_match_jax)."""
    jr, pr = _jax_a3b(case), _port_a3b(case)
    init = _named(jr["variables"]["params"], jr["variables"]["batch_stats"])
    prev = {n: init[n].clone() for n in pr["emas"][0]}
    live_err = {n: torch.zeros_like(p) for n, p in prev.items()}
    decay = A3B[case][2]
    for t, (jstate, got, live) in enumerate(zip(jr["states"], pr["emas"], pr["params"])):
        want = _named(jstate.ema_params, jstate.batch_stats)
        want_live = _named(jstate.params, jstate.batch_stats)
        d = np.minimum(np.float32(decay), (np.float32(1) + t) / (np.float32(10) + t))
        for n in got:
            live_err[n] = torch.maximum(live_err[n], (live[n] - want_live[n]).abs())
            assert bool(((got[n] - want[n]).abs() <= live_err[n] + 1e-6).all()), n
            rule = prev[n] * float(d) + live[n] * float(np.float32(1) - d)
            assert torch.equal(got[n], rule), n
        prev = got


def _bf16_step(x):
    """One bf16 step (spacing) at |x|, elementwise."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


@pytest.mark.parametrize("case", [c for c, o in A3B.items() if o[3]])
def test_bf16_first_moments_match_optax(case):
    """exp_avg in bf16 and exp_avg_sq in fp32; after the first step the
    first moments within one bf16 step of optax's (plus the gradients'
    tolerance, 1e-4 of the tensor's largest entry + 1e-9); after each of
    STEPS steps the live parameters within 1e-5 of JAX's on at least 99.9%
    of the elements (the rest: Adam's ill-conditioned first updates, see
    _agreeing). Later moments follow gradients of parameters that differ
    there, so the optimizer alone is held on given gradients below."""
    jr, pr = _jax_a3b(case), _port_a3b(case)
    opt = pr["state"].optimizer
    for p in pr["state"].model.parameters():
        assert opt.state[p]["exp_avg"].dtype == torch.bfloat16
        assert opt.state[p]["exp_avg_sq"].dtype == torch.float32
    jstate, got = jr["states"][0], pr["mus"][0]
    want = _named(jax.tree.map(lambda x: np.asarray(x, np.float32),
                               _mu_tree(jstate.opt_state)), jstate.batch_stats)
    for n, g in got.items():
        w, g = want[n], g.float()
        tol = _bf16_step(torch.maximum(w.abs(), g.abs())) + 1e-4 * float(w.abs().max()) + 1e-9
        assert bool(((g - w).abs() <= tol).all()), n
    masks = _agreeing(jr, pr, 1e-5)
    total = sum(m.numel() for m in masks.values())
    assert sum(int(m.sum()) for m in masks.values()) >= 0.999 * total


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_bf16_first_moment_update_matches_optax_on_given_gradients(weight_decay):
    """The optimizer alone: five steps of optax's
    clip-free ``base_transform(moment_dtype=bf16)`` and the per-group rate,
    and of ``AdamWBf16FirstMoment``, on the same seeded gradients. The first
    moments within one bf16 step (rounding flips of fp32 sums in another
    order; JAX's b1 rounded to bf16 is reproduced, else ~40% of them would
    differ), the second within 1e-6 relative, the parameters (|p| < 2)
    within 1e-6: AdamW decays as p·(1 − lr·wd) and takes the bias
    corrections in double, optax adds wd·p to the update and rounds them in
    fp32 (measured 4.8e-7, four fp32 steps at |p| ≈ 1.3)."""
    rng = np.random.default_rng(11)
    shapes = {"w": (6, 5), "b": (5,), "s": ()}
    params = {k: np.asarray(rng.standard_normal(v), np.float32) for k, v in shapes.items()}
    grads = [{k: np.asarray(rng.standard_normal(v) * 10.0 ** rng.integers(-4, 1), np.float32)
              for k, v in shapes.items()} for _ in range(5)]
    lr = 1e-2
    tx = base_transform(None, weight_decay, moment_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = tx.init(jp)
    model = torch.nn.Module()
    for k, v in params.items():
        setattr(model, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = make_optimizer(model, make_label_fn([]), weight_decay=weight_decay,
                         moment_dtype=torch.bfloat16)
    port_optim.set_group_lrs(opt, {"default": lr})
    for g in grads:
        updates, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -lr * u, updates))
        for k, v in g.items():
            getattr(model, k).grad = torch.from_numpy(v.copy())
        opt.step()
    adam = _mu_tree(jopt)
    nu = next(s for s in jopt if hasattr(s, "nu")).nu
    for k in shapes:
        p = getattr(model, k)
        mu = opt.state[p]["exp_avg"]
        assert mu.dtype == torch.bfloat16
        want = torch.from_numpy(np.asarray(adam[k], np.float32))
        assert bool(((mu.float() - want).abs() <= _bf16_step(want)).all()), k
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), np.asarray(nu[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_bf16_first_moment_takes_half_the_bytes():
    model = CXRClip(ModelConfig(**TINY))
    sizes = {}
    for dtype in (None, torch.bfloat16):
        opt = make_optimizer(model, make_label_fn(GROUPS), moment_dtype=dtype)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        sizes[dtype] = [sum(opt.state[p][k].nbytes for p in model.parameters())
                        for k in ("exp_avg", "exp_avg_sq")]
    assert sizes[torch.bfloat16][0] * 2 == sizes[None][0]
    assert sizes[torch.bfloat16][1] == sizes[None][1]


def test_logit_scale_is_clamped_at_log_100_as_in_jax():
    """The learnable info_nce case starts at s = 200: the loss runs at
    s = 100 (its min, no gradient to the scale), the step clamps the
    parameter to log 100, and from there the tie's gradient moves it, in
    both packages alike (the scalars within 1e-6 of JAX's)."""
    jr, pr = _jax_a3b("learnable_info_nce"), _port_a3b("learnable_info_nce")
    cap = np.float32(np.log(100.0))
    assert float(pr["grads"]["logit_scale"]) == 0.0
    assert float(pr["params"][0]["logit_scale"]) == cap
    for jstate, got in zip(jr["states"], pr["params"]):
        assert float(got["logit_scale"]) <= cap
        assert float(jstate.params["logit_scale"]) <= cap
    assert float(pr["params"][-1]["logit_scale"]) < cap  # it trains from the boundary


@pytest.mark.parametrize("case", [c for c, o in A3B.items() if o[2]])
def test_eval_step_with_ema_matches_jax(case):
    """``make_clip_eval_step(use_ema=True)`` scores the EMA parameters with
    the live BatchNorm statistics, as JAX's ``to_variables(use_ema)``:
    5e-4, the tolerance of the losses after STEPS steps."""
    jr, pr = _jax_a3b(case), _port_a3b(case)
    np.testing.assert_allclose(pr["eval_loss"], jr["eval_loss"], atol=5e-4, rtol=0)
    model = pr["state"].model
    live = float(make_clip_eval_step(model, A3B[case][0], temperature=2.0, image_size=32,
                                     mean=CLIP_MEAN, std=CLIP_STD,
                                     compute_dtype=torch.float32)(pr["state"], _port_batch())
                 ["loss"])
    assert live != pr["eval_loss"]


def test_eval_step_with_ema_on_a_state_without_one_raises():
    model = CXRClip(ModelConfig(**TINY))
    state = TrainState.create(model, make_optimizer(model, make_label_fn(GROUPS)))
    step = make_clip_eval_step(model, image_size=32, compute_dtype=torch.float32, use_ema=True)
    with pytest.raises(ValueError, match="no EMA params"):
        step(state, _port_batch())
