"""GradCache accumulation in the port (clip_for_dl_tpu_torch/train/accum.py)
against the JAX package's ``make_accum_clip_pretrain_step`` and the plain
steps, on the CPU in fp32.

The ViT cases use JAX's own strict geometry (tests/test_accum.py: ViT tower,
LayerNorm only, so the microbatched forward is the full-batch forward) and
SGD at learning rate 1 without a clip: a parameter's change is its
gradient. The ResNet cases hold the BatchNorm semantics: statistics of each
microbatch (of the global microbatch, over two gloo ranks), running
statistics moved once per microbatch in order, and a pass 3 that replays
pass 1 (the same dropout, no second move of the running statistics).
Tolerances are stated per test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.core.mesh import create_mesh
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.parallel import data_parallel_step as jdata_parallel_step
from clip_for_dl_tpu.parallel import replicate_state as jreplicate_state
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import make_accum_clip_pretrain_step as jmake_accum_step
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_step
from clip_for_dl_tpu.train.optim import make_label_fn as jmake_label_fn
from clip_for_dl_tpu_torch.models import state_dict_from_jax
from clip_for_dl_tpu_torch.testing import ranks
from clip_for_dl_tpu_torch.train import (
    TrainState,
    make_accum_clip_pretrain_step,
    make_clip_pretrain_step,
    make_label_fn,
)

torch.set_num_threads(1)

# tests/test_accum.py's geometry
TINY_VIT = dataclasses.replace(JModelConfig(
    image_size=16, max_text_length=8, vocab_size=64, text_embedding_dim=16,
    text_layers=1, text_heads=2, text_intermediate_dim=32,
    shared_embedding_dim=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    vit_patch=8, vit_layers=1, vit_heads=2, vit_hidden=16, vit_mlp_dim=32,
    dropout=0.0,
).with_vit(), image_embedding_dim=16)
TINY_RESNET = JModelConfig(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=64,
    text_layers=2, text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8, dropout=0.0,
)
PREP = dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
LRS = {"default": 1.0}
B = 8


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "var"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        v = rng.uniform(-0.5, 0.5, shape)
    else:
        v = rng.standard_normal(shape) * 0.1
    return np.asarray(v, np.float32)


@functools.lru_cache(maxsize=None)
def _variables(which):
    cfg = TINY_VIT if which == "vit" else TINY_RESNET
    jmodel = JCXRClip(cfg, dtype=jnp.float32)
    side = cfg.image_size
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, side, side, 3)),
                            jnp.zeros((1, cfg.max_text_length), jnp.int32))
    rng = np.random.default_rng(11)
    out = {"params": _fill(shapes["params"], rng)}
    if "batch_stats" in shapes:
        out["batch_stats"] = _fill(shapes["batch_stats"], rng)
    return out


def _batch(which, seed=0):
    """8 pairs for the ViT (tests/test_accum.py's), 16 for the ResNet, whose
    BatchNorm then normalizes 8 rows a microbatch (4 a rank)."""
    cfg = TINY_VIT if which == "vit" else TINY_RESNET
    rng = np.random.default_rng(seed)
    b = B if which == "vit" else 2 * B
    side, n = cfg.image_size, cfg.max_text_length
    mask = np.ones((b, n), np.int32)
    mask[1, n // 2:] = 0
    return {"images": rng.integers(0, 255, (b, side, side, 3), np.uint8),
            "input_ids": rng.integers(1, 64, (b, n)).astype(np.int32),
            "attention_mask": mask}


def _case(which, loss, accum, **extra):
    cfg = TINY_VIT if which == "vit" else TINY_RESNET
    return dict(kind="pretrain", config=dataclasses.asdict(cfg), variables=_variables(which),
                batch=_batch(which), loss=loss, accum=accum, temperature=2.0, clip=None,
                groups=[], lrs=LRS, image_size=cfg.image_size, **PREP, **extra)


@functools.lru_cache(maxsize=None)
def _jax(which, loss, accum, n=1):
    """The JAX accumulating step (``accum`` > 1) or the plain one, on one
    device or jitted over an n-device mesh: (loss, parameter change in the
    port's names, running statistics after)."""
    cfg = TINY_VIT if which == "vit" else TINY_RESNET
    jmodel = JCXRClip(cfg, dtype=jnp.float32)
    tx = optax.identity()  # the step's group learning rate applies −lr
    kw = dict(loss_name=loss, temperature=2.0, image_size=cfg.image_size,
              compute_dtype=jnp.float32, **PREP)
    raw = (jmake_accum_step(jmodel, tx, jmake_label_fn([]), accum, **kw) if accum > 1
           else jmake_step(jmodel, tx, jmake_label_fn([]), **kw))
    variables = _variables(which)
    state = JTrainState.create(variables, tx)
    batch = {k: jnp.asarray(v) for k, v in _batch(which).items()}
    if n > 1:
        mesh = create_mesh(n)
        state = jreplicate_state(state, mesh)
        step = jdata_parallel_step(raw, mesh, donate_state=False)
    else:
        step = jax.jit(raw)
    state, metrics = step(state, batch, LRS, jax.random.key(7))
    after = jax.device_get(state)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - b, after.params, variables["params"])
    stats = after.batch_stats if "batch_stats" in variables else {}
    return (float(metrics["loss"]), state_dict_from_jax(delta, stats),
            state_dict_from_jax(after.params, stats))


def _close(got, want, atol, what=""):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=atol, rtol=0, err_msg=f"{what} {k}")


VIT_CASES = [("clip_self_distill", 2), ("clip_self_distill", 4), ("info_nce", 2),
             ("info_nce", 4)]


@pytest.mark.parametrize("loss,accum", VIT_CASES)
def test_accum_step_matches_jax_accum_step(loss, accum):
    """The ViT step in ``accum`` microbatches against JAX's: the loss at
    1e-6 relative, each parameter's change (its gradient) at 5e-6 (JAX's
    own bound between its accumulating and its plain step)."""
    want_loss, want_delta, _ = _jax("vit", loss, accum)
    losses, _, delta = ranks.step_case(_case("vit", loss, accum))
    assert losses[0] == pytest.approx(want_loss, rel=1e-6)
    _close(delta, {k: want_delta[k] for k in delta}, 5e-6)


@pytest.mark.parametrize("loss,accum", VIT_CASES)
def test_accum_step_equals_the_full_batch_step(loss, accum):
    """The port's accumulating ViT step against its plain step on the full
    batch, and JAX's plain step: the loss at 1e-6 relative, the change at
    5e-6 (the gradient is the full batch's: negatives are not cut to the
    microbatch)."""
    plain_losses, _, plain = ranks.step_case(_case("vit", loss, 1))
    losses, _, delta = ranks.step_case(_case("vit", loss, accum))
    assert losses[0] == pytest.approx(plain_losses[0], rel=1e-6)
    _close(delta, plain, 5e-6)
    want_loss, want_delta, _ = _jax("vit", loss, 1)
    assert losses[0] == pytest.approx(want_loss, rel=1e-6)
    _close(delta, {k: want_delta[k] for k in delta}, 5e-6)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The accumulating step on two gloo ranks: the ViT (against the full
    batch in one process) and the ResNet (against JAX's accumulating step
    over a 2-device mesh)."""
    work = tmp_path_factory.mktemp("accum2")
    cases = {"vit": _case("vit", "clip_self_distill", 2),
             "resnet": _case("resnet", "clip_self_distill", 2)}
    return ranks.launch(cases, 2, str(work))


def test_accum_over_two_ranks_equals_the_full_batch_step(two_ranks):
    """Two ranks, each its share of both global microbatches of the ViT
    step: the loss at 1e-6 relative and the change at 5e-6 of the plain
    step on the full batch in one process."""
    plain_losses, _, plain = ranks.step_case(_case("vit", "clip_self_distill", 1))
    got = two_ranks[0]["vit"]
    assert got["losses"][0] == pytest.approx(plain_losses[0], rel=1e-6)
    _close(got["delta"], plain, 5e-6)


def test_resnet_accum_over_two_ranks_matches_jax_over_two_devices(two_ranks):
    """The ResNet step in 2 microbatches on two ranks against JAX's
    accumulating step over a 2-device mesh (16 pairs): each microbatch
    normalized with the global microbatch's statistics and the running
    statistics moved once per microbatch, in order. The loss at 5e-5, each
    change at 1e-4 of its tensor's largest (tests/test_torch_train.py's
    bounds), the running statistics at 1e-5."""
    want_loss, want_delta, want_state = _jax("resnet", "clip_self_distill", 2, n=2)
    got = two_ranks[0]["resnet"]
    assert got["losses"][0] == pytest.approx(want_loss, abs=5e-5)
    for k in got["delta"]:
        w = np.asarray(want_delta[k])
        np.testing.assert_allclose(got["delta"][k], w, atol=1e-4 * float(np.abs(w).max())
                                   + 2.5e-7, rtol=0, err_msg=k)
    for k, w in want_state.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k], w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)


def test_the_replay_draws_pass_one_dropout_and_moves_the_statistics_once():
    """With dropout 0.1 (BERT, the heads, the attention kernel's seed) and a
    ResNet: one microbatch of the accumulating step is the plain step, if
    pass 3 replays pass 1's generator states and does not move the running
    statistics again. Each change at 5e-6, the loss at 1e-6 relative, every
    running statistic at 1e-6; the generator ends where the plain step
    leaves it."""
    case = _case("resnet", "clip_self_distill", 1)
    case["config"] = dict(case["config"], dropout=0.1, flash_attention=True)
    out = {}
    for accum in (None, 1):
        model = ranks.model_from(case)
        opt = ranks.sgd(model, make_label_fn([]))
        kw = dict(image_size=32, compute_dtype=torch.float32, max_grad_norm=None, **PREP)
        step = (make_clip_pretrain_step(model, opt, make_label_fn([]), "clip_self_distill", 2.0,
                                        **kw) if accum is None else
                make_accum_clip_pretrain_step(model, opt, make_label_fn([]), accum,
                                              "clip_self_distill", 2.0, **kw))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        gen = torch.Generator().manual_seed(3)
        torch.manual_seed(5)
        _, metrics = step(TrainState(model, opt), ranks.tensors(case["batch"]), LRS, gen)
        out[accum] = (float(metrics["loss"]), ranks.host_state(model),
                      {n: (p.detach() - before[n]).numpy() for n, p in model.named_parameters()},
                      gen.get_state())
    (l0, s0, d0, g0), (l1, s1, d1, g1) = out[None], out[1]
    assert l1 == pytest.approx(l0, rel=1e-6)
    _close(d1, d0, 5e-6)
    _close({k: v for k, v in s1.items() if "running" in k},
           {k: v for k, v in s0.items() if "running" in k}, 1e-6)
    assert torch.equal(g0, g1)


def test_accum_refuses_what_the_jax_step_refuses():
    """A batch that does not split, a count below 1 and the MoE text tower:
    ValueError with the JAX step's messages."""
    case = _case("vit", "clip_self_distill", 3)
    model = ranks.model_from(case)
    opt = ranks.sgd(model, make_label_fn([]))
    step = make_accum_clip_pretrain_step(model, opt, make_label_fn([]), 3, image_size=16,
                                         compute_dtype=torch.float32)
    with pytest.raises(ValueError, match=r"batch size 8 must divide into accum_steps=3"):
        step(TrainState(model, opt), ranks.tensors(case["batch"]), LRS)
    with pytest.raises(ValueError, match="accum_steps must be >= 1, got 0"):
        make_accum_clip_pretrain_step(model, opt, make_label_fn([]), 0)
    model.config = dataclasses.replace(model.config, text_moe_experts=4)
    with pytest.raises(ValueError, match="does not compose with the MoE text tower"):
        make_accum_clip_pretrain_step(model, opt, make_label_fn([]), 2)
