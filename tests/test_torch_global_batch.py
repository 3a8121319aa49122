"""The port's global-batch losses (clip_for_dl_tpu_torch/losses/global_batch.py)
and BatchNorm under a process group (models/resnet.py ``_bn``) against the
JAX package's, on the CPU in fp32.

N = 2 and 4 gloo ranks (``clip_for_dl_tpu_torch.testing.ranks``) hold their
rows of 8 feature pairs [8, 16] (and 16-class multi-hot labels; the prompt
bank [16, 16] is the same on every rank); the JAX side runs the same loss
inside ``shard_map`` over a 2- and a 4-device slice of conftest's 8-device
CPU mesh, and ``jax.grad`` of it gives the gradient of the global loss. A
rank's gradient of its rows is N times theirs (every rank computes the same
global loss), as is the ring's share of the scale's and bias's gradient: the
ranks' results divided by N (``ranks._losses_case``) and the scale's and
bias's averaged over the ranks are held against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from clip_for_dl_tpu.core.mesh import create_mesh
from clip_for_dl_tpu.losses import clip_self_distill_loss as jclip_self_distill_loss
from clip_for_dl_tpu.losses import global_batch as jgb
from clip_for_dl_tpu_torch.models.resnet import _bn
from clip_for_dl_tpu_torch.testing import ranks

torch.set_num_threads(1)

B, D, C = 8, 16, 16
SCALE, BIAS = 7.0, -4.0


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    labels[np.arange(B), np.arange(B)] = 1.0
    bank = rng.standard_normal((C, D)).astype(np.float32)
    return dict(txt=(rng.standard_normal((B, D)) * 0.5).astype(np.float32),
                img=(rng.standard_normal((B, D)) * 0.5).astype(np.float32),
                labels=labels, bank=bank / np.linalg.norm(bank, axis=1, keepdims=True),
                scale=SCALE, bias=BIAS)


def _raw_inputs(seed=0):
    """_inputs with features of norm 22 clustered round one direction a
    tower (a random-init model's raw features for similar images): the
    self-distill targets softmax(S·T), S·T ~ 1e3, then spread over many
    columns, where one fp32 rounding of a row's log-normalizer costs ~6e-5."""
    rng = np.random.default_rng(seed)
    x = _inputs(seed)
    for key in ("txt", "img"):
        centre = rng.standard_normal(D)
        f = centre + 0.05 * rng.standard_normal((B, D))
        x[key] = (f * 22.0 / np.linalg.norm(centre)).astype(np.float32)
    return x


def _bn_inputs(seed=1):
    rng = np.random.default_rng(seed)
    return dict(x=(rng.standard_normal((B, 3, 4, 4)) * 2.0 + 1.0).astype(np.float32),
                c=rng.standard_normal((B, 3, 4, 4)).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, 3).astype(np.float32),
                bias=rng.standard_normal(3).astype(np.float32),
                running_mean=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
                running_var=rng.uniform(0.5, 1.5, 3).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _ranks(tmp_root, n):
    cases = {"losses": dict(kind="losses", **_inputs()), "bn": dict(kind="bn", **_bn_inputs()),
             "raw": dict(kind="losses", **_raw_inputs())}
    return ranks.launch(cases, n, f"{tmp_root}/gb{n}")


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("global_batch"))


# the JAX forms, each (txt, img, labels, bank, scale, bias) → loss inside shard_map
JAX_LOSSES = {
    "global_clip_self_distill": lambda t, i, lbl, bank, s, b: (
        jgb.global_clip_self_distill_loss(t, i, 2.0)),
    "global_info_nce": lambda t, i, lbl, bank, s, b: jgb.global_info_nce_loss(i, t, 0.5),
    "global_multilabel": lambda t, i, lbl, bank, s, b: (
        jgb.global_multilabel_contrastive_loss(i, bank, lbl, 0.07)),
    "global_siglip": lambda t, i, lbl, bank, s, b: jgb.global_siglip_loss(t, i, s, b),
    "ring_siglip": lambda t, i, lbl, bank, s, b: jgb.ring_siglip_loss(t, i, s, b),
    "local_info_nce": lambda t, i, lbl, bank, s, b: jgb.local_info_nce_loss(i, t, 0.5),
    "local_clip_self_distill": lambda t, i, lbl, bank, s, b: (
        jgb.local_clip_self_distill_loss(t, i, 2.0)),
    "make_global": lambda t, i, lbl, bank, s, b: jgb.make_global(jclip_self_distill_loss)(
        t, i, 2.0),
}


@functools.lru_cache(maxsize=None)
def _jax(name, n):
    """(loss, d/dtxt, d/dimg, d/dscale, d/dbias) of the global loss over an
    n-device mesh."""
    x = _inputs()
    fn = shard_map(JAX_LOSSES[name], mesh=create_mesh(n),
                   in_specs=(P("data"), P("data"), P("data"), P(), P(), P()), out_specs=P(),
                   check_rep=False)
    args = [jnp.asarray(x[k]) for k in ("txt", "img", "labels", "bank")]
    s, b = jnp.float32(SCALE), jnp.float32(BIAS)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda t, i, s, b: fn(t, i, args[2], args[3], s, b), argnums=(0, 1, 2, 3)))(
        args[0], args[1], s, b)
    return (float(loss),) + tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("n", [2, 4])
def test_local_self_distill_keeps_fp32_precision_on_raw_features(n, tmp_root):
    """On raw features of norm 22 (_raw_inputs) the local self-distill form
    equals the all-gather form, the same sums in fp32: the loss at 1e-6
    relative, every row's gradient at 2e-5 of the largest entry. The
    targets through one rounded log-normalizer per row, exp(S − Z), miss
    both (2e-6 and 3.8e-4 here)."""
    out = _ranks(tmp_root, n)
    for r in out:
        local, full = r["raw"]["local_clip_self_distill"], r["raw"]["global_clip_self_distill"]
        assert local["loss"] == pytest.approx(full["loss"], rel=1e-6)
    for key in ("dtxt", "dimg"):
        got = np.concatenate([r["raw"]["local_clip_self_distill"][key] for r in out])
        want = np.concatenate([r["raw"]["global_clip_self_distill"][key] for r in out])
        np.testing.assert_allclose(got, want, atol=2e-5 * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(JAX_LOSSES))
def test_global_batch_loss_and_gradients_match_jax(name, n, tmp_root):
    """The loss on every rank (1e-5 relative), the gradient of every row
    (1e-5 of the largest entry), the scale's and bias's gradient where the
    loss takes them (1e-5 relative)."""
    out = [r["losses"][name] for r in _ranks(tmp_root, n)]
    loss, dtxt, dimg, dscale, dbias = _jax(name, n)
    for r in out:
        assert r["loss"] == pytest.approx(loss, rel=1e-5, abs=1e-7)
    for got, want in ((np.concatenate([r["dtxt"] for r in out]), dtxt),
                      (np.concatenate([r["dimg"] for r in out]), dimg)):
        np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0)
    if "siglip" in name:
        for key, want in (("dscale", dscale), ("dbias", dbias)):
            got = np.mean([r[key] for r in out])
            assert got == pytest.approx(float(want), rel=1e-5, abs=1e-8), key


@pytest.mark.parametrize("n", [2, 4])
def test_ring_equals_the_all_gather_form(n, tmp_root):
    """siglip's ring against its all-gather form on the same ranks: the
    loss at 1e-6 relative, every gradient at 1e-6 of its largest entry."""
    out = _ranks(tmp_root, n)
    for r in out:
        ring, full = r["losses"]["ring_siglip"], r["losses"]["global_siglip"]
        assert ring["loss"] == pytest.approx(full["loss"], rel=1e-6)
        for key in ("dtxt", "dimg"):
            np.testing.assert_allclose(ring[key], full[key],
                                       atol=1e-6 * float(np.abs(full[key]).max()), rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_batchnorm_under_a_group_is_batchnorm_on_the_global_batch(n, tmp_root):
    """``_bn`` in train mode under the group, each rank on its rows, against
    ``_bn`` in one process on the global batch: the output and the input's
    gradient of every row (1e-5), the weight's and bias's gradient summed
    over the ranks (the loss is the sum of the ranks' Σ out · c; 1e-5 of the
    largest), and the running statistics, moved once with the global batch's
    mean and biased variance (1e-6)."""
    out = [r["bn"] for r in _ranks(tmp_root, n)]
    x = _bn_inputs()
    bn = torch.nn.BatchNorm2d(3, eps=1e-5).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(x[name]))
    inp = torch.from_numpy(x["x"]).requires_grad_()
    y = _bn(bn, inp)
    (y * torch.from_numpy(x["c"])).sum().backward()
    np.testing.assert_allclose(np.concatenate([r["out"] for r in out]), y.detach().numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in out]), inp.grad.numpy(),
                               atol=1e-5, rtol=0)
    for key, want in (("dweight", bn.weight.grad), ("dbias", bn.bias.grad)):
        np.testing.assert_allclose(sum(r[key] for r in out), want.numpy(),
                                   atol=1e-5 * float(want.abs().max()), rtol=0)
    for r in out:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[key], getattr(bn, key).numpy(), atol=1e-6, rtol=0)
    # the running variance is the biased one (flax), not torch's unbiased
    unbiased = 0.9 * x["running_var"] + 0.1 * x["x"].var(axis=(0, 2, 3), ddof=1)
    assert not np.allclose(out[0]["running_var"], unbiased, atol=1e-4)
