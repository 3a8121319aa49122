"""Parity of the port's losses (clip_for_dl_tpu_torch/losses) with the JAX
package's, on the CPU in fp32: the same numpy inputs from a seed through
both, the values within 1e-6 relative and the input gradients (``jax.grad``
and autograd) within 1e-5 of each gradient's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu import losses as jl
from clip_for_dl_tpu_torch import losses as pl

torch.set_num_threads(1)

VALUE_RTOL = 1e-6
GRAD_TOL = 1e-5


def _features(seed, b, c, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, d)) * scale).astype(np.float32),
            (rng.standard_normal((c, d)) * scale).astype(np.float32))


def _labels(seed, b, c):
    rng = np.random.default_rng(seed + 100)
    y = (rng.uniform(size=(b, c)) < 0.3).astype(np.float32)
    y[0] = 0.0  # a row without positives
    y[-1] = 1.0  # and one with every class
    return y


def _check(jfn, pfn, arrays, wrt):
    """Value and gradients w.r.t. the arrays at positions ``wrt``."""
    jval, jgrads = jax.value_and_grad(lambda *xs: jfn(*xs), argnums=wrt)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=i in wrt) for i, a in enumerate(arrays)]
    pval = pfn(*ts)
    pval.backward()
    assert pval.dtype == torch.float32
    np.testing.assert_allclose(float(pval.detach()), float(jval), rtol=VALUE_RTOL, atol=0)
    for i, jg in zip(wrt, jgrads):
        jg = np.asarray(jg)
        tol = GRAD_TOL * float(np.abs(jg).max()) + 1e-12
        np.testing.assert_allclose(ts[i].grad.numpy(), jg, atol=tol, rtol=0)


SHAPES = [(4, 4, 8), (8, 8, 32), (16, 16, 64)]


@pytest.mark.parametrize("b,_,d", SHAPES)
@pytest.mark.parametrize("temperature", [0.07, 1.0, 2.0])
def test_info_nce_matches_jax(b, _, d, temperature):
    img, txt = _features(b * d, b, b, d)
    _check(lambda i, t: jl.info_nce_loss(i, t, temperature),
           lambda i, t: pl.info_nce_loss(i, t, temperature), [img, txt], (0, 1))


@pytest.mark.parametrize("b,_,d", SHAPES)
@pytest.mark.parametrize("scale,bias", [(10.0, -10.0), (1.0, 0.0), (100.0, -3.5)])
def test_siglip_matches_jax(b, _, d, scale, bias):
    txt, img = _features(b + d, b, b, d, scale=3.0)
    _check(lambda t, i: jl.siglip_loss(t, i, scale, bias),
           lambda t, i: pl.siglip_loss(t, i, scale, bias), [txt, img], (0, 1))


def test_siglip_gradients_of_the_scale_and_bias_match_jax():
    """s and b as inputs (the learnable-temperature path trains them)."""
    txt, img = _features(7, 8, 8, 16)
    s, b = np.float32(7.5), np.float32(-4.0)
    _check(jl.siglip_loss, pl.siglip_loss, [txt, img, s, b], (0, 1, 2, 3))


@pytest.mark.parametrize("b,c,d", [(4, 3, 8), (8, 16, 32), (16, 5, 64)])
@pytest.mark.parametrize("temperature", [0.07, 1.0])
def test_multilabel_contrastive_matches_jax(b, c, d, temperature):
    img, txt = _features(b * c, b, c, d)
    y = _labels(b, b, c)
    _check(lambda i, t: jl.multilabel_contrastive_loss(i, t, y, temperature),
           lambda i, t: pl.multilabel_contrastive_loss(i, t, torch.from_numpy(y), temperature),
           [img, txt], (0, 1))


def test_multilabel_contrastive_at_the_clamp_matches_jax():
    """T = 0.002 puts two thirds of |sim / T| past 50: the clamped entries give
    log(p + eps) at p = sigmoid(±50) (1 - p = 0 in fp32, so log(eps)), and
    no gradient."""
    img, txt = _features(3, 8, 6, 16)
    txt[:3] = img[:3]  # cosines of 1: sims / T = 500
    y = _labels(3, 8, 6)
    sims = (img / np.linalg.norm(img, axis=1, keepdims=True)) @ (
        txt / np.linalg.norm(txt, axis=1, keepdims=True)).T / 0.002
    assert 0.5 < (np.abs(sims) > 50).mean() < 1.0  # both sides of the clamp
    _check(lambda i, t: jl.multilabel_contrastive_loss(i, t, y, 0.002),
           lambda i, t: pl.multilabel_contrastive_loss(i, t, torch.from_numpy(y), 0.002),
           [img, txt], (0, 1))


@pytest.mark.parametrize("gamma_pos,gamma_neg,clip", [(0.0, 4.0, 0.05), (1.0, 2.0, 0.0)])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_asymmetric_loss_matches_jax(gamma_pos, gamma_neg, clip, reduction):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((8, 16)) * 4).astype(np.float32)
    y = _labels(5, 8, 16)
    _check(lambda x: jl.asymmetric_loss(x, y, gamma_pos, gamma_neg, clip, reduction=reduction),
           lambda x: pl.asymmetric_loss(x, torch.from_numpy(y), gamma_pos, gamma_neg, clip,
                                        reduction=reduction), [logits], (0,))


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (0.0, 0.5)])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_focal_loss_matches_jax(gamma, alpha, reduction):
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((8, 16)) * 4).astype(np.float32)
    y = _labels(6, 8, 16)
    _check(lambda x: jl.focal_loss(x, y, gamma, alpha, reduction),
           lambda x: pl.focal_loss(x, torch.from_numpy(y), gamma, alpha, reduction),
           [logits], (0,))


def test_losses_take_bf16_features_and_return_fp32():
    img, txt = _features(9, 8, 8, 32)
    y = _labels(9, 8, 8)
    bi, bt = (torch.from_numpy(a).bfloat16() for a in (img, txt))
    ji, jt = (jnp.asarray(a, jnp.bfloat16) for a in (img, txt))
    for got, want in ((pl.info_nce_loss(bi, bt, 0.5), jl.info_nce_loss(ji, jt, 0.5)),
                      (pl.siglip_loss(bt, bi), jl.siglip_loss(jt, ji)),
                      (pl.multilabel_contrastive_loss(bi, bt, torch.from_numpy(y)),
                       jl.multilabel_contrastive_loss(ji, jt, y))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=VALUE_RTOL, atol=0)
