"""The port's on-device augmentation (clip_for_dl_tpu_torch/ops/augment.py)
against the JAX package's ``ops/augment.py``, on the CPU.

A ``torch.Generator`` cannot reproduce JAX's keys, so the warp is held on
JAX's own draws: the flip mask and the affine parameters that the JAX
``augment_batch`` samples from its key (``split``, ``bernoulli``,
``_affine_matrices``) go through the port's ``warp``, and the result is
held against ``augment_batch`` on the same images and key. The cases of
the JAX package's own ``tests/test_augment.py`` follow on the port's
functions. Tolerances are stated per test.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.ops import augment as jaugment
from clip_for_dl_tpu_torch.ops.augment import augment_batch, sample_augment, warp

torch.set_num_threads(1)


def jax_draws(key, b, h, w, flip_prob, degrees, translate):
    """The flip mask [B], inverse rotation [B, 2, 2] and translation [B, 2]
    that the JAX ``augment_batch`` draws from ``key``, as torch tensors."""
    k1, k2 = jax.random.split(key)
    flip = jax.random.bernoulli(k1, flip_prob, (b, 1, 1, 1))
    inv, trans = jaugment._affine_matrices(k2, b, degrees, translate, h, w)
    return (torch.from_numpy(np.array(flip).reshape(b)),
            torch.from_numpy(np.array(inv)), torch.from_numpy(np.array(trans)))


@pytest.mark.parametrize("seed,shape,flip_prob,degrees,translate", [
    (0, (4, 16, 16, 3), 0.5, 10.0, 0.1),   # the preset's stack
    (1, (3, 33, 20, 1), 0.5, 30.0, 0.2),   # odd, non-square, one channel
    (2, (6, 24, 24, 3), 1.0, 90.0, 0.3),   # every image flipped, large turns
    (3, (5, 17, 17, 3), 0.0, 0.0, 0.25),   # translation alone
    (4, (8, 32, 32, 3), 0.5, 10.0, 0.1),
])
def test_warp_matches_jax_on_its_draws(seed, shape, flip_prob, degrees, translate):
    """fp32 images in [-2, 2]: 1e-5 absolute (the coordinates' sums in
    another order move a sample by ~1e-6; bilinear sampling is continuous
    where a floor flips)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jaugment.augment_batch(jnp.asarray(images), key, flip_prob, degrees,
                                             translate))
    flip, inv, trans = jax_draws(key, shape[0], shape[1], shape[2], flip_prob, degrees,
                                 translate)
    got = warp(torch.from_numpy(images), flip, inv, trans)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert np.abs(want - images).max() > 0.1 or (degrees == 0 and translate == 0)


def test_warp_of_bf16_images_matches_jax_cast_back():
    """bf16 in, bf16 out, as the train step runs it (JAX widens to fp32 and
    the step casts back): within one bf16 step of values below 1 (2^-8)."""
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((4, 20, 20, 3)).astype(np.float32)).bfloat16()
    key = jax.random.key(5)
    want = jaugment.augment_batch(jnp.asarray(images.float().numpy()).astype(jnp.bfloat16),
                                  key, 0.5, 10.0, 0.1).astype(jnp.bfloat16)
    got = warp(images, *jax_draws(key, 4, 20, 20, 0.5, 10.0, 0.1))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2.0 ** -8, rtol=0)


def _no_warp(b):
    return torch.eye(2).expand(b, 2, 2), torch.zeros(b, 2)


def test_flip_prob_extremes():
    """Flip probability 0 leaves every image; 1 flips every image left-right
    (exact)."""
    imgs = torch.from_numpy(np.random.default_rng(0).random((4, 8, 8, 3)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    for prob, want in ((0.0, imgs), (1.0, imgs.flip(2))):
        flip, _, _ = sample_augment(4, g, prob, 0.0, 0.0, 8, 8)
        assert bool(flip.all()) == (prob == 1.0) and bool(flip.any()) == (prob == 1.0)
        assert torch.equal(warp(imgs, flip, *_no_warp(4)), want)


def test_zero_parameters_are_the_identity():
    """No rotation and no translation: the images themselves (1e-5; the
    taps' weights are exactly 1 and 0)."""
    imgs = torch.from_numpy(np.random.default_rng(1).random((2, 16, 16, 3)).astype(np.float32))
    out = augment_batch(imgs, torch.Generator().manual_seed(0), 0.0, 0.0, 0.0)
    torch.testing.assert_close(out, imgs, atol=1e-5, rtol=0)


def test_a_90_degree_turn_is_rot90():
    """The exact inverse rotation of 90° turns a square image as np.rot90
    over (H, W), exactly; a random 45° turn keeps the centre pixel (1e-4,
    as the JAX test holds it)."""
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.random((2, 9, 9, 2)).astype(np.float32))
    inv = torch.tensor([[0.0, 1.0], [-1.0, 0.0]]).expand(2, 2, 2)
    out = warp(imgs, torch.zeros(2, dtype=torch.bool), inv, torch.zeros(2, 2))
    np.testing.assert_array_equal(out.numpy(), np.rot90(imgs.numpy(), 1, axes=(1, 2)))
    turned = augment_batch(imgs, torch.Generator().manual_seed(1), 0.0, 45.0, 0.0)
    torch.testing.assert_close(turned[:, 4, 4], imgs[:, 4, 4], atol=1e-4, rtol=0)


def test_a_shift_moves_the_content():
    """A translation of (+2, -3) pixels moves a single bright pixel from
    (8, 8) to (10, 5), its mass kept (exact at integer shifts); a random
    translation keeps the mass (1e-4)."""
    imgs = torch.zeros(1, 16, 16, 1)
    imgs[0, 8, 8, 0] = 1.0
    eye, _ = _no_warp(1)
    out = warp(imgs, torch.zeros(1, dtype=torch.bool), eye, torch.tensor([[2.0, -3.0]]))
    assert out[0, 10, 5, 0] == 1.0 and out.sum() == 1.0
    moved = augment_batch(imgs, torch.Generator().manual_seed(3), 0.0, 0.0, 0.3)
    assert float(moved.sum()) == pytest.approx(1.0, abs=1e-4)
    assert moved[0, 8, 8, 0] < 1.0


def test_augment_batch_is_seeded_by_its_generator():
    """The same generator state gives the same batch; another seed another
    one."""
    imgs = torch.from_numpy(np.random.default_rng(4).random((3, 16, 16, 3)).astype(np.float32))
    a = augment_batch(imgs, torch.Generator().manual_seed(7))
    b = augment_batch(imgs, torch.Generator().manual_seed(7))
    c = augment_batch(imgs, torch.Generator().manual_seed(8))
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 0


def test_sample_augment_draws_jax_distributions():
    """Over 20000 images: angles within ±d (in radians) and spread over the
    range, translations within ±t·(H, W), about half flipped, and the
    inverse rotation orthonormal with determinant 1 (1e-6)."""
    b, d, t, h, w = 20000, 10.0, 0.1, 224, 200
    flip, inv, trans = sample_augment(b, torch.Generator().manual_seed(0), 0.5, d, t, h, w)
    angles = torch.atan2(inv[:, 0, 1], inv[:, 0, 0])
    lim = d * math.pi / 180.0
    assert float(angles.abs().max()) <= lim + 1e-6 and float(angles.abs().max()) > 0.99 * lim
    assert abs(float(angles.mean())) < 0.01 * lim
    for axis, size in enumerate((h, w)):
        col = trans[:, axis]
        largest = float(col.abs().max())
        assert 0.99 * t * size < largest <= t * size + 1e-4
    assert 0.48 < float(flip.float().mean()) < 0.52
    det = inv[:, 0, 0] * inv[:, 1, 1] - inv[:, 0, 1] * inv[:, 1, 0]
    torch.testing.assert_close(det, torch.ones(b), atol=1e-6, rtol=0)
    torch.testing.assert_close(inv[:, 1, 1], inv[:, 0, 0], atol=0, rtol=0)
    torch.testing.assert_close(inv[:, 1, 0], -inv[:, 0, 1], atol=0, rtol=0)
