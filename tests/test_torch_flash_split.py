"""Parity of the port's split-q/k/v attention (``flash_attention``, kernels
B5 and B7 on the card) with the JAX package's, on the CPU.

The port runs its plain versions on CPU tensors; the JAX side runs its
Pallas kernels in interpret mode (``interpret=True``) or its reference.
Inputs come from numpy with a seed. The shape is (B, N, H, D) = (2, 20, 2,
64): N is not a multiple of 8, so the JAX kernel pads to 24 and masks the
padded keys with −1e30 where the port masks keys j ≥ N. Tolerances are
stated per test.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.tools import compare_builds, probe_bwd_layouts

jfa = importlib.import_module("clip_for_dl_tpu.ops.flash_attention")

torch.set_num_threads(1)

B, N, H, D = 2, 20, 2, 64
SEEDS = np.array([[11], [-4242]], np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(layout, seed=0, masked=True):
    """q, k, v and a cotangent in ``layout``, fp32, and a [B, N] key bias
    with padded tails (or None)."""
    rng = np.random.default_rng(seed)
    shape = (B, N, H, D) if layout == "bnhd" else (B, H, N, D)
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = None
    if masked:
        bias = np.zeros((B, N), np.float32)
        bias[0, 13:] = -1e10
        bias[1, 6:] = -1e10
    return q, k, v, ct, bias


def _kw(rate, jax_side=False):
    if not rate:
        return {}
    seeds = jnp.asarray(SEEDS) if jax_side else _t(SEEDS)
    return dict(dropout_rate=rate, dropout_seeds=seeds)


CASES = [(layout, masked, rate) for layout in ("bnhd", "bhnd") for masked in (False, True)
         for rate in (0.0, 0.1)]
IDS = [f"{layout}-{'bias' if masked else 'nobias'}-rate{rate}" for layout, masked, rate in CASES]


@pytest.mark.parametrize("layout,masked,rate", CASES, ids=IDS)
def test_split_forward_matches_interpreted_kernel(layout, masked, rate):
    """fp32 output in the input's layout: 1e-5 absolute (the masks are the
    same bits; only summation order differs)."""
    q, k, v, _, bias = _inputs(layout, masked=masked)
    got = fa.flash_attention(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                             layout=layout, **_kw(rate))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if bias is None else jnp.asarray(bias), layout=layout,
                               interpret=True, **_kw(rate, True))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout,masked,rate", CASES, ids=IDS)
def test_split_gradients_match_jax_grad(layout, masked, rate):
    """dq, dk, dv through ``_Flash`` vs jax.grad through the interpreted
    custom VJP, for a seeded cotangent: 1e-5 absolute on gradients of
    magnitude ≲ 4."""
    q, k, v, ct, bias = _inputs(layout, seed=1, masked=masked)
    jbias = None if bias is None else jnp.asarray(bias)

    def f(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jbias, layout=layout, interpret=True,
                                  **_kw(rate, True))
        return jnp.sum(out * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*xs, None if bias is None else _t(bias), layout=layout,
                             **_kw(rate))
    (out * _t(ct)).sum().backward()
    for name, x, w in zip("qkv", xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_reference_matches_jax_reference(rate):
    """The head-major plain version against the JAX oracle: 1e-5 (the JAX
    one divides by √D, the port multiplies by 1/√D, as the kernels do)."""
    q, k, v, _, bias = _inputs("bhnd", seed=2)
    got = fa.flash_attention_reference(_t(q), _t(k), _t(v), _t(bias), **_kw(rate))
    want = jfa.flash_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(bias), **_kw(rate, True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_equals_packed_bit_for_bit(rate, dtype):
    """q, k, v sliced from a packed qkv (the "bnhd" view of its column
    blocks), and their head-major copies, give the packed form's output and
    gradients bit for bit, dropout included (the JAX docstring's promise)."""
    rng = np.random.default_rng(3)
    qkv = _t(rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)).to(dtype)
    ct = _t(rng.standard_normal((B, N, H * D)).astype(np.float32)).to(dtype)
    bias = _t(_inputs("bnhd")[4])
    kw = _kw(rate)
    x = qkv.clone().requires_grad_()
    out = fa.flash_attention_packed(x, H, bias, **kw)
    out.backward(ct)

    y = qkv.clone().requires_grad_()
    q, k, v = y.view(B, N, 3, H, D).unbind(2)
    split = fa.flash_attention(q, k, v, bias, layout="bnhd", **kw)
    split.backward(ct.view(B, N, H, D))
    assert torch.equal(split.reshape(B, N, H * D), out)
    assert torch.equal(y.grad, x.grad)

    heads = [t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    major = fa.flash_attention(*heads, bias, layout="bhnd", **kw)
    major.backward(ct.view(B, N, H, D).transpose(1, 2))
    assert torch.equal(major.transpose(1, 2).reshape(B, N, H * D), out)
    dqkv = torch.stack([h.grad.transpose(1, 2) for h in heads], dim=2).reshape(B, N, -1)
    assert torch.equal(dqkv, x.grad)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("dim", [32, 96])
def test_split_at_head_dims_32_and_96_matches_jax(dim, layout, rate):
    """A built head dim (32) and one the kernels pad (96): the output and
    dq, dk, dv through ``_Flash`` against the interpreted JAX kernel and
    jax.grad through its custom VJP, fp32, padded keys: 1e-5 absolute."""
    rng = np.random.default_rng(dim)
    shape = (B, N, H, dim) if layout == "bnhd" else (B, H, N, dim)
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = _inputs(layout)[4]

    def f(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(bias), layout=layout, interpret=True,
                                  **_kw(rate, True))
        return jnp.sum(out * ct), out

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*xs, _t(bias), layout=layout, **_kw(rate))
    (out * _t(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for name, x, w in zip("qkv", xs, grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_split_fully_masked_row_is_finite(layout):
    q, k, v, ct, bias = _inputs(layout, seed=4)
    bias[1, :] = -1e10
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*xs, _t(bias), layout=layout, **_kw(0.1))
    (out * _t(ct)).sum().backward()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(x.grad).all() for x in xs)


def test_split_rejects_long_sequences():
    z = torch.zeros(1, fa.MAX_SEQ_LEN + 1, 1, 64)
    with pytest.raises(ValueError, match="sequence length"):
        fa.flash_attention(z, z, z, layout="bnhd")
    with pytest.raises(ValueError, match="sequence length"):
        fa.flash_attention_bwd(z, z, z, z, layout="bnhd")


@pytest.mark.parametrize("bad,match", [
    (dict(layout="nhbd"), "layout"),
    (dict(key_bias=torch.zeros(2, 5)), "key_bias"),
    (dict(dropout_rate=1.0), "dropout_rate"),
    (dict(dropout_rate=0.1), "dropout_seeds"),
], ids=["layout", "bias_shape", "rate", "seeds"])
def test_split_checks_its_arguments_as_jax_does(bad, match):
    q = torch.zeros(2, 8, 2, 64)
    kw = dict(dict(layout="bnhd"), **bad)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, q, q, **kw)


def test_split_refuses_operands_of_different_shapes():
    q = torch.zeros(2, 8, 2, 64)
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention(q, q, torch.zeros(2, 8, 2, 32), layout="bnhd")


def test_layout_probe_runs_its_three_variants_on_the_cpu(tmp_path, capsys):
    """The P1 probe at a tiny shape with the plain versions: the three
    layouts agree bit for bit, it exits 0 and writes BASE.json and BASE.md
    (the kernels' run is on the card: chip_smoke.py phase 2)."""
    base = str(tmp_path / "probe")
    code = probe_bwd_layouts.main(["--batch", "2", "--seq", "13", "--heads", "2", "--dim",
                                   "64", "--iters", "1", "--device", "cpu", "--out", base])
    assert code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [list(json.loads(line)) for line in lines[:3]] == [["shipped"], ["bnhd"], ["bhnd"]]
    result = json.loads(open(base + ".json").read())
    assert result["shape"] == {"B": 2, "N": 13, "NP": 16, "H": 2, "D": 64}
    assert [r["numerics"] for r in result["variants"].values()] == [
        "reference", "bit-equal", "bit-equal"]
    assert "| bhnd |" in open(base + ".md").read()


def test_build_comparison_refuses_a_machine_without_the_card(tmp_path):
    """tools/compare_builds.py needs the card for both builds' kernels; it
    refuses before building anything (its run is on the card)."""
    with pytest.raises(RuntimeError, match="CUDA"):
        compare_builds.main(["--other", str(tmp_path), "--device", "cpu"])
    assert not list(tmp_path.iterdir())
