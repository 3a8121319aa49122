"""``bf16_attention_probs`` in the port (``--bf16-attention-probs``;
clip_for_dl_tpu_torch/models/bf16_probs.py) on the CPU, against the JAX
package.

Both towers on the plain attention route, fp32 compute, the softmax output
rounded to bf16 before the dropout and the P·V product: the BERT encoder
and the ViT with the JAX variables (``models/convert.py``), their last
hidden states and every parameter's gradient of Σ out · cot within two bf16
steps of each tensor's largest entry (BERT's key biases, whose gradient is
zero, within 1e-5 of it), and closer to JAX's bf16 route than
to its fp32 one. What the backward keeps is read with
``torch.autograd.graph.saved_tensors_hooks``: no fp32 [B, H, N, N] tensor
(the plain route keeps one). The dropout on bf16 probabilities divides by
1 − rate rounded to bf16, as flax does on a bf16 array. Under flash
attention the flag warns with the JAX package's text and changes nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.models.bert import BertEncoder as JBertEncoder
from clip_for_dl_tpu.models.vit import ViT as JViT
from clip_for_dl_tpu_torch.models import convert
from clip_for_dl_tpu_torch.models.bert import BertEncoder
from clip_for_dl_tpu_torch.models.bf16_probs import attend_bf16
from clip_for_dl_tpu_torch.models.vit import ViT
from test_torch_models import _fill

torch.set_num_threads(1)

B, L, N_VIT = 3, 7, 17  # N_VIT: 4 x 4 patches of 16 px images and the class token
BERT = dict(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64, max_position=16)
VIT = dict(image_size=16, patch=4, hidden=32, layers=2, heads=2, mlp_dim=64)


def _bert_inputs():
    rng = np.random.default_rng(3)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    return rng.integers(0, 64, (B, L)).astype(np.int32), mask


def _vit_inputs():
    return np.random.default_rng(4).standard_normal((B, 16, 16, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(tower: str, bf16_probs: bool):
    """JAX's output and every gradient of Σ out · cot (cot fixed by a
    seed), and the variables, in the port's names."""
    if tower == "bert":
        model, args = JBertEncoder(**BERT, bf16_probs=bf16_probs), _bert_inputs()
    else:
        model, args = JViT(**VIT, bf16_probs=bf16_probs), (_vit_inputs(),)
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    params = _fill(shapes["params"], np.random.default_rng(5))
    out = model.apply({"params": params}, *args)
    cot = np.random.default_rng(6).standard_normal(out.shape).astype(np.float32)

    def objective(p):
        return jnp.sum(model.apply({"params": p}, *args) * cot)

    grads = jax.grad(objective)(params)
    names = convert._bert if tower == "bert" else convert._vit
    return (np.asarray(out), cot, {k[2:]: v for k, v in names(params, "t").items()},
            {k[2:]: v for k, v in names(jax.device_get(grads), "t").items()})


def _port(tower: str, bf16_probs: bool = True, flash: bool = False):
    """The port's tower with JAX's variables (eval mode): its output and
    every gradient of Σ out · cot."""
    _, cot, state, _ = _jax(tower, bf16_probs)
    if tower == "bert":
        model = BertEncoder(**BERT, bf16_probs=bf16_probs, flash=flash)
        ids, mask = _bert_inputs()
        run = lambda: model(torch.from_numpy(ids).long(), torch.from_numpy(mask))  # noqa: E731
    else:
        model = ViT(**VIT, bf16_probs=bf16_probs, flash=flash)
        run = lambda: model(torch.from_numpy(_vit_inputs()))  # noqa: E731
    model.load_state_dict(state, strict=True)
    model.eval()
    out = run()
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy() for n, p in model.named_parameters()
                                  if p.grad is not None}


def _two_steps(want: np.ndarray) -> float:
    """Two bf16 steps at the tensor's largest entry."""
    top = float(np.abs(want).max())
    return 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0


@pytest.mark.parametrize("tower", ["bert", "vit"])
def test_bf16_probs_match_jax_within_two_bf16_steps(tower):
    want, _, _, jgrads = _jax(tower, True)
    got, grads = _port(tower)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=_two_steps(want), rtol=0)
    assert grads.keys() <= jgrads.keys() and len(grads) > 10
    for name, g in grads.items():
        w = jgrads[name].numpy()
        if name.endswith("key.bias"):
            # zero (softmax is blind to a shift of its logits), in both up to
            # fp32 sums: no largest entry to scale a step by
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5, name
            continue
        np.testing.assert_allclose(g, w, atol=_two_steps(w), rtol=0, err_msg=name)


@pytest.mark.parametrize("tower", ["bert", "vit"])
def test_bf16_probs_are_jaxs_bf16_route_not_its_fp32_one(tower):
    """The port's output departs from JAX's bf16 route by less than a
    tenth of JAX's bf16 route's departure from its fp32 route."""
    want, _, _, _ = _jax(tower, True)
    fp32, _, _, _ = _jax(tower, False)
    got, _ = _port(tower)
    apart = float(np.abs(want - fp32).max())
    assert apart > 0
    assert float(np.abs(got - want).max()) < 0.1 * apart


def _saved(tower: str, bf16_probs: bool):
    """(shape, dtype) of every tensor the forward saves for the backward,
    train mode at dropout 0.1 for BERT."""
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    if tower == "bert":
        model = BertEncoder(**BERT, bf16_probs=bf16_probs, dropout=0.1).train()
        ids, mask = _bert_inputs()
        args = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
    else:
        model = ViT(**VIT, bf16_probs=bf16_probs).train()
        args = (torch.from_numpy(_vit_inputs()),)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(*args, generator=torch.Generator().manual_seed(0)) if tower == "bert" \
            else model(*args)
    return saved


@pytest.mark.parametrize("tower", ["bert", "vit"])
def test_no_fp32_probabilities_are_saved(tower):
    """With the flag the saved [B, H, N, N] tensors are bf16 (and the
    dropout's boolean mask); without it an fp32 one is saved."""
    n = L if tower == "bert" else N_VIT
    probs = (B, 2, n, n)
    got = [dt for shape, dt in _saved(tower, True) if shape == probs]
    assert torch.bfloat16 in got and torch.float32 not in got, got
    assert torch.float32 in [dt for shape, dt in _saved(tower, False) if shape == probs]


def test_dropout_divides_bf16_probabilities_as_flax_does():
    """Kept entries divided by 1 − rate rounded to bf16 (0.9 → 0.90234375)
    and the quotient rounded to bf16: the output of the dropped
    probabilities times v as JAX computes it, within fp32 rounding."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 2, 9, 9)).astype(np.float32) * 3
    v = rng.standard_normal((2, 2, 9, 4)).astype(np.float32)
    keep = rng.random((2, 2, 9, 9)) >= 0.1
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1).astype(jnp.bfloat16)
    dropped = jnp.where(keep, p / 0.9, jnp.zeros((), p.dtype))
    assert dropped.dtype == jnp.bfloat16
    want = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", dropped.astype(jnp.float32), v))
    got = attend_bf16(torch.from_numpy(logits), torch.from_numpy(v), torch.from_numpy(keep),
                      0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("tower", ["bert", "vit"])
def test_flash_ignores_the_flag_with_jaxs_warning(tower):
    """Under flash attention the flag warns (the JAX text) and the output
    is the flash route's without it."""
    with pytest.warns(UserWarning, match="bf16_attention_probs is ignored when flash "
                                         "attention is enabled"):
        got, _ = _port(tower, flash=True)
    want, _ = _port(tower, bf16_probs=False, flash=True)
    np.testing.assert_array_equal(got, want)
