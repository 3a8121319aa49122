"""Data parallelism of the port (clip_for_dl_tpu_torch/parallel, the steps
with ``group``) against the JAX package's ``data_parallel_step`` and against
the port's own single-process step on the global batch, on the CPU in fp32.

N = 2 and 4 gloo ranks (``clip_for_dl_tpu_torch.testing.ranks``, started by
``torchrun --standalone`` on a free port, with a deadline) take their
rows of one global batch of 8; the JAX side runs the same step jitted over a
2- and a 4-device slice of conftest's 8-device CPU mesh. A tiny CXRClip
(ResNet stages (1, 1, 1, 1) at width 8, BERT 2 x 64 with 2 heads, 32 px,
dropout 0; the multi-view fusion's dropout off on both sides, as in
tests/test_torch_multiview.py) gets its variables from a seed. Both sides
update with SGD at learning rate 1 after the clip at 1.0, so that a
parameter's change is its clipped gradient: the rank-side clip must see the
all-reduced gradient. Tolerances, stated per test, are those the port's
single-device tests hold against JAX (tests/test_torch_train.py), never
looser than JAX's own data-parallel test (loss rel 1e-4, atol 5e-4).
"""

import functools
import os
from unittest import mock

import flax.linen
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
from clip_for_dl_tpu.train import freeze_mask
from clip_for_dl_tpu.train import make_adapter_train_step as jmake_adapter_step
from clip_for_dl_tpu.train import make_clip_pretrain_step as jmake_pretrain_step
from clip_for_dl_tpu.train import make_multiview_train_step as jmake_multiview_step
from clip_for_dl_tpu.train import make_shared_adapter_train_step as jmake_shared_step
from clip_for_dl_tpu.train.optim import make_label_fn as jmake_label_fn
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, get_preset
from clip_for_dl_tpu_torch.models import state_dict_from_jax
from clip_for_dl_tpu_torch.ops.image_prep import preprocess_images
from clip_for_dl_tpu_torch.parallel import shard_rows
from clip_for_dl_tpu_torch.testing import ranks
from clip_for_dl_tpu_torch.train import (
    CheckpointManager,
    TrainState,
    make_adapter_eval_step,
    make_label_fn,
    make_optimizer,
    run_eval,
)

torch.set_num_threads(1)

TINY = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=64,
    text_layers=2, text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    dropout=0.0, flash_attention=True,
)
GROUPS = [g.name for g in get_preset("pretrain_clip").train.groups]
LRS = {**{g: 1.0 for g in GROUPS}, "default": 1.0}
CLIP = 1.0
B = 8
PREP = dict(image_size=32, mean=CLIP_MEAN, std=CLIP_STD)
# the pretrain cases: (loss, learnable temperature, local-loss form)
PRETRAIN = {
    "self_distill": ("clip_self_distill", False, False),
    "info_nce": ("info_nce", False, False),
    "siglip_learnable": ("siglip", True, False),
    "self_distill_local": ("clip_self_distill", False, True),
    "siglip_ring": ("siglip", True, True),
}
HEADS = ("adapter", "shared", "multiview")


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
    elif name == "embedding":
        v = rng.standard_normal(shape) * 0.5
    elif name == "logit_scale":
        v = np.log(np.full(shape, 10.0))
    elif name == "logit_bias":
        v = np.full(shape, -10.0)
    else:
        v = rng.standard_normal(shape) * 0.1
    return np.asarray(v, np.float32)


def _config(learnable=False):
    extra = dict(learnable_temperature=True, logit_scale_init=10.0) if learnable else {}
    return dict(TINY, **extra)


@functools.lru_cache(maxsize=None)
def _variables(learnable=False, seed=1):
    jmodel = JCXRClip(JModelConfig(**_config(learnable)))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(seed)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng)}


def _batch(seed=4, b=B):
    """48x48 grey uint8 exams (frontal, lateral), token ids with padded
    tails, multi-hot labels with every exam positive somewhere. The seed
    keeps every pre-activation of the ResNet's ReLUs at least 2e-5 from the
    kink (test_the_cases_keep_off_the_relu_kinks): a value within the
    step's summation-order noise (~2e-6) of 0 flips its ReLU between two
    orders of the same sums and moves one channel's gradient by its whole
    upstream value, in any two runs that sum in other orders."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 12), np.int32)
    for i, n in enumerate((7, 3, 9, 12, 5, 12, 10, 4)[:b]):
        mask[i, n:] = 0
    labels = (rng.random((b, 16)) < 0.3).astype(np.float32)
    labels[np.arange(b), np.arange(b) % 16] = 1.0
    return {"images": rng.integers(0, 256, (b, 2, 48, 48, 1), dtype=np.uint8),
            "input_ids": rng.integers(5, 64, (b, 12)).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def _bank(seed=3):
    f = np.random.default_rng(seed).standard_normal((16, 64)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _case(kind, name=None):
    """The rank-side description of one case (testing/ranks.py)."""
    b = _batch()
    common = dict(kind=kind, batch=None, clip=CLIP, temperature=2.0, **PREP)
    if kind == "pretrain":
        loss, learnable, local = PRETRAIN[name]
        batch = {k: b[k] for k in ("input_ids", "attention_mask")}
        batch["images"] = b["images"][:, 0]
        return dict(common, config=_config(learnable), variables=_variables(learnable),
                    batch=batch, loss=loss, local=local, groups=GROUPS, lrs=LRS)
    if kind == "multiview":
        return dict(common, config=TINY, variables=_variables(), temperature=0.07,
                    batch={"images": b["images"], "labels": b["labels"]}, bank=_bank(),
                    lrs={"default": 1.0})
    trainable = "adapter" if kind == "adapter" else "shared_adapter"
    batch = {"images": b["images"][:, 0], "labels": b["labels"]}
    if kind == "shared":
        batch.update(input_ids=b["input_ids"], attention_mask=b["attention_mask"])
    return dict(common, config=TINY, variables=_variables(), batch=batch,
                lrs={trainable: 1.0, "default": 0.0})


# -- the JAX side ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
@mock.patch.object(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
def _jax_step(kind, name, n):
    """The JAX step of a case jitted over an n-device mesh: (loss, state
    after, parameter change), in the port's names."""
    case = _case(kind, name)
    jmodel = JCXRClip(JModelConfig(**case["config"]))
    variables = case["variables"]
    # the gradient itself: the step's group learning rates apply −lr
    sgd = optax.identity()
    if kind == "pretrain":
        tx = optax.chain(optax.clip_by_global_norm(CLIP), sgd)
        raw = jmake_pretrain_step(jmodel, tx, jmake_label_fn(GROUPS), case["loss"], 2.0,
                                  compute_dtype=jnp.float32, **PREP)
        rest = (case["lrs"], jax.random.key(0))
    elif kind == "multiview":
        tx = optax.chain(optax.clip_by_global_norm(CLIP), sgd)
        raw = jmake_multiview_step(jmodel, tx, jmake_label_fn([]), temperature=0.07,
                                   compute_dtype=jnp.float32, augment=False, **PREP)
        rest = (jnp.asarray(case["bank"]), case["lrs"], jax.random.key(0))
    else:
        trainable = "adapter" if kind == "adapter" else "shared_adapter"
        make = jmake_adapter_step if kind == "adapter" else jmake_shared_step
        tx = sgd
        raw = make(jmodel, tx, jmake_label_fn([trainable]),
                   freeze_mask(variables["params"], [trainable]), compute_dtype=jnp.float32,
                   **PREP)
        rest = (case["lrs"], jax.random.key(0))
    mesh = create_mesh(n)
    step = jdata_parallel_step(raw, mesh, donate_state=False)
    state = jreplicate_state(JTrainState.create(variables, tx), mesh)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    state, metrics = step(state, batch, *rest)
    after = jax.device_get(state)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - b, after.params, variables["params"])
    return (float(metrics["loss"]), state_dict_from_jax(after.params, after.batch_stats),
            state_dict_from_jax(delta, after.batch_stats))


# -- the port side ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _single(kind, name=None):
    """The port's single-process step on the global batch: (loss, state, change)."""
    # the local-loss forms are one loss over the global batch: in one process
    # its plain form
    losses, model, delta = ranks.step_case(dict(_case(kind, name), local=False))
    return losses[0], ranks.host_state(model), delta


def _eval_batches():
    """Two global batches of 8 for the adapter's eval; the second padded
    after 5 real rows (mask 0 and zero images), so that at 4 ranks the
    ranks hold 2, 2, 1 and 0 real rows of it."""
    b = _batch()
    first = {"images": b["images"][:, 0], "labels": b["labels"], "mask": np.ones(B, np.float32)}
    second = {k: v.copy() for k, v in first.items()}
    second["images"][5:] = 0
    second["mask"][5:] = 0
    return [first, second]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dp_ckpt"))


def _common_cases(n, ckpt_dir, workdir):
    cases = {f"pretrain/{name}": _case("pretrain", name) for name in PRETRAIN}
    cases.update({kind: _case(kind) for kind in HEADS})
    cases["eval"] = dict(kind="eval", config=TINY, variables=_variables(),
                         batches=_eval_batches(), **PREP)
    cases["preempt"] = dict(_case("pretrain", "self_distill"), kind="preempt", at=2, steps=4,
                            dir=str(workdir / "preempt"), lrs=LRS)
    cases["checkpoint"] = dict(_case("pretrain", "self_distill"), kind="checkpoint",
                               dir=ckpt_dir, mode="write" if n == 4 else "restore",
                               lrs={**LRS, **{g: 1e-3 for g in LRS}})
    return cases


@pytest.fixture(scope="module")
def four(tmp_path_factory, ckpt_dir):
    work = tmp_path_factory.mktemp("dp4")
    return ranks.launch(_common_cases(4, ckpt_dir, work), 4, str(work))


@pytest.fixture(scope="module")
def two(tmp_path_factory, ckpt_dir, four):
    """Two ranks, after the four (whose checkpoint they restore)."""
    work = tmp_path_factory.mktemp("dp2")
    return ranks.launch(_common_cases(2, ckpt_dir, work), 2, str(work))


@pytest.fixture(scope="module")
def runs(two, four):
    return {2: two, 4: four}


def _assert_delta_close(got, want, rel, err=""):
    """Each change within ``rel`` of its tensor's largest change, and the
    resolution of after − before in fp32 (two steps of a weight near 1)."""
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name], w, atol=rel * float(np.abs(w).max()) + 2.5e-7,
                                   rtol=0, err_msg=f"{err} {name}")


def _running(state):
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


# -- the tests ---------------------------------------------------------------------


JAX_CASES = [("pretrain", "self_distill", 2), ("pretrain", "self_distill", 4),
             ("pretrain", "info_nce", 2), ("pretrain", "siglip_learnable", 2),
             ("adapter", None, 2), ("shared", None, 2), ("multiview", None, 2)]


@pytest.mark.parametrize("kind,name,n", JAX_CASES,
                         ids=[f"{k}-{m or k}-{n}" for k, m, n in JAX_CASES])
def test_dp_step_matches_jax_data_parallel_step(kind, name, n, runs):
    """The N-rank step against JAX's step over an N-device mesh: the loss
    at 5e-5 absolute (and 1e-4 relative); each parameter's change (its
    clipped gradient) within 1e-4 of the tensor's largest change, plus
    after − before's fp32 resolution; the BatchNorm running statistics
    (ResNet, global batch) at 1e-5."""
    key = f"pretrain/{name}" if kind == "pretrain" else kind
    got = runs[n][0][key]
    loss, state, delta = _jax_step(kind, name, n)
    assert got["losses"][0] == pytest.approx(loss, abs=5e-5, rel=1e-4)
    # every rank reports the global loss
    assert {r[key]["losses"][0] for r in runs[n]} == {got["losses"][0]}
    _assert_delta_close(got["delta"], {k: delta[k] for k in got["delta"]}, 1e-4, key)
    for k, v in _running(state).items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), atol=1e-5, rtol=0, err_msg=k)


ALL = [("pretrain", name) for name in PRETRAIN] + [(k, None) for k in HEADS]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind,name", ALL, ids=[m or k for k, m in ALL])
def test_n_rank_step_equals_the_single_process_step(kind, name, n, runs):
    """The N-rank step against the port's own step on the global batch in
    one process: each parameter's change at 5e-6 absolute, the loss at
    1e-6 relative, the whole state after it (running statistics, the
    learnable scale) at 5e-6. The local-loss forms (siglip's ring) against
    the single process's all-gather-free loss too."""
    key = f"pretrain/{name}" if kind == "pretrain" else kind
    got = runs[n][0][key]
    loss, state, delta = _single(kind, name)
    assert got["losses"][0] == pytest.approx(loss, rel=1e-6, abs=1e-7)
    for k, v in delta.items():
        np.testing.assert_allclose(got["delta"][k], v, atol=5e-6, rtol=0, err_msg=k)
    for k, v in state.items():
        np.testing.assert_allclose(got["state"][k], v, atol=5e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_padded_eval_batch_gathers_as_one_process(n, runs):
    """``run_eval`` of the adapter's eval step, each rank fed its rows of two
    global batches, the second padded after 5 real rows (at 4 ranks: 2, 2,
    1 and 0 real rows): every rank holds the single process's probabilities
    and labels of the real rows, in order (1e-6), and its mean loss over the
    global batches (1e-6 relative)."""
    state = TrainState(ranks.model_from(dict(config=TINY, variables=_variables())), None)
    step = make_adapter_eval_step(state.model, compute_dtype=torch.float32, **PREP)
    want = run_eval(step, state, [ranks.tensors(b) for b in _eval_batches()])
    assert len(want["probs"]) == 8 + 5
    reals = [r["eval"]["real_rows"][1] for r in runs[n]]
    assert sum(reals) == 5 and len(set(reals)) > 1
    for r in runs[n]:
        got = r["eval"]["eval"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["labels"], want["labels"])


def test_checkpoint_written_at_four_ranks_by_the_primary_alone(runs):
    """The save at 4 ranks: rank 0 wrote the checkpoint and its metrics,
    no other rank wrote a file."""
    written = [sorted(os.path.basename(p) for p in r["checkpoint"]["written"])
               for r in runs[4]]
    assert written == [["0.json", "0.json.tmp", "0.pt"], [], [], []]


@pytest.mark.parametrize("n", [2, 1])
def test_checkpoint_written_at_four_ranks_restores_at_fewer(n, runs, ckpt_dir):
    """The state saved at 4 ranks restores at 2 ranks (each rank, then a
    step that keeps them equal) and in one process, bit for bit."""
    if n == 2:
        restored = [r["checkpoint"]["restored"] for r in runs[2]]
    else:
        case = _case("pretrain", "self_distill")
        model = ranks.model_from(case)
        opt = make_optimizer(model, make_label_fn(GROUPS), weight_decay=1e-3)
        state, _ = CheckpointManager(ckpt_dir).restore(TrainState(model, opt))
        assert state.step == 1
        restored = [ranks.host_state(model)]
    saved = torch.load(f"{ckpt_dir}/0.pt", map_location="cpu", weights_only=True)["model"]
    for got in restored:
        assert got.keys() == saved.keys()
        for k, v in saved.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    if n == 2:
        assert {r["checkpoint"]["step"] for r in runs[2]} == {1}


@pytest.mark.parametrize("n", [2, 4])
def test_a_preemption_seen_by_one_rank_stops_every_rank_at_one_step(n, runs):
    """The signal reaches rank 1 alone, after its step 2 of 4: every rank
    stops after that step (the flag's all-reduce after each step), as one
    process stops after the step its signal arrived in, and the primary
    writes one preemption save."""
    taken = [r["preempt"]["taken"] for r in runs[n]]
    assert taken == [[1, 2]] * n
    assert [r["preempt"]["epochs"] for r in runs[n]] == [0] * n
    assert [r["preempt"]["preempt"] for r in runs[n]] == [0] * n


@pytest.mark.parametrize("kind,name,views", [("pretrain", "self_distill", 1),
                                             ("pretrain", "siglip_learnable", 1),
                                             ("multiview", None, 2)])
def test_the_cases_keep_off_the_relu_kinks(kind, name, views):
    """The train-mode ResNet's ReLU inputs on each case's batch: none within
    2e-5 of 0 (see ``_batch``), so that the comparisons above are of
    gradients, not of which side of a kink a summation order lands on."""
    case = _case(kind, name)
    model = ranks.model_from(case).train()
    seen, relu = [], torch.nn.functional.relu

    def recording(x, *a, **kw):
        seen.append(float(x.detach().abs().min()))
        return relu(x, *a, **kw)

    imgs = case["batch"]["images"]
    x = preprocess_images(torch.from_numpy(imgs.reshape(-1, *imgs.shape[-3:])), 32, 32,
                          CLIP_MEAN, CLIP_STD, torch.float32)
    with mock.patch.object(torch.nn.functional, "relu", recording), torch.no_grad():
        if views == 2:
            model.encode_multiview(x.reshape(imgs.shape[0], 2, *x.shape[1:]))
        else:
            model.encode_image(x)
    assert len(seen) > 10 and min(seen) > 2e-5


def test_shard_rows_slices_contiguously_and_by_microbatch():
    """Rank r's rows: r·b … (r + 1)·b; with A microbatches, its contiguous
    share of each global microbatch (as the mesh shards a microbatch)."""
    x = np.arange(16)
    assert shard_rows(x, 1, 4).tolist() == [4, 5, 6, 7]
    assert shard_rows(x, 1, 2, microbatches=2).tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    t = torch.arange(24).reshape(12, 2)
    assert shard_rows(t, 2, 3, microbatches=2).tolist() == [[8, 9], [10, 11], [20, 21], [22, 23]]
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(x, 0, 3)
