"""Parity of the port's phase B (the C-Adapter steps, the epoch loop,
checkpoints, preemption and the copied metric modules) with the JAX
package's, on the CPU in fp32.

A tiny JAX CXRClip (ResNet stages (1, 1, 1, 1) at width 8; BERT with 2
layers, hidden 128; 32 px images; dropout 0) gets its variables from a
seed; ``state_dict_from_jax`` carries them into the port. The same numpy
batches (48×48 grey uint8 images, 16-label multi-hot targets) then go
through both packages: the adapter steps with the JAX CLI's optimizer
(Adam, no clip, no weight decay, lrs {"adapter": 1e-3, "default": 0}),
``fit`` and the checkpoint managers. Tolerances are stated per test.
"""

import csv
import functools
import importlib
import inspect
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.core.prng import KeyChain
from clip_for_dl_tpu.losses import bce_with_logits_loss as jbce
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.torch_export import save_reference_checkpoint
from clip_for_dl_tpu.train import CheckpointManager as JCheckpointManager
from clip_for_dl_tpu.train import History as JHistory
from clip_for_dl_tpu.train import TrainState as JTrainState
from clip_for_dl_tpu.train import base_transform, freeze_mask
from clip_for_dl_tpu.train import fit as jfit
from clip_for_dl_tpu.train import make_adapter_eval_step as jmake_eval
from clip_for_dl_tpu.train import make_adapter_train_step as jmake_step
from clip_for_dl_tpu.train import make_label_fn as jmake_label_fn
from clip_for_dl_tpu.train import resume_or_init as jresume
from clip_for_dl_tpu.train import run_eval as jrun_eval
from clip_for_dl_tpu_torch.core.config import CLIP_MEAN, CLIP_STD, ModelConfig
from clip_for_dl_tpu_torch.evals import metrics as port_metrics
from clip_for_dl_tpu_torch.evals import writer as port_writer
from clip_for_dl_tpu_torch.losses import bce_with_logits_loss
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.train import (
    CheckpointManager,
    History,
    PreemptionGuard,
    TrainState,
    fit,
    import_reference_checkpoint,
    make_adapter_eval_step,
    make_adapter_train_step,
    make_label_fn,
    make_optimizer,
    make_shared_adapter_train_step,
    resume_or_init,
    run_eval,
)
from clip_for_dl_tpu_torch.train import preemption as port_preemption
from clip_for_dl_tpu_torch.train.optim import freeze_mask as port_freeze_mask
from clip_for_dl_tpu_torch.train.steps import make_clip_pretrain_step, update_ema

jmetrics = importlib.import_module("clip_for_dl_tpu.evals.metrics")
jwriter = importlib.import_module("clip_for_dl_tpu.evals.writer")
jpreemption = importlib.import_module("clip_for_dl_tpu.train.preemption")

torch.set_num_threads(1)

TINY = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=128,
    text_layers=2, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8, dropout=0.0,
)
LRS = {"adapter": 1e-3, "default": 0.0}
STEP_KW = dict(image_size=32, mean=CLIP_MEAN, std=CLIP_STD)


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


@functools.lru_cache(maxsize=None)
def _jax_model():
    jmodel = JCXRClip(JModelConfig(**TINY))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(1)
    return jmodel, {"params": _fill(shapes["params"], rng),
                    "batch_stats": _fill(shapes["batch_stats"], rng)}


def _batch(seed, b=4):
    """48×48 grey uint8 images and multi-hot labels over 16 classes."""
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (b, 48, 48, 1), dtype=np.uint8),
            "labels": (rng.random((b, 16)) < 0.4).astype(np.float32)}


def _port_model():
    model = CXRClip(ModelConfig(**TINY))
    _, variables = _jax_model()
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_steps():
    jmodel, variables = _jax_model()
    tx = base_transform(None, 0.0)
    step = jax.jit(jmake_step(jmodel, tx, jmake_label_fn(["adapter"]),
                              freeze_mask(variables["params"], ["adapter"]),
                              compute_dtype=jnp.float32, **STEP_KW))
    eval_step = jax.jit(jmake_eval(jmodel, compute_dtype=jnp.float32, **STEP_KW))
    return JTrainState.create(variables, tx), step, eval_step


def _port_steps(model=None):
    model = _port_model() if model is None else model
    label_fn = make_label_fn(["adapter"])
    opt = make_optimizer(model, label_fn)
    step = make_adapter_train_step(model, opt, label_fn, compute_dtype=torch.float32, **STEP_KW)
    eval_step = make_adapter_eval_step(model, compute_dtype=torch.float32, **STEP_KW)
    return TrainState(model, opt), step, eval_step


# ---------------------------------------------------------------------------
# the adapter steps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _three_steps():
    batches = [_batch(s) for s in (10, 11, 12)]
    jstate, jstep, _ = _jax_steps()
    jlosses = []
    for i, b in enumerate(batches):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, LRS,
                          jax.random.key(i))
        jlosses.append(float(m["loss"]))
    state, step, _ = _port_steps()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses = [float(step(state, _port_batch(b), LRS)[1]["loss"]) for b in batches]
    return dict(jlosses=jlosses, jparams=jax.device_get(jstate.params), losses=losses,
                before=before, after=state.model.state_dict(), steps=state.step)


def test_adapter_train_step_losses_match_jax():
    """BCE of three steps on three batches (≈ 0.7): 1e-5 absolute."""
    r = _three_steps()
    assert r["steps"] == 3
    np.testing.assert_allclose(r["losses"], r["jlosses"], atol=1e-5, rtol=0)


def test_adapter_train_step_weights_match_jax():
    """The adapter after three Adam steps at lr 1e-3: 1e-5 absolute (each
    step moves an entry by ≤ 1e-3; fp32 features of ~1e-1)."""
    r = _three_steps()
    adapter = r["jparams"]["adapter"]["classifier"]
    for name, want in (("weight", np.asarray(adapter["kernel"]).T),
                       ("bias", np.asarray(adapter["bias"]))):
        got = r["after"][f"adapter.classifier.{name}"].numpy()
        assert not np.array_equal(got, r["before"][f"adapter.classifier.{name}"].numpy())
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


def test_adapter_train_step_leaves_towers_and_batchnorm_bit_equal():
    """Every tensor but the adapter's, BatchNorm running statistics
    included, is bit-equal after three steps, as the JAX freeze mask keeps
    its towers."""
    r = _three_steps()
    frozen = [k for k in r["before"] if not k.startswith("adapter.")]
    assert any(k.endswith("running_var") for k in frozen)
    for k in frozen:
        assert torch.equal(r["after"][k], r["before"][k]), k
    _, variables = _jax_model()
    np.testing.assert_array_equal(
        np.asarray(r["jparams"]["image_tower"]["conv1"]["kernel"]),
        variables["params"]["image_tower"]["conv1"]["kernel"])


def test_adapter_eval_step_matches_jax():
    """Eval loss and sigmoid probabilities [4, 16]: 1e-5 absolute."""
    b = _batch(13)
    jstate, _, jeval = _jax_steps()
    want = jeval(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, _, eval_step = _port_steps()
    got = eval_step(state, _port_batch(b))
    assert got["probs"].shape == (4, 16)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-5,
                               rtol=0)


def test_bce_with_logits_matches_jax_and_torch():
    """fp32 from bf16 logits, large magnitudes included: 1e-6 against the
    JAX form, 1e-6 against torch's BCEWithLogitsLoss."""
    rng = np.random.default_rng(14)
    logits = (rng.standard_normal((5, 16)) * 30).astype(np.float32)
    targets = (rng.random((5, 16)) < 0.3).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        got = bce_with_logits_loss(torch.from_numpy(logits).bfloat16(),
                                   torch.from_numpy(targets), reduction)
        want = jbce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets), reduction)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(
        bce_with_logits_loss(torch.from_numpy(logits), torch.from_numpy(targets)),
        torch.nn.functional.binary_cross_entropy_with_logits(
            torch.from_numpy(logits), torch.from_numpy(targets)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["shared_adapter"])
def test_unported_adapter_options_raise(case):
    """The shared-embedding adapter's step is ported (its parity with JAX:
    tests/test_torch_multiview.py); what it refuses is an optimizer whose
    groups are not its label_fn's (one built for the C-Adapter)."""
    model = CXRClip(ModelConfig(**TINY))
    opt = make_optimizer(model, make_label_fn(["adapter"]))
    with pytest.raises(ValueError, match="label_fn group"):
        make_shared_adapter_train_step(model, opt, make_label_fn([case]))
    label_fn = make_label_fn([case])
    assert callable(make_shared_adapter_train_step(model, make_optimizer(model, label_fn),
                                                   label_fn))


@pytest.mark.parametrize("trainable", [["adapter"], ["image_projector", "text_projector"], []])
def test_freeze_mask_matches_jax(trainable):
    """``freeze_mask(model, trainable)`` marks the parameters the JAX mask
    marks on the same model."""
    jmodel, variables = _jax_model()
    jmask = freeze_mask(variables["params"], trainable)
    marks = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), jmask,
                         variables["params"])
    want = state_dict_from_jax(marks, variables["batch_stats"])
    got = port_freeze_mask(_port_model(), trainable)
    assert set(got) <= set(want) and any(got.values()) == bool(trainable)
    for name, m in got.items():
        assert bool(want[name].all()) == m and bool(want[name].any()) == m, name


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

FIT_KW = dict(num_epochs=4, scheduler="plateau", plateau_patience=0, plateau_factor=0.5,
              early_stop_patience=1, log_every=1)
TRAIN = [_batch(20), _batch(21)]
VAL = [_batch(22, b=3)]
FIT_LRS = {"adapter": 0.03, "default": 0.0}


@functools.lru_cache(maxsize=None)
def _fits():
    jstate, jstep, jeval = _jax_steps()
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in TRAIN]
    jval = [{k: jnp.asarray(v) for k, v in b.items()} for b in VAL]
    _, jhist = jfit(jstate, jstep, jeval, lambda: iter(jbatches), lambda: iter(jval),
                    base_lrs=FIT_LRS, rng_stream=KeyChain(0).stream("dropout"), **FIT_KW)
    state, step, eval_step = _port_steps()
    batches = [_port_batch(b) for b in TRAIN]
    val = [_port_batch(b) for b in VAL]
    _, hist = fit(state, step, eval_step, lambda: iter(batches), lambda: iter(val),
                  base_lrs=FIT_LRS, rng_stream=itertools.repeat(torch.Generator()), **FIT_KW)
    return jhist, hist


def test_fit_history_matches_jax():
    """The History rows of a plateau-scheduled fit that stops early after 3
    epochs: the same epochs and columns; train and val loss (≈ 0.7) within
    1e-5 (measured ~1e-6), every lr column equal (host arithmetic on the
    same val losses)."""
    jhist, hist = _fits()
    assert hist.columns == list(jhist.to_frame().columns)
    assert [r["epoch"] for r in hist.rows] == [r["epoch"] for r in jhist.rows]
    for got, want in zip(hist.rows, jhist.rows):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0, err_msg=key)
        assert {k: v for k, v in got.items() if k.startswith("lr/")} == {
            k: v for k, v in want.items() if k.startswith("lr/")}


def test_fit_stops_early_at_the_jax_epoch():
    """Patience 1 on a val loss that rises at epoch 2: both stop there, of
    4, and the plateau schedule has halved the adapter's lr."""
    jhist, hist = _fits()
    assert len(hist.rows) == len(jhist.rows) < FIT_KW["num_epochs"]
    assert hist.rows[-1]["lr/adapter"] < FIT_LRS["adapter"]


@pytest.mark.parametrize("scheduler", ["cosine", "none"])
def test_fit_warmup_schedule_and_metric_writer_match_jax(tmp_path, scheduler):
    """Linear warmup over the first 3 steps (of 2 a epoch) under the cosine
    schedule or none, 3 epochs without early stopping: the History rows
    match JAX's (losses 1e-5, lr columns equal) and each package's
    MetricWriter records the same values for every epoch."""
    kw = dict(num_epochs=3, scheduler=scheduler, early_stop_patience=None, warmup_steps=3,
              log_every=1)
    jstate, jstep, jeval = _jax_steps()
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in TRAIN]
    jval = [{k: jnp.asarray(v) for k, v in b.items()} for b in VAL]
    jw = jwriter.MetricWriter(str(tmp_path / "jax"))
    _, jhist = jfit(jstate, jstep, jeval, lambda: iter(jbatches), lambda: iter(jval),
                    base_lrs=FIT_LRS, rng_stream=KeyChain(0).stream("dropout"),
                    metric_writer=jw, **kw)
    jw.close()
    state, step, eval_step = _port_steps()
    batches, val = [_port_batch(b) for b in TRAIN], [_port_batch(b) for b in VAL]
    pw = port_writer.MetricWriter(str(tmp_path / "port"))
    _, hist = fit(state, step, eval_step, lambda: iter(batches), lambda: iter(val),
                  base_lrs=FIT_LRS, rng_stream=itertools.repeat(None), metric_writer=pw, **kw)
    pw.close()
    assert len(hist.rows) == len(jhist.rows) == 3
    got, want = (w.read_jsonl(x.jsonl_path) for w, x in ((port_writer, pw), (jwriter, jw)))
    for rows, jrows in ((hist.rows, jhist.rows), (got, want)):
        assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
        for r, j in zip(rows, jrows):
            for k in r:
                if k.startswith("lr/") or k in ("epoch", "step"):
                    assert r[k] == j[k], k
                elif k in ("train_loss", "val_loss"):
                    np.testing.assert_allclose(r[k], j[k], atol=1e-5, rtol=0, err_msg=k)
    if scheduler == "cosine":
        assert hist.rows[-1]["lr/adapter"] < hist.rows[0]["lr/adapter"]


def test_history_csv_matches_the_jax_frame(tmp_path):
    """``save_csv`` (the csv module) writes the header and values the JAX
    ``save_csv`` (pandas) writes."""
    rows = [dict(epoch=0, train_loss=0.5, val_loss=0.25, **{"lr/adapter": 1e-3}),
            dict(epoch=1, train_loss=0.125, val_loss=1 / 3, **{"lr/adapter": 5e-4})]
    ours, theirs = History(), JHistory()
    for r in rows:
        ours.append(**r)
        theirs.append(**r)
    ours.save_csv(str(tmp_path / "port.csv"))
    theirs.save_csv(str(tmp_path / "jax.csv"))
    read = [list(csv.reader(open(tmp_path / n))) for n in ("port.csv", "jax.csv")]
    assert read[0][0] == read[1][0]
    for a, b in zip(read[0][1:], read[1][1:]):
        assert [float(x) for x in a] == [float(x) for x in b]


def test_run_eval_drops_masked_rows_as_jax_does():
    """Probabilities and labels of the padded tail (mask 0) are dropped; the
    loss is the mean over batches."""
    rng = np.random.default_rng(30)
    batches = [{"labels": rng.random((4, 3)), "mask": np.array([1, 1, 1, 1])},
               {"labels": rng.random((4, 3)), "mask": np.array([1, 0, 1, 0])}]
    probs = [rng.random((4, 3)).astype(np.float32) for _ in batches]
    it = iter(range(2))

    def eval_fn(state, batch):
        i = next(it)
        return {"loss": float(i + 1), "probs": probs[i]}

    want = jrun_eval(eval_fn, None, batches)
    it = iter(range(2))
    got = run_eval(lambda s, b: {k: torch.as_tensor(v) for k, v in eval_fn(s, b).items()},
                   None, [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    assert got["loss"] == want["loss"] == 1.5
    assert got["probs"].shape == (6, 3)
    np.testing.assert_array_equal(got["probs"], want["probs"])
    np.testing.assert_array_equal(got["labels"], want["labels"])


# ---------------------------------------------------------------------------
# checkpoints and preemption
# ---------------------------------------------------------------------------

VAL_LOSSES = [1.0, 0.7, 0.9, 0.7, 0.8, 0.6, 1.2]


def _tiny_state(seed=0):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)))
    opt = make_optimizer(model, make_label_fn([]))
    return TrainState(model, opt)


def _jax_template():
    return JTrainState.create({"params": {"w": jnp.zeros(2)}}, base_transform())


@pytest.mark.parametrize("max_to_keep,best_mode", [(3, "min"), (2, "max"), (1, "min")])
def test_checkpoint_retention_matches_orbax(tmp_path, max_to_keep, best_mode):
    """One val-loss sequence (with a tie) through both managers: the same
    retained epochs, latest and best epoch after every save."""
    jm = JCheckpointManager(str(tmp_path / "jax"), max_to_keep, best_mode=best_mode)
    pm = CheckpointManager(str(tmp_path / "port"), max_to_keep, best_mode=best_mode)
    jstate, state = _jax_template(), _tiny_state()
    for epoch, loss in enumerate(VAL_LOSSES):
        jm.save(epoch, jstate, metrics={"val_loss": loss})
        jm.wait()
        pm.save(epoch, state, metrics={"val_loss": loss})
        pm.wait()
        assert pm.all_epochs() == list(jm.manager.all_steps()), epoch
        assert pm.latest_epoch() == jm.latest_epoch()
        assert pm.best_epoch() == jm.best_epoch()
    jm.close()


def test_checkpoint_restore_is_bit_equal_on_the_template_device(tmp_path):
    """Model, BatchNorm statistics, optimizer moments and step come back
    bit for bit into a fresh template, and a stale epoch is not saved."""
    state = _tiny_state(1)
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(2))
    for _ in range(2):
        state.optimizer.zero_grad()
        state.model.train()(x).square().sum().backward()
        state.optimizer.param_groups[0]["lr"] = 1e-2
        state.optimizer.step()
        state.step += 1
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr.save(4, state, metrics={"val_loss": 0.5})
    mgr.save(3, _tiny_state(9), metrics={"val_loss": 0.1})  # before the latest: skipped
    assert mgr.all_epochs() == [4]
    fresh = _tiny_state(5)
    restored, extra = mgr.restore(fresh)
    assert restored is fresh and extra is None and restored.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    got, want = restored.optimizer.state_dict(), state.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for name, t in s.items():
            assert torch.equal(got["state"][i][name], t), (i, name)
    assert all(t.device == torch.device("cpu") for t in restored.model.state_dict().values())


def test_preempt_slot_and_resume_match_jax(tmp_path):
    """Completed epochs 0-2 under best-k retention, then a mid-epoch save in
    epoch 3: the slot survives retention; resume starts where JAX's does
    without a loader (the next epoch), with a loader to replay (the same
    epoch) and after a completed epoch 3 supersedes the slot."""

    class Loader:
        def __init__(self):
            self.loaded = None

        def load_state_dict(self, s):
            self.loaded = s

    extra = {"mid_epoch": True, "loader": {"epoch": 3, "step": 2}, "num_batches": 4}
    jm = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    pm = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    jstate, state = _jax_template(), _tiny_state(3)
    for epoch, loss in enumerate([0.9, 0.5, 0.7]):
        jm.save(epoch, jstate, metrics={"val_loss": loss})
        pm.save(epoch, state, metrics={"val_loss": loss})
    jm.save_preempt(3, jstate, extra)
    pm.save_preempt(3, state, extra)
    jm.wait()
    pm.wait()
    assert pm.preempt_latest() == jm.preempt_latest() == 3
    assert pm.latest_epoch() == jm.latest_epoch()
    assert resume_or_init(pm, _tiny_state(4))[1] == jresume(jm, _jax_template())[1] == 4
    jl, pl = Loader(), Loader()
    assert resume_or_init(pm, _tiny_state(4), pl)[1] == jresume(jm, _jax_template(), jl)[1] == 3
    assert pl.loaded == jl.loaded == extra["loader"]
    jm.save(3, jstate, metrics={"val_loss": 0.4})
    pm.save(3, state, metrics={"val_loss": 0.4})
    jm.wait()
    pm.wait()
    assert pm.preempt_latest() is jm.preempt_latest() is None
    assert resume_or_init(pm, _tiny_state(4))[1] == jresume(jm, _jax_template())[1] == 4
    jm.close()


def test_fit_saves_the_preempt_slot_when_the_guard_fires(tmp_path):
    """A guard triggered after step 3 of a 2-step-per-epoch fit: epoch 0
    completes and checkpoints, epoch 1 stops after its first step into the
    preemption slot with the loader's cursor; resume restores that state bit
    for bit, at epoch 2 without a loader and at epoch 1 with the cursor
    replayed into one."""

    class Loader:
        def __init__(self):
            self.cursor = {"epoch": 1, "step": 1}

        def state_dict(self):
            return dict(self.cursor)

        def load_state_dict(self, cursor):
            self.cursor = cursor

        def __len__(self):
            return 2

    state, step, eval_step = _port_steps()
    guard = PreemptionGuard(signals=())
    calls = []

    def counted(s, batch, lrs, gen):
        out = step(s, batch, lrs, gen)
        calls.append(1)
        if len(calls) == 3:
            guard.trigger()
        return out

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    batches = [_port_batch(b) for b in TRAIN]
    _, hist = fit(state, counted, eval_step, lambda: iter(batches),
                  lambda: iter([_port_batch(VAL[0])]), base_lrs=LRS, num_epochs=3,
                  rng_stream=itertools.repeat(None), scheduler="none", checkpointer=mgr,
                  preemption_guard=guard, stateful_loader=Loader())
    assert len(hist.rows) == 1 and mgr.all_epochs() == [0] and mgr.preempt_latest() == 1
    restored, start = resume_or_init(mgr, _port_steps()[0])
    assert start == 2 and restored.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    replay = Loader()
    replay.cursor = None
    assert resume_or_init(mgr, _port_steps()[0], replay)[1] == 1
    assert replay.cursor == {"epoch": 1, "step": 1}


def test_restore_variables_loads_weights_only_and_guards_missing_tensors(tmp_path):
    """Phase A → phase B: the weights and BatchNorm statistics load into a
    model with another optimizer; a template tensor the checkpoint lacks is
    an error unless ``allow_partial=True``."""
    state = _tiny_state(6)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state, metrics={"val_loss": 1.0})
    target = _tiny_state(7).model
    assert mgr.restore_variables(target) is target
    for k, v in state.model.state_dict().items():
        assert torch.equal(target.state_dict()[k], v), k
    wider = torch.nn.Sequential(*target, torch.nn.Linear(4, 2))
    with pytest.raises(ValueError, match="lacks"):
        mgr.restore_variables(wider)
    assert mgr.restore_variables(wider, allow_partial=True) is wider
    with pytest.raises(ValueError, match="the EMA slot of checkpoint .* lacks"):
        mgr.restore_variables(target, use_ema=True)


def _ema_state(seed, ema=True):
    """A _tiny_state with the bf16 first moment and an EMA."""
    model = _tiny_state(seed).model
    opt = make_optimizer(model, make_label_fn([]), weight_decay=1e-2,
                         moment_dtype=torch.bfloat16)
    return TrainState.create(model, opt, ema=ema)


def _train(state, steps, seed=0):
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(seed))
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    for _ in range(steps):
        state.optimizer.zero_grad()
        state.model.train()(x).square().sum().backward()
        state.optimizer.param_groups[0]["lr"] = 1e-2
        state.optimizer.step()
        update_ema([state.ema_params[n] for n in names], params, state.step, 0.99)
        state.step += 1
    return state


def test_checkpoint_round_trip_keeps_the_ema_and_bf16_moments(tmp_path):
    """The EMA slot, the bf16 first moments (still bf16) and the rest come
    back bit for bit; a template with an EMA refuses a checkpoint without
    one; a template without one ignores the slot."""
    state = _train(_ema_state(1), 3)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state, metrics={"val_loss": 0.5})
    restored, _ = mgr.restore(_ema_state(2))
    assert restored.step == 3
    for n, e in state.ema_params.items():
        assert torch.equal(restored.ema_params[n], e), n
        assert not torch.equal(e, dict(state.model.named_parameters())[n]), n
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            got, want = restored.optimizer.state[q][k], state.optimizer.state[p][k]
            assert got.dtype == want.dtype == (torch.bfloat16 if k == "exp_avg"
                                               else torch.float32)
            assert torch.equal(got, want), k
    mgr.save(1, _tiny_state(4))
    with pytest.raises(ValueError, match="no EMA"):
        mgr.restore(_ema_state(5), epoch=1)
    assert mgr.restore(_ema_state(5, ema=False), epoch=0)[0].ema_params is None


def test_restore_variables_with_use_ema_gives_the_ema_and_live_batchnorm(tmp_path):
    """The EMA parameters with the checkpoint's live BatchNorm statistics
    (the JAX ``to_variables(use_ema=True)``)."""
    state = _train(_ema_state(6), 4)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state)
    target = _tiny_state(7).model
    assert mgr.restore_variables(target, use_ema=True) is target
    got = target.state_dict()
    for n, e in state.ema_params.items():
        assert torch.equal(got[n], e), n
    for k in ("1.running_mean", "1.running_var", "1.num_batches_tracked"):
        assert torch.equal(got[k], state.model.state_dict()[k]), k


def _pretrain_state():
    cfg = ModelConfig(**dict(TINY, learnable_temperature=True, logit_scale_init=10.0,
                             flash_attention=True))
    model = CXRClip(cfg)
    model.load_state_dict(_port_model().state_dict(), strict=False)
    label_fn = make_label_fn(["image_tower", "text_tower"])
    opt = make_optimizer(model, label_fn, weight_decay=1e-3, moment_dtype=torch.bfloat16)
    step = make_clip_pretrain_step(model, opt, label_fn, "siglip", ema_decay=0.9,
                                   compute_dtype=torch.float32, **STEP_KW)
    return TrainState.create(model, opt, ema=True), step


def _pretrain_batch(seed):
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 1), dtype=np.uint8)),
            "input_ids": torch.from_numpy(rng.integers(5, 64, (4, 12)).astype(np.int64)),
            "attention_mask": torch.ones(4, 12, dtype=torch.int64)}


def test_mid_epoch_resume_continues_bit_equal(tmp_path):
    """The siglip step with a learnable scale, an EMA and bf16 moments: two
    steps, a preemption save, a restore into a fresh state and two more
    steps give the model, EMA, optimizer state and step of four
    uninterrupted steps, bit for bit."""
    lrs = {"image_tower": 1e-3, "text_tower": 1e-3, "default": 1e-2}
    batches = [_pretrain_batch(30 + i) for i in range(4)]
    straight, step = _pretrain_state()
    for b in batches:
        step(straight, b, lrs)
    first, step = _pretrain_state()
    for b in batches[:2]:
        step(first, b, lrs)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save_preempt(0, first, {"mid_epoch": True, "loader": {"epoch": 0, "step": 2},
                                "num_batches": 4})
    resumed, step = _pretrain_state()
    with torch.no_grad():
        for p in resumed.model.parameters():
            p.add_(1.0)  # the restore must overwrite everything
    resumed, _ = mgr.restore_preempt(resumed)
    assert resumed.step == 2
    for b in batches[2:]:
        step(resumed, b, lrs)
    assert resumed.step == straight.step == 4
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for n, e in straight.ema_params.items():
        assert torch.equal(resumed.ema_params[n], e), n
    got, want = resumed.optimizer.state_dict(), straight.optimizer.state_dict()
    for i, s in want["state"].items():
        for name, t in s.items():
            assert t.dtype == got["state"][i][name].dtype, (i, name)
            assert torch.equal(got["state"][i][name], t), (i, name)


def test_checkpoint_names_ignore_the_cast_parametrization(tmp_path):
    """A checkpoint of a model trained under ``cast_in_forward`` (fp32
    masters behind a parametrization) loads into a plain model: stored names
    are the reference's."""
    from clip_for_dl_tpu_torch.core.device import cast_in_forward

    state = _tiny_state(8)
    cast_in_forward(state.model, torch.bfloat16)
    assert "0.parametrizations.weight.original" in state.model.state_dict()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state)
    plain = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    mgr.restore_variables(plain)
    assert torch.equal(plain[0].weight, state.model[0].parametrizations.weight.original)


def test_import_reference_checkpoint_equals_state_dict_from_jax(tmp_path):
    """A ``.pth`` written by the JAX ``save_reference_checkpoint`` maps onto
    the port's names with the values ``state_dict_from_jax`` gives, and
    loads into ``CXRClip`` with only the shared adapter (not in the
    reference's file) left out; its ``.safetensors`` mirror imports to the
    same tensors."""
    _, variables = _jax_model()
    path = save_reference_checkpoint(variables, str(tmp_path / "ref.pth"), epoch=5,
                                     text_layers=TINY["text_layers"])
    out = import_reference_checkpoint(path)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert out["epoch"] == 5
    assert set(out["state_dict"]) == {k for k in want if not k.startswith("shared_adapter.")}
    for k, v in out["state_dict"].items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    model = CXRClip(ModelConfig(**TINY))
    missing, unexpected = model.load_state_dict(out["state_dict"], strict=False)
    assert not unexpected and all(k.startswith("shared_adapter.") for k in missing)
    # the flat .safetensors mirror of the same file gives the same weights
    from clip_for_dl_tpu.models.safetensors_io import save_reference_checkpoint_safetensors

    mirror = import_reference_checkpoint(save_reference_checkpoint_safetensors(
        variables, str(tmp_path / "ref.safetensors"), epoch=5,
        text_layers=TINY["text_layers"]))
    assert mirror["epoch"] == 5 and mirror["state_dict"].keys() == out["state_dict"].keys()
    for k, v in mirror["state_dict"].items():
        assert torch.equal(v.reshape(out["state_dict"][k].shape), out["state_dict"][k]), k


# ---------------------------------------------------------------------------
# the copied framework-neutral modules
# ---------------------------------------------------------------------------


def _defined(module):
    return sorted(n for n, o in vars(module).items()
                  if (inspect.isfunction(o) or inspect.isclass(o))
                  and o.__module__ == module.__name__)


@pytest.mark.parametrize("port,original", [(port_metrics, jmetrics),
                                           (port_writer, jwriter),
                                           (port_preemption, jpreemption)],
                         ids=["metrics", "writer", "preemption"])
def test_copied_modules_equal_originals(port, original):
    """Every function and class of the copy has its original's source text."""
    names = _defined(original)
    assert names and _defined(port) == names
    for name in names:
        assert inspect.getsource(getattr(port, name)) == inspect.getsource(
            getattr(original, name)), name


def test_metric_suite_runs_on_adapter_probabilities():
    """``multilabel_metrics`` of the copy gives the original's numbers, a
    finite macro AUROC among them."""
    rng = np.random.default_rng(31)
    labels = (rng.random((40, 16)) < 0.3).astype(np.float32)
    probs = np.clip(labels * 0.3 + rng.random((40, 16)) * 0.7, 0, 1)
    got = port_metrics.multilabel_metrics(probs, labels)
    assert got == jmetrics.multilabel_metrics(probs, labels)
    assert np.isfinite(got["auroc_macro"])
