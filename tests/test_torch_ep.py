"""Routing over the global batch and expert parallelism of the port
(clip_for_dl_tpu_torch/models/moe.py under a group, parallel/ep.py,
``pretrain --ep``) on gloo ranks, against the port's single-process step on
the global batch and against the JAX package (its own tests are
tests/test_moe.py's ``TestExpertParallel``), on the CPU in fp32 with dropout
0.

One launch of four ranks (``clip_for_dl_tpu_torch.testing.ranks``) runs
every case: N = 2 data parallel on the data groups of a 2 x 2 layout (each
pair of ranks a run of its own), the same with the planted fault of
per-rank routing (each rank's own capacity and queue positions), the
pretrain step at ``--ep 2`` on 2 x 2 and at ``--ep 4`` on 1 x 4 (the first
writing a checkpoint), the tensor-parallel step with a MoE tower, and
``sequence_sharded_fn`` over a MoE tower. The model and batch are
tests/test_torch_moe.py's at capacity factor 0.5 (C = 12 for the batch's
62 real tokens, so that some are dropped, and other ones when each half
of the batch routes alone). Bounds: tests/test_torch_moe.py's (a step's
loss 1e-5 relative, each change or gradient 1e-5 of its tensor's largest,
the ResNet's 1e-4), tighter than JAX's own ``atol=1e-3`` on the parameters
after Adam (tests/test_moe.py:254-259); the data-parallel step against
JAX's on a 2-device slice of conftest's 8-device mesh at
tests/test_torch_dp.py's 1e-4; the sequence-sharded forward at the TP
tests' 2e-5.
"""

import ast
import copy
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.models.bert import BertEncoder as JBertEncoder
from clip_for_dl_tpu.parallel import validate_ep as jvalidate_ep
from clip_for_dl_tpu_torch.models import convert
from clip_for_dl_tpu_torch.models.bert import BertEncoder
from clip_for_dl_tpu_torch.models.moe import ExpertShard, SwitchMoEMLP, moe_shares, routing
from clip_for_dl_tpu_torch.parallel import ep
from clip_for_dl_tpu_torch.testing import ranks
from test_torch_moe import assert_delta_close, jax_step, step_case

torch.set_num_threads(1)
jcli = importlib.import_module("clip_for_dl_tpu.cli.main")

FACTOR = 0.5
WIDE = 4.0  # capacity factor E for E = 4 experts: C = T, no token dropped
BERT = dict(vocab_size=64, hidden=16, layers=2, heads=4, intermediate=32, max_position=16,
            moe_experts=4, moe_capacity_factor=FACTOR)
ADAM_LRS = {"image_tower": 1e-4, "text_tower": 1e-3, "image_projector": 1e-3,
            "text_projector": 1e-3, "default": 1e-4}


def _ep_case(e, **kw):
    case = step_case("pretrain", FACTOR)
    return dict(case, kind="ep_step", ep=e, weight_decay=1e-3, lrs=ADAM_LRS, **kw)


def _bert_params():
    shapes = jax.eval_shape(JBertEncoder(**_jax_bert()).init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(5)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                        shapes["params"])


def _jax_bert():
    return dict(BERT, moe_every=2)


def _bert_inputs():
    rng = np.random.default_rng(7)
    mask = np.ones((8, 12), np.int32)
    mask[1, 7:] = mask[5, 3:] = mask[6, 9:] = 0
    return {"ids": rng.integers(0, 64, (8, 12)).astype(np.int32), "mask": mask}


def _cases(workdir):
    state = {k[2:]: v.numpy() for k, v in convert._bert(_bert_params(), "t").items()}
    cases = {
        "dp": dict(step_case("pretrain", FACTOR), kind="moe_dp"),
        "dp_local": dict(step_case("pretrain", FACTOR), kind="moe_dp", local_routing=True),
        "ep2": _ep_case(2, dir=str(workdir / "ep2_ckpt")),
        "ep4": _ep_case(4),
        "tp2": _tp_case(),
    }
    cases["cli_ep2"] = dict(kind="cli", no_dropout=True, argv=_cli_argv(workdir / "cli_ep2") + [
        "--virtual-devices", "4", "--num-devices", "4", "--ep", "2"])
    # four processes, each loading its data index's strided shard: the
    # global batch holds the single run's rows in another order, so the
    # capacity keeps every token (routing then ignores the order)
    cases["cli_ep2_procs"] = dict(
        kind="cli", no_dropout=True, moe_capacity_factor=WIDE,
        argv=_cli_argv(workdir / "cli_ep2_procs") + ["--num-processes", "4", "--ep", "2"])
    for t, tp_params in ((2, False), (4, True)):
        cases[f"sp{t}"] = dict(kind="sp", tower="bert", config=BERT, state=state,
                               inputs=_bert_inputs(), tp=t, tp_params=tp_params)
    return cases


def _cli_argv(out):
    """``pretrain --tiny --fp32 --moe-experts 4``: one step of 4 synthetic
    pairs, a validation batch, a checkpoint and a history under ``out``."""
    return ["pretrain", "--tiny", "--fp32", "--synthetic", "--synthetic-samples", "8",
            "--batch-size", "4", "--epochs", "1", "--moe-experts", "4", "--checkpoint-dir",
            str(out / "ckpt"), "--log-dir", str(out / "logs")]


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    work = tmp_path_factory.mktemp("ep_ranks")
    return work, ranks.launch(_cases(work), 4, str(work))


# -- routing over the global batch ----------------------------------------------------


def test_data_parallel_moe_step_equals_one_process_and_jax(rank_results):
    """N = 2 ranks (both pairs) against the single-process step on the
    global batch (1e-5) and JAX's step over a 2-device mesh (1e-4)."""
    _, out = rank_results
    losses, _, delta = ranks.step_case(step_case("pretrain", FACTOR))
    jloss, jdelta = jax_step("pretrain", FACTOR, 2)
    for r in range(4):
        got = out[r]["dp"]
        assert got["losses"][0] == pytest.approx(losses[0], rel=1e-5)
        assert got["losses"][0] == pytest.approx(jloss, rel=1e-5)
        assert_delta_close(got["delta"], delta, 1e-5, f"rank {r}")
        assert_delta_close(got["delta"], jdelta, 1e-4, f"rank {r} vs JAX")


def test_per_rank_routing_is_a_fault_the_comparison_finds(rank_results):
    """The planted fault (each rank routes its own rows with its own
    capacity and positions) drops other tokens than the global batch's
    routing, and the comparison above fails on it."""
    _, out = rank_results
    losses, _, delta = ranks.step_case(step_case("pretrain", FACTOR))
    got = out[0]["dp_local"]
    with pytest.raises(AssertionError):
        assert got["losses"][0] == pytest.approx(losses[0], rel=1e-5)
        assert_delta_close(got["delta"], delta, 1e-5, "local routing")


# -- expert parallelism -----------------------------------------------------------------


def _reference():
    return ranks._ep_case(_ep_case(1))


def _whole(out, name, e):
    """A gradient or tensor of the whole model from the ranks of data slice
    0: an expert shard concatenated in expert order, else rank 0's."""
    if ep.ep_spec(name).dim is None:
        return out[0][name]
    return np.concatenate([out[r][name] for r in range(e)])


@pytest.mark.parametrize("e", [2, 4])
def test_expert_parallel_step_equals_one_process(e, rank_results):
    """``--ep 2`` (2 x 2) and ``--ep 4`` (1 x 4): the loss on every rank
    and every clipped gradient before the update (the expert shards put
    together) against the single-process step at 1e-5 of each tensor's
    largest (the ResNet's 1e-4); each rank holds E/ep experts."""
    _, out = rank_results
    ref = _reference()
    runs = [o[f"ep{e}"] for o in out]
    assert [r["expert_index"] for r in runs] == [r % e for r in range(4)]
    for r in runs:
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert r["grads"]["text_tower.encoder.layer.1.moe_mlp.wi"].shape[0] == 4 // e
    grads = {n: _whole([r["grads"] for r in runs], n, e) for n in ref["grads"]}
    assert_delta_close(grads, ref["grads"], 1e-5, f"ep {e}")


def test_expert_parallel_checkpoint_is_whole(rank_results):
    """The ``--ep 2`` run's checkpoint holds the unsharded layout: every
    tensor of the plain model, the experts the ranks' shards put together,
    the AdamW moments whole; the ranks hold their shards again after."""
    work, out = rank_results
    runs = [o["ep2"] for o in out]
    saved = torch.load(str(work / "ep2_ckpt" / "0.pt"), weights_only=False)
    ref = _reference()
    assert set(saved["model"]) == set(ref["state"])
    for name, t in saved["model"].items():
        np.testing.assert_array_equal(t.numpy(), _whole([r["state"] for r in runs], name, 2),
                                      err_msg=name)
        assert tuple(t.shape) == ref["state"][name].shape
    for r in runs:
        for name, t in r["after_save"].items():
            np.testing.assert_array_equal(t, r["state"][name])
    shapes = {tuple(v.shape) for s in saved["optimizer"]["state"].values()
              for v in s.values() if torch.is_tensor(v) and v.dim() == 3}
    assert (4, 64, 128) in shapes and (2, 64, 128) not in shapes


def test_ep_shares_sum_to_the_unsharded_layer_bit_for_bit():
    """Every ep share of a MoE layer (2 and 4 of 4 experts) in one
    process, summed: the unsharded forward, aux loss and every gradient
    bit for bit (each token has one contributor)."""
    torch.manual_seed(0)
    layer = SwitchMoEMLP(16, 32, 4, FACTOR)
    with torch.no_grad():
        layer.bi.normal_()
        layer.bo.normal_()
    x = torch.randn(3, 10, 16)
    mask = torch.ones(3, 10)
    mask[1, 6:] = 0

    def run(shares):
        xt = x.clone().requires_grad_()
        with routing() as aux:
            y = moe_shares(shares, xt, mask)
        (y.square().sum() + aux[0]).backward()
        return y.detach(), aux[0].detach(), xt.grad

    want = run([layer])
    for e in (2, 4):
        shares = [ep.shard_experts_(copy.deepcopy(layer), ExpertShard(k, e)) for k in range(e)]
        got = run(shares)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(shares[0].router.weight.grad, layer.router.weight.grad)
        for k in ("wi", "bi", "wo", "bo"):
            assert torch.equal(torch.cat([getattr(s, k).grad for s in shares]),
                               getattr(layer, k).grad), (e, k)


def test_ep_spec_and_validate_ep_equal_jax():
    """The expert rule shards exactly the stacked wi/bi/wo/bo (the router
    and every other tensor replicated, as JAX's ``ep_spec``); validate_ep
    raises where JAX's does, with its message."""
    names = [n for n, _ in BertEncoder(**BERT).named_parameters()]
    sharded = sorted(n for n in names if ep.ep_spec(n).dim is not None)
    assert sharded == [f"encoder.layer.1.moe_mlp.{k}" for k in ("bi", "bo", "wi", "wo")]
    assert ep.ep_spec("t.encoder.layer.1.moe_mlp.parametrizations.wi.original").dim == 0
    for n_experts, e in ((8, 4), (6, 4), (4, 0), (4, 4)):
        try:
            jvalidate_ep(n_experts, e)
            want = None
        except ValueError as err:
            want = str(err)
        try:
            ep.validate_ep(n_experts, e)
            got = None
        except ValueError as err:
            got = str(err)
        assert got == want


def test_pretrain_ep_command_equals_one_process(rank_results, monkeypatch):
    """``pretrain --num-devices 4 --ep 2 --moe-experts 4`` (the command's
    own (data, expert) layout, feed, sharded state and collective save, on
    the four ranks) against the same command in one process, dropout 0 in
    both: the first step's loss at 1e-5 relative, the validation loss
    after it at 5e-4 (see below); the checkpoint whole (the unsharded names and shapes), each AdamW
    moment at 1e-5 of its tensor's largest, each parameter within 2 · lr of
    its group (Adam's first update g / (|g| + eps) flips sign where g is
    near zero, tests/test_torch_train.py:202), the BatchNorm statistics at
    1e-5."""
    work, out = rank_results
    assert [o["cli_ep2"]["rc"] for o in out] == [0, 0, 0, 0]
    _single_run(work / "single", monkeypatch)
    _assert_same_run(work, "cli_ep2", "single")


def test_pretrain_ep_over_processes_equals_one_process(rank_results, monkeypatch):
    """``pretrain --num-processes 4 --ep 2 --moe-experts 4``: each process
    loads the shard of its data index (process // 2), the two ranks of an
    expert group the same rows; against the command in one process, at the
    bounds above, at a capacity that keeps every token (the strided shards
    put the global batch's rows in another order)."""
    work, out = rank_results
    assert [o["cli_ep2_procs"]["rc"] for o in out] == [0, 0, 0, 0]
    _single_run(work / "single_wide", monkeypatch, moe_capacity_factor=WIDE)
    _assert_same_run(work, "cli_ep2_procs", "single_wide")


def _single_run(out, monkeypatch, **model):
    """The command of :func:`_cli_argv` in this process, dropout 0 and the
    ``model`` fields set."""
    import dataclasses

    from clip_for_dl_tpu_torch.core import config

    real = config.get_preset
    monkeypatch.setattr(config, "get_preset", lambda name: real(name).replace(
        model=dataclasses.replace(real(name).model, dropout=0.0, **model)))
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    assert cli.main(_cli_argv(out)) == 0


def _assert_same_run(work, run_dir, single_dir):
    from clip_for_dl_tpu_torch.train import make_label_fn

    def history(run):
        with open(work / run / "logs" / "training_history.csv") as f:
            head, row = f.read().splitlines()
        return dict(zip(head.split(","), map(float, row.split(","))))

    got, want = history(run_dir), history(single_dir)
    assert got["train_loss"] == pytest.approx(want["train_loss"], rel=1e-5)
    # after the update: where Adam's first step flips sign the weights move
    # by 2 · lr (tests/test_torch_cli.py's 5e-4 on losses after AdamW steps)
    assert got["val_loss"] == pytest.approx(want["val_loss"], abs=5e-4)
    ep_ck, one_ck = (torch.load(str(work / run / "ckpt" / "0.pt"), weights_only=False)
                     for run in (run_dir, single_dir))
    assert {k: v.shape for k, v in ep_ck["model"].items()} == {
        k: v.shape for k, v in one_ck["model"].items()}
    assert ep_ck["model"]["text_tower.encoder.layer.1.moe_mlp.wi"].shape[0] == 4
    groups = one_ck["optimizer"]["param_groups"]
    lrs = {g["label"]: g["lr"] for g in groups}
    label_fn = make_label_fn([g for g in lrs if g != "default"])
    for name, w in one_ck["model"].items():
        g = ep_ck["model"][name].double()
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            np.testing.assert_allclose(g, w.double(), atol=1e-5, rtol=0, err_msg=name)
        else:
            lr = lrs[label_fn(tuple(name.split(".")))]
            assert float((g - w.double()).abs().max()) <= 2 * lr, name
    assert [g["params"] for g in ep_ck["optimizer"]["param_groups"]] == [
        g["params"] for g in groups]
    label_of = {i: g["label"] for g in groups for i in g["params"]}
    state = one_ck["optimizer"]["state"]
    largest = {}
    for i, m in state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            key = (label_of[i], k)
            largest[key] = max(largest.get(key, 0.0), float(m[k].abs().max()))
    for i, moments in state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            w, g = moments[k], ep_ck["optimizer"]["state"][i][k]
            assert g.shape == w.shape, (i, k)
            np.testing.assert_allclose(g, w, atol=1e-4 * largest[label_of[i], k] + 1e-30,
                                       rtol=0, err_msg=f"{i} {k}")


# -- composition with tensor and sequence parallelism ------------------------------------


def test_tp_step_with_a_moe_tower_equals_one_process(rank_results):
    """The tensor-parallel step (tp 2 on 2 x 2): the MoE, replicated, runs
    once a rank; the loss and the MoE's gradients on every rank equal the
    unsharded step's at 1e-5 of each tensor's largest."""
    _, out = rank_results
    ref = ranks._tp_step_case(dict(_tp_case(), plain=True))
    moe = [n for n in ref["grads"] if "moe_mlp" in n]
    assert moe
    for o in out:
        got = o["tp2"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert_delta_close({n: got["grads"][n] for n in moe},
                           {n: ref["grads"][n] for n in moe}, 1e-5, "tp moe")


def _tp_case():
    return dict(_ep_case(1), kind="tp_step", tp=2, groups=list(ADAM_LRS)[:4],
                seeds=[np.zeros((8, 1), np.int32)] * 2)


@pytest.mark.parametrize("t", [2, 4])
def test_sequence_sharded_moe_tower_matches_jax(t, rank_results):
    """``sequence_sharded_fn`` over a MoE tower (2 x 2 with the weights
    replicated, 1 x 4 tensor-parallel): the MoE routes the gathered
    sequence over the data group in the global batch's order, so the
    output is JAX's unsharded forward at 2e-5."""
    _, out = rank_results
    inputs = _bert_inputs()
    want = jax.jit(JBertEncoder(**_jax_bert()).apply)({"params": _bert_params()},
                                                      jnp.asarray(inputs["ids"]),
                                                      jnp.asarray(inputs["mask"]))
    for o in out:
        np.testing.assert_allclose(o[f"sp{t}"]["out"], np.asarray(want), atol=2e-5, rtol=0)


# -- the command line --------------------------------------------------------------------


def _jax_ep_refusals(n, ep_deg, bs):
    """The messages of the JAX ``pretrain --ep`` branch's SystemExit raises,
    rendered with ``n``, ``ep_deg`` and ``bs``."""
    tree = ast.parse(inspect.getsource(jcli.cmd_pretrain).lstrip())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "SystemExit"
                and node.args):
            src = ast.unparse(node.args[0])
            if "ep_deg" in src or "--ep requires" in src:
                out.append(eval(compile(ast.Expression(node.args[0]), "jax", "eval"), {},
                                dict(n=n, ep_deg=ep_deg, bs=bs)))
    return out


REFUSALS = [
    (["--ep", "2"], "--ep requires --moe-experts"),
    (["--ep", "3", "--moe-experts", "4"], "--num-devices 4 must divide into --ep 3"),
    (["--ep", "4", "--moe-experts", "6"], "ep=4 must divide the expert count (6)"),
    (["--ep", "2", "--moe-experts", "4", "--batch-size", "3"],
     "batch size 3 must divide over the data axis (2)"),
]


@pytest.mark.parametrize("argv,want", REFUSALS)
def test_ep_refusals_are_jax_messages(argv, want, monkeypatch):
    """``--ep requires --moe-experts``; --num-devices not divisible by
    --ep; validate_ep; a batch that does not divide over the data axis:
    each refused before any rank starts, with the JAX CLI's message (its
    raises in the ``--ep`` branch, rendered; validate_ep's own); ``--pp``
    with ``--moe-experts`` is refused with the JAX CLI's message."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    with pytest.raises(SystemExit) as err:
        cli.main(["pretrain", "--tiny", "--fp32", "--synthetic", "--virtual-devices", "4",
                  "--num-devices", "4", *argv])
    assert str(err.value) == want
    e = int(argv[1])
    with pytest.raises(ValueError) as jerr:
        jvalidate_ep(6, 4)
    assert want in _jax_ep_refusals(4, e, 3) + [str(jerr.value)]
    with pytest.raises(SystemExit) as err:
        cli.main(["pretrain", "--tiny", "--pp", "2", "--moe-experts", "4"])
    assert str(err.value) == "--pp does not compose with --moe-experts"
