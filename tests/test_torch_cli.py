"""The port's command line against the JAX CLI, on the CPU, in the CLI's
tiny geometry and fp32, under ``CLIP_FOR_DL_TPU_FORCE_CPU``.

One miniature Kaggle layout (``testing/kaggle.py``) serves the module: the
port's and the JAX CLI's ``prep`` and ``cache-images`` must agree on it,
then both CLIs score one reference ``.pth`` that the JAX package writes
from seeded flax variables. The port's chain ``pretrain → adapter →
convert`` is read back by the JAX package, and so is its chain with the
A3b options (``pretrain --loss siglip --learnable-temperature --ema-decay
--bf16-moments`` → ``eval --use-ema`` → ``convert --use-ema``), and its
``train`` in both presets and ``shared-adapter``. Tolerances are stated per
test.
"""

import argparse
import contextlib
import csv
import dataclasses
import importlib
import io
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.torch_export import save_reference_checkpoint as jsave_reference
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.train.checkpoint import (
    import_reference_checkpoint as jimport_reference_checkpoint,
)
from clip_for_dl_tpu.utils.visualization import save_predictions_csv as jsave_predictions_csv
from clip_for_dl_tpu.zeroshot.engine import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.train.checkpoint import model_state, save_reference_checkpoint
from clip_for_dl_tpu_torch.utils import save_predictions_csv
from clip_for_dl_tpu_torch.zeroshot import prompts_for_family
from clip_for_dl_tpu_torch.zeroshot.engine import ZeroShotEngine

# the modules (the packages' ``main`` attribute is the function)
jcli = importlib.import_module("clip_for_dl_tpu.cli.main")
cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")

torch.set_num_threads(1)

TOL = 1e-4  # probabilities and printed metrics, port vs JAX, fp32


def run(main, argv):
    """(exit status, standard output) of ``main(argv)`` in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def printed_json(stdout: str):
    """The JSON object a command printed last (metrics, thresholds)."""
    start = stdout.rindex("\n{\n") + 1 if "\n{\n" in stdout else stdout.index("{")
    return json.loads(stdout[start:stdout.rindex("}") + 1])


def read_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def force_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
        yield


@pytest.fixture(scope="module")
def layout(tmp_path_factory, force_cpu):
    """40 exams of grey PNGs (64 × 64 and 72 × 60), one with a single view,
    one file that is not a PNG, some empty findings; both CLIs' ``prep`` and
    ``cache-images`` outputs."""
    root = str(tmp_path_factory.mktemp("cli"))
    paths = write_kaggle_layout(os.path.join(root, "kaggle"), 40, sizes=((64, 64), (72, 60)),
                                empty_findings_every=7, single_view_uids=(3,),
                                not_png_uids=(9,))
    out = {"root": root, **paths}
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        d = os.path.join(root, tag)
        os.makedirs(d)
        labeled, unlabeled = os.path.join(d, "labeled.csv"), os.path.join(d, "unlabeled.csv")
        assert run(main, ["prep", "--reports", paths["reports"], "--out", labeled,
                          "--unlabeled-out", unlabeled])[0] == 0
        cache = os.path.join(d, "cache")
        assert run(main, ["cache-images", "--image-dir", paths["image_dir"], "--out", cache,
                          "--image-size", "64", "--workers", "2"])[0] == 0
        out[tag] = {"labeled": labeled, "unlabeled": unlabeled, "cache": cache}
    return out


def data_flags(layout, *extra):
    return ["--tiny", "--fp32", "--reports-csv", layout["port"]["labeled"],
            "--projections-csv", layout["projections"], "--image-dir", layout["image_dir"],
            "--image-cache", layout["port"]["cache"], "--batch-size", "4", *extra]


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
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


def tiny_jax_config():
    from clip_for_dl_tpu.core.config import get_preset

    vocab = build_dev_vocab(DISEASE_LABELS)
    return jcli._apply_tiny(get_preset("zero_shot"), argparse.Namespace(tiny=True), len(vocab))


@pytest.fixture(scope="module")
def jax_pth(layout):
    """A reference .pth the JAX package writes from seeded flax variables
    at the CLI's tiny geometry, and those variables."""
    cfg = tiny_jax_config().model
    model = JCXRClip(cfg)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
                            jnp.zeros((1, cfg.max_text_length), jnp.int32))
    rng = np.random.default_rng(13)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    path = os.path.join(layout["root"], "jax_model.pth")
    jsave_reference(variables, path, epoch=3, text_layers=cfg.text_layers)
    return path, variables


@contextlib.contextmanager
def recorded_logits(engine_cls, host):
    """Per-view logits of every batch an engine dispatches."""
    got = []
    original = engine_cls._dispatch

    def record(self, images):
        out, n = original(self, images)
        got.append(host(out)[:n])
        return out, n

    with mock.patch.object(engine_cls, "_dispatch", record):
        yield got


def both_zeroshot(layout, jax_pth, tmp_path, *extra):
    """Per-view probabilities, stdout and log dir of the port's and the JAX
    CLI's ``zeroshot`` on the JAX-written .pth."""
    out = {}
    for tag, main, engine_cls, host in (
            ("port", cli.main, ZeroShotEngine, lambda t: t.float().cpu().numpy()),
            ("jax", jcli.main, JZeroShotEngine, np.asarray)):
        log = str(tmp_path / tag)
        with recorded_logits(engine_cls, host) as logits:
            rc, stdout = run(main, ["zeroshot", *data_flags(layout, *extra), "--checkpoint",
                                    jax_pth[0], "--log-dir", log])
        assert rc == 0
        probs = 1 / (1 + np.exp(-np.concatenate(logits).astype(np.float64)))
        out[tag] = {"probs": probs, "stdout": stdout, "log": log}
    return out["port"], out["jax"]


def assert_metrics_close(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert_metrics_close(got[k], v, tol)
        else:
            np.testing.assert_allclose(got[k], v, atol=tol, rtol=0, equal_nan=True, err_msg=k)


# -- the parser and the device switch ------------------------------------------


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def test_parser_takes_every_jax_command_and_flag():
    """Every command of the JAX parser is the port's, with every one of its
    option strings and the same defaults; ``--help`` lists the commands."""
    jsub, sub = _subparsers(jcli.build_parser()), _subparsers(cli.build_parser())
    assert list(sub) == list(jsub)
    for name, jsp in jsub.items():
        assert set(sub[name]._option_string_actions) == set(jsp._option_string_actions), name
        for a in jsp._actions:
            if a.dest not in ("help", "fn"):
                mine = next(b for b in sub[name]._actions if b.dest == a.dest)
                assert (mine.default, mine.choices, mine.required) == (
                    a.default, a.choices, a.required), (name, a.dest)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        cli.main(["--help"])
    assert all(name in out.getvalue() for name in jsub)


@pytest.mark.parametrize("flags", [
    ["--remat"], ["--remat", "--remat-policy", "dots"],
    ["--remat", "--remat-policy", "dots_no_batch", "--tiny"], ["--remat-policy", "dots"],
    ["--bf16-attention-probs"], ["--bf16-attention-probs", "--flash-attention", "--remat"],
], ids=lambda v: "_".join(f.strip("-") for f in v))
@pytest.mark.parametrize("command", ["pretrain", "zeroshot", "eval"])
def test_remat_and_bf16_probs_flags_set_the_jax_clis_config(command, flags):
    """``--remat`` (with ``--remat-policy``) and ``--bf16-attention-probs``
    run: the model configuration they give is the JAX CLI's, field for
    field (``--remat`` sets ``remat`` and ``remat_conv``; the policy alone
    sets nothing)."""
    from clip_for_dl_tpu.core.config import get_preset as jget_preset
    from clip_for_dl_tpu_torch.core.config import get_preset

    args = cli.build_parser().parse_args([command, *flags])
    jargs = jcli.build_parser().parse_args([command, *flags])
    assert cli._unported(args) is None
    got = cli._apply_tiny(get_preset(args.preset), args, 99).model
    want = jcli._apply_tiny(jget_preset(jargs.preset), jargs, 99).model
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.remat == got.remat_conv == ("--remat" in flags)
    assert got.bf16_attention_probs == ("--bf16-attention-probs" in flags)


# the JAX CLI's refusals of the data-parallel flags, word for word, and where
# its source holds each (``cmd_pretrain``, ``_maybe_dp``, ``create_mesh``)
LOCAL_LOSS = ("--local-loss requires a dp mesh (--num-devices > 1, or a multi-process run "
              "whose slice has > 1 device)")
ACCUM_TEMPERATURE = ("--learnable-temperature does not compose with --accum-steps (the "
                     "GradCache step caches features at a fixed temperature — the scalars "
                     "would silently train at zero gradient)")


def _jax_sources():
    """(the source of the JAX functions that refuse, the string messages of
    their ``SystemExit`` calls: adjacent literals joined, as Python joins
    them)."""
    import ast
    import inspect

    from clip_for_dl_tpu.core import mesh as jmesh

    source = "".join(inspect.getsource(f) for f in (jcli.cmd_pretrain, jcli._maybe_dp,
                                                     jmesh.create_mesh))
    tree = ast.parse(inspect.getsource(jcli.cmd_pretrain).lstrip())
    messages = {a.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "SystemExit"
                for a in node.args if isinstance(a, ast.Constant)}
    return source, messages


@pytest.mark.parametrize("argv,message", [
    (["pretrain", "--lora", "4", "--num-devices", "2"],
     "--num-devices is not supported with --lora"),
    (["zeroshot", "--num-devices", "2"],
     "requested a 2-device mesh but only 1 devices are visible"),
    (["pretrain", "--virtual-devices", "8", "--num-devices", "3", "--batch-size", "8"],
     "--num-devices 3 must divide the batch size (8)"),
    (["adapter", "--num-processes", "2", "--num-devices", "4"],
     "requested a 4-device mesh but only 2 devices are visible"),
    (["pretrain", "--local-loss"], LOCAL_LOSS),
    (["pretrain", "--local-loss", "--num-devices", "1"], LOCAL_LOSS),
    (["pretrain", "--accum-steps", "2", "--learnable-temperature"], ACCUM_TEMPERATURE),
    (["pretrain", "--accum-steps", "2", "--local-loss", "--virtual-devices", "2",
      "--num-devices", "2"], "--accum-steps does not compose with --local-loss"),
    (["train", "--virtual-devices", "8", "--num-devices", "5"],
     "--num-devices 5 must divide the batch size (32)"),
], ids=lambda v: "_".join(v)[:60] if isinstance(v, list) else None)
def test_data_parallel_refusals_are_the_jax_clis(argv, message, monkeypatch):
    """The data-parallel flags' refusals: the JAX CLI's messages word for
    word (its source formats each), before any rank starts; on the CPU
    without ``--virtual-devices`` one device is in sight."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--tiny", "--synthetic"])
    assert e.value.code == message
    source, messages = _jax_sources()
    if "requested a" in message:
        assert '"requested a {num_devices}-device mesh but only "' in source
        assert '"{len(devs)} devices are visible"' in source
    elif "must divide the batch size" in message:
        assert '"--num-devices {n} must divide the batch size ({bs})"' in source
    else:
        assert message in messages


def _jax_pp_messages(n, pp, bs, microbatches):
    """What the JAX package says in ``cmd_pretrain``'s ``--pp`` branch: its
    SystemExit literals and f-strings (rendered with ``n``, ``pp``, ``bs``
    and ``--pp-microbatches``), its ``validate_pp``, and its 2-D mesh over
    no visible device."""
    import argparse
    import ast
    import inspect

    from clip_for_dl_tpu.parallel import validate_pp as jvalidate_pp
    from clip_for_dl_tpu.parallel.common import create_2d_mesh as jmesh

    ns = dict(n=n, pp=pp, bs=bs, args=argparse.Namespace(pp_microbatches=microbatches))
    tree = ast.parse(inspect.getsource(jcli.cmd_pretrain).lstrip())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "SystemExit":
            for a in node.args:
                if isinstance(a, ast.Constant):
                    out.add(a.value)
                elif isinstance(a, ast.JoinedStr) and "pp" in ast.unparse(a):
                    out.add(eval(compile(ast.Expression(a), "jax", "eval"), {}, ns))
    for check in (lambda: jvalidate_pp(2, pp, microbatches, bs),
                  lambda: jmesh(pp, ("data", "stage"), n, devices=[])):
        try:
            check()
        except ValueError as e:
            out.add(str(e))
    return out


FOUR = ["--virtual-devices", "4", "--num-devices", "4"]
FUSED = "--fused-mlp composes with data parallelism only (not --tp/--pp/--ep)"


@pytest.mark.parametrize("argv,message", [
    (["pretrain", "--lora", "4", "--pp", "2"], "--pp does not compose with --lora"),
    (["pretrain", "--pp", "2"], "requested 2 devices, 0 visible"),
    (["pretrain", "--pp", "2", "--moe-experts", "4"], "--pp does not compose with --moe-experts"),
    (["pretrain", "--pp", "2", "--ep", "2", "--moe-experts", "4"],
     "--pp does not compose with --ep"),
    (["pretrain", "--pp", "2", "--ema-decay", "0.9"],
     "--ema-decay does not compose with --pp (the stacked stage layout)"),
    (["pretrain", "--pp", "2", "--local-loss"], LOCAL_LOSS),
    (["pretrain", "--pp", "2", "--local-loss", *FOUR],
     "--local-loss composes with plain --num-devices data parallelism only (not --pp/--ep)"),
    (["pretrain", "--pp", "2", "--accum-steps", "2"],
     "--accum-steps composes with plain dp only (not --pp/--ep)"),
    (["pretrain", "--pp", "2", "--learnable-temperature"],
     "--learnable-temperature does not compose with --pp (the staged step computes the loss "
     "at the fixed temperature)"),
    (["pretrain", "--pp", "2", "--fused-mlp", "--ema-decay", "0.9"], FUSED),
    (["pretrain", "--lora", "4", "--pp", "2", "--fused-mlp"], FUSED),
    (["pretrain", "--pp", "3", *FOUR], "--num-devices 4 must divide into --pp 3"),
    (["pretrain", "--pp", "4", *FOUR], "pp=4 must divide the layer count 2"),
    (["pretrain", "--pp", "2", "--pp-microbatches", "3", "--batch-size", "4", *FOUR],
     "microbatches=3 must divide batch 4"),
    (["pretrain", "--pp", "2", "--batch-size", "6", *FOUR],
     "microbatch size 3 must divide over the data axis (2)"),
], ids=lambda v: "_".join(v)[:60] if isinstance(v, list) else None)
def test_pp_refusals_are_the_jax_clis(argv, message, monkeypatch):
    """``pretrain --pp``'s refusals (the cases test_unported_commands_and_
    flags_exit_2 held while ``--pp`` exited 2, and every other one of the
    JAX CLI's), word for word its messages in its order, before any rank
    starts: each held against the JAX CLI's source (its ``cmd_pretrain``
    and ``_apply_tiny``, its ``validate_pp`` and 2-D mesh). Without a card,
    ``pretrain --pp 2`` reaches the device check."""
    if message.startswith("requested"):
        monkeypatch.delenv("CLIP_FOR_DL_TPU_FORCE_CPU", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    else:
        monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--tiny", "--synthetic"])
    assert e.value.code == message

    def flag(name, default):
        return int(argv[argv.index(name) + 1]) if name in argv else default

    n, pp = flag("--num-devices", flag("--pp", 0)), flag("--pp", 0)
    want = _jax_pp_messages(n, pp, flag("--batch-size", 32), flag("--pp-microbatches", 2))
    assert message in want | _jax_literal_messages(jcli._apply_tiny)


@pytest.mark.parametrize("argv", [
    ["pretrain", "--loss", "clip_self_distill"], ["zeroshot", "--tp", "1"],
    ["zeroshot", "--num-devices", "1", "--prompts", "basic"], ["pretrain", "--pp", "1"],
])
def test_single_device_values_of_those_flags_run(argv, capsys, monkeypatch):
    """The values a single-device run passes are not refused: without a
    card they reach the device check."""
    monkeypatch.delenv("CLIP_FOR_DL_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 1
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["prep", "cache-images", "pretrain", "adapter", "zeroshot",
                                     "eval", "convert", "train", "shared-adapter", "gradcam",
                                     "rollout"])
def test_without_a_card_or_the_switch_every_command_fails(command, tmp_path, capsys,
                                                           monkeypatch):
    """No card and no CLIP_FOR_DL_TPU_FORCE_CPU: a non-zero exit with
    require_cuda's message, and nothing written."""
    monkeypatch.delenv("CLIP_FOR_DL_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    argv = {"prep": ["prep", "--reports", "r.csv", "--out", out],
            "cache-images": ["cache-images", "--image-dir", str(tmp_path), "--out", out],
            "convert": ["convert", "--tiny", "--checkpoint", "m.pth", "--out", out + ".pth"]
            }.get(command, [command, "--tiny", "--synthetic", "--log-dir", out])
    assert cli.main(argv) != 0
    assert "a CUDA GPU is required" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


# -- gradcam and rollout -------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["gradcam", "--sample_index", "1"],
    ["rollout"],
    ["rollout", "--sample_index", "1", "--head-fusion", "min", "--discard-ratio", "0.5"],
], ids=["gradcam", "rollout", "rollout_discard"])
def test_gradcam_and_rollout_write_the_jax_clis_files(argv, tmp_path, force_cpu):
    """``--tiny --synthetic --fp32``: the file names the JAX commands write
    for the sample (gradcam: each positive label's map over both views, or
    class 0's; rollout: both views), read off the JAX package's synthetic
    validation set; the JAX CLI itself runs in the slow tier
    (tests/test_cli.py). ``--discard-ratio`` runs where the JAX command
    raises (ROADMAP C9)."""
    from clip_for_dl_tpu.data import SyntheticMultiViewDataset as JSyntheticMultiViewDataset

    rc, out = run(cli.main, [*argv, "--tiny", "--synthetic", "--fp32", "--synthetic-samples",
                             "8", "--log-dir", str(tmp_path)])
    assert rc == 0, out
    index = int(argv[2]) if "--sample_index" in argv else 0
    views = ("frontal", "lateral")
    if argv[0] == "gradcam":
        labels = JSyntheticMultiViewDataset(2, 64, 1)[index]["labels"]
        positive = [c for c, v in enumerate(labels) if v > 0] or [0]
        want = {f"sample{index}_{DISEASE_LABELS[c].replace(' ', '_')}_{v}.png"
                for c in positive for v in views}
    else:
        want = {f"sample{index}_{v}.png" for v in views}
    assert set(os.listdir(tmp_path / argv[0])) == want
    assert f"wrote {len(want)} " in out


# -- prep and cache-images ----------------------------------------------------------


def test_prep_writes_the_jax_clis_csvs(layout):
    """The labeled and the unlabeled CSV, byte for byte."""
    for name in ("labeled", "unlabeled"):
        with open(layout["port"][name], "rb") as a, open(layout["jax"][name], "rb") as b:
            assert a.read() == b.read(), name


def test_cache_images_writes_the_jax_clis_cache(layout):
    """Every file of the cache directory, byte for byte (grey-packed)."""
    port, jax_dir = layout["port"]["cache"], layout["jax"]["cache"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(port):
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(port, "cache_meta.json")) as f:
        assert json.load(f)["channels"] == 1


# -- zeroshot and eval on one JAX-written .pth -------------------------------------------


def test_zeroshot_matches_the_jax_cli(layout, jax_pth, tmp_path):
    """Per-view probabilities and printed metrics within 1e-4; each exam's
    top-k set equal where both views' k-th and (k+1)-th probabilities lie
    further apart than twice the measured difference."""
    port, want = both_zeroshot(layout, jax_pth, tmp_path)
    assert port["probs"].shape == want["probs"].shape and len(port["probs"]) % 2 == 0
    err = float(np.abs(port["probs"] - want["probs"]).max())
    assert err <= TOL
    assert_metrics_close(printed_json(port["stdout"]), printed_json(want["stdout"]))
    logits = np.log(want["probs"] / (1 - want["probs"]))
    sm = np.exp(logits - logits.max(1, keepdims=True))
    sm = np.sort(sm / sm.sum(1, keepdims=True), axis=1)[:, ::-1]
    decided = (sm[:, 2] - sm[:, 3]).reshape(-1, 2).min(1) > 2 * err
    _, rows = read_rows(os.path.join(port["log"], "zero_shot_results.csv"))
    _, jrows = read_rows(os.path.join(want["log"], "zero_shot_results.csv"))
    assert len(rows) == len(jrows) and len(decided) - len(rows) < 4  # a padded last batch
    decided = decided[:len(rows)]
    assert decided.sum() >= len(decided) // 2
    for r, j, d in zip(rows, jrows, decided):
        if d:
            assert set(r[0].split("; ")) == set(j[0].split("; "))
        assert r[2] == j[2]


def test_zeroshot_dynamic_matches_the_jax_cli(layout, jax_pth, tmp_path):
    """thresholds.json: the same diseases, each threshold within 1e-6 (a
    threshold is a grid point between the calibration scores' extremes, so
    it moves with them, by ~1e-8 here); per-view probabilities and printed
    metrics within 1e-4."""
    port, want = both_zeroshot(layout, jax_pth, tmp_path, "--dynamic")
    assert float(np.abs(port["probs"] - want["probs"]).max()) <= TOL
    with open(os.path.join(port["log"], "thresholds.json")) as f, \
            open(os.path.join(want["log"], "thresholds.json")) as g:
        got, expected = json.load(f), json.load(g)
    assert list(got) == list(expected) == list(DISEASE_LABELS)
    np.testing.assert_allclose(list(got.values()), list(expected.values()), atol=1e-6, rtol=0)
    assert_metrics_close(printed_json(port["stdout"]), printed_json(want["stdout"]))


def both_eval(layout, checkpoint, tmp_path, *extra, jax_checkpoint=None):
    out = {}
    for tag, main, ckpt in (("port", cli.main, checkpoint),
                            ("jax", jcli.main, jax_checkpoint or checkpoint)):
        log = str(tmp_path / tag)
        rc, stdout = run(main, ["eval", *data_flags(layout, *extra), "--checkpoint", ckpt,
                                "--log-dir", log])
        assert rc == 0
        header, rows = read_rows(os.path.join(log, "eval_predictions.csv"))
        out[tag] = {"metrics": printed_json(stdout), "header": header,
                    "values": np.array(rows, np.float64)}
    return out["port"], out["jax"]


@pytest.mark.parametrize("head", ["zeroshot", "adapter"])
def test_eval_matches_the_jax_cli(layout, jax_pth, tmp_path, head):
    """eval_predictions.csv: the header equal, probabilities within 1e-4,
    labels equal; the printed metrics (with --bootstrap's intervals on the
    zero-shot head) within 1e-4."""
    extra = ["--head", head] + (["--bootstrap", "8"] if head == "zeroshot" else [])
    port, want = both_eval(layout, jax_pth[0], tmp_path, *extra)
    assert port["header"] == want["header"]
    assert port["values"].shape == want["values"].shape
    np.testing.assert_allclose(port["values"][:, 0::2], want["values"][:, 0::2], atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(port["values"][:, 1::2], want["values"][:, 1::2])
    assert_metrics_close(port["metrics"], want["metrics"])
    if head == "zeroshot":
        assert set(port["metrics"]) == {"point", "bootstrap_ci_95"}


# -- the port's chain, read by the JAX package --------------------------------------------


@pytest.fixture(scope="module")
def chain(layout, tmp_path_factory):
    """The port's pretrain → adapter → convert (.pth, .safetensors) on the
    layout."""
    root = str(tmp_path_factory.mktemp("chain"))
    logs = os.path.join(root, "logs")
    pre, ad = os.path.join(root, "pretrain"), os.path.join(root, "adapter")
    assert run(cli.main, ["pretrain", *data_flags(layout), "--epochs", "1",
                          "--checkpoint-dir", pre, "--log-dir", logs])[0] == 0
    assert run(cli.main, ["adapter", *data_flags(layout), "--epochs", "1", "--checkpoint", pre,
                          "--checkpoint-dir", ad, "--log-dir", logs])[0] == 0
    out = {"root": root, "logs": logs, "pretrain": pre, "adapter": ad}
    for ext in ("pth", "safetensors"):
        out[ext] = os.path.join(root, f"model.{ext}")
        assert run(cli.main, ["convert", "--tiny", "--checkpoint", ad, "--out",
                              out[ext]])[0] == 0
    return out


def test_the_jax_package_reads_the_ports_chain(layout, chain, tmp_path):
    """The JAX importer reads the same variables from the port's .pth and
    .safetensors; the JAX CLI's eval of the .safetensors (load_trained_model
    on those variables) gives the port's eval of the adapter's checkpoint
    directory, probabilities within 1e-4."""
    a, b = (jimport_reference_checkpoint(chain[ext]) for ext in ("pth", "safetensors"))
    assert a["epoch"] == b["epoch"]
    for tree in ("params", "batch_stats"):
        leaves = jax.tree_util.tree_leaves_with_path(a[tree])
        assert leaves and len(leaves) == len(jax.tree_util.tree_leaves(b[tree]))
        for (path, x), y in zip(leaves, jax.tree_util.tree_leaves(b[tree])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))
    port, want = both_eval(layout, chain["adapter"], tmp_path,
                           jax_checkpoint=chain["safetensors"])
    assert port["header"] == want["header"]
    np.testing.assert_allclose(port["values"], want["values"], atol=TOL, rtol=0)


def test_convert_stamps_the_sources_epoch(chain):
    """The converted files carry the adapter directory's best epoch, and
    their tensors are the directory's, in fp32."""
    from clip_for_dl_tpu_torch.train import CheckpointManager
    from clip_for_dl_tpu_torch.train.checkpoint import import_reference_checkpoint

    best = CheckpointManager(chain["adapter"]).best_epoch()
    saved = torch.load(os.path.join(chain["adapter"], f"{best}.pt"), weights_only=True)["model"]
    for ext in ("pth", "safetensors"):
        got = import_reference_checkpoint(chain[ext])
        assert got["epoch"] == best
        for k, v in got["state_dict"].items():
            assert v.dtype == (torch.float32 if v.is_floating_point() else saved[k].dtype)
            torch.testing.assert_close(v, saved[k].to(v.dtype), rtol=0, atol=0)


def test_pretrain_history_has_the_jax_clis_columns(layout, chain, tmp_path):
    """training_history.csv: the JAX CLI's columns, in its order; one epoch
    of finite losses; the adapter's history and outputs beside it."""
    jlog = str(tmp_path / "jax")
    assert run(jcli.main, ["pretrain", *data_flags(layout), "--epochs", "1",
                           "--log-dir", jlog])[0] == 0
    header, rows = read_rows(os.path.join(chain["logs"], "training_history.csv"))
    assert header == read_rows(os.path.join(jlog, "training_history.csv"))[0]
    assert len(rows) == 1 and np.isfinite(np.array(rows[0], np.float64)).all()
    for name in ("adapter_history.csv", "adapter_predictions.csv", "adapter_metrics.json"):
        assert os.path.exists(os.path.join(chain["logs"], name)), name


# -- train (both presets) and shared-adapter ------------------------------------------------

TRAIN_PRESETS = ("scripts_train", "multimodal_attention")


@pytest.fixture(scope="module")
def train_chain(layout, chain, tmp_path_factory):
    """The port's ``train`` in each preset (one epoch; the multimodal run
    through --device-cache), each directory converted to a .pth; and
    ``shared-adapter`` from the port's pretrain directory, converted too."""
    root = str(tmp_path_factory.mktemp("train"))
    out = {}
    for preset in TRAIN_PRESETS:
        d = os.path.join(root, preset)
        extra = ["--device-cache"] if preset == "multimodal_attention" else []
        rc, stdout = run(cli.main, ["train", "--preset", preset, *data_flags(layout, *extra),
                                    "--epochs", "1", "--checkpoint-dir", os.path.join(d, "ck"),
                                    "--log-dir", os.path.join(d, "logs")])
        assert rc == 0 and "train done: 1 epochs" in stdout
        for ext in ("pth", "safetensors"):
            assert run(cli.main, ["convert", "--tiny", "--preset", preset, "--checkpoint",
                                  os.path.join(d, "ck"), "--out",
                                  os.path.join(d, f"model.{ext}")])[0] == 0
        out[preset] = d
    d = os.path.join(root, "shared")
    rc, stdout = run(cli.main, ["shared-adapter", *data_flags(layout, "--bucket-text"),
                                "--epochs", "1", "--checkpoint", chain["pretrain"],
                                "--checkpoint-dir", os.path.join(d, "ck"),
                                "--log-dir", os.path.join(d, "logs")])
    assert rc == 0 and "shared-adapter done: 1 epochs" in stdout
    out["shared"], out["shared_metrics"] = d, printed_json(stdout)
    return out


@pytest.mark.parametrize("preset", TRAIN_PRESETS)
def test_train_writes_its_history_and_checkpoint(train_chain, preset):
    """training_history.csv with the fit loop's columns and one epoch of
    finite losses at the preset's learning rate (cosine at epoch 0); one
    checkpoint; the cross-modal attention's tensors in it only for the
    multimodal preset."""
    from clip_for_dl_tpu_torch.train import CheckpointManager

    d = train_chain[preset]
    header, rows = read_rows(os.path.join(d, "logs", "training_history.csv"))
    assert header == ["epoch", "train_loss", "val_loss", "epoch_time", "lr/default"]
    assert len(rows) == 1 and np.isfinite(np.array(rows[0], np.float64)).all()
    assert float(rows[0][4]) == pytest.approx(1e-4)
    manager = CheckpointManager(os.path.join(d, "ck"))
    assert manager.all_epochs() == [0]
    saved = torch.load(os.path.join(d, "ck", "0.pt"), weights_only=True)["model"]
    assert any(k.startswith("multimodal_attention.") for k in saved) == (
        preset == "multimodal_attention")


@pytest.mark.parametrize("preset", TRAIN_PRESETS)
def test_the_jax_cli_scores_the_ports_trained_model(layout, train_chain, preset, tmp_path):
    """The JAX importer reads the .pth converted from the port's train
    directory (the cross-modal attention with it, for the multimodal
    preset), and the same tensors from its .safetensors mirror; the JAX
    CLI's ``zeroshot --preset`` on that .pth (the
    multimodal preset: enhanced features, dynamic thresholds) gives the
    port's ``zeroshot`` on the directory: every view's probabilities
    within 1e-4, the printed metrics within 1e-4."""
    d = train_chain[preset]
    params = jimport_reference_checkpoint(os.path.join(d, "model.pth"))["params"]
    assert ("multimodal_attention" in params) == (preset == "multimodal_attention")
    mirror = jimport_reference_checkpoint(os.path.join(d, "model.safetensors"))["params"]
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(jax.tree_util.tree_leaves(mirror))
    for (path, x), y in zip(leaves, jax.tree_util.tree_leaves(mirror)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))
    out = {}
    for tag, main, engine_cls, host, ckpt in (
            ("port", cli.main, ZeroShotEngine, lambda t: t.float().cpu().numpy(),
             os.path.join(d, "ck")),
            ("jax", jcli.main, JZeroShotEngine, np.asarray, os.path.join(d, "model.pth"))):
        with recorded_logits(engine_cls, host) as logits:
            rc, stdout = run(main, ["zeroshot", "--preset", preset, *data_flags(layout),
                                    "--checkpoint", ckpt, "--log-dir", str(tmp_path / tag)])
        assert rc == 0
        out[tag] = (1 / (1 + np.exp(-np.concatenate(logits).astype(np.float64))),
                    printed_json(stdout))
    np.testing.assert_allclose(out["port"][0], out["jax"][0], atol=TOL, rtol=0)
    assert_metrics_close(out["port"][1], out["jax"][1])


def test_train_resumes_from_its_checkpoint_directory(layout, train_chain, tmp_path):
    """``train --epochs 2`` on the directory of a finished epoch resumes at
    epoch 1 (resume_or_init): one more history row, epoch 1 at the cosine
    schedule's epoch-1 rate, and the restored weights moved by its steps."""
    import shutil

    from clip_for_dl_tpu_torch.train import CheckpointManager

    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(train_chain["scripts_train"], "ck"), ck)
    rc, stdout = run(cli.main, ["train", *data_flags(layout), "--epochs", "2",
                                "--checkpoint-dir", ck, "--log-dir", str(tmp_path / "logs")])
    assert rc == 0 and "train done: 1 epochs" in stdout
    header, rows = read_rows(str(tmp_path / "logs" / "training_history.csv"))
    assert len(rows) == 1 and float(rows[0][0]) == 1.0
    # cosine over 2 epochs from 1e-4 to eta_min 1e-6, at epoch 1: half way
    assert float(rows[0][4]) == pytest.approx(1e-6 + (1e-4 - 1e-6) / 2)
    assert CheckpointManager(ck).all_epochs() == [0, 1]
    first, second = (torch.load(os.path.join(ck, f"{e}.pt"), weights_only=True)["model"]
                     for e in (0, 1))
    assert not torch.equal(first["view_fusion.fusion.0.weight"],
                           second["view_fusion.fusion.0.weight"])


@pytest.mark.parametrize("preset", TRAIN_PRESETS)
def test_serve_scores_the_enhanced_features_with_the_multimodal_preset(train_chain, preset,
                                                                       monkeypatch):
    """``serve --preset`` builds its engine with the cross-modal attention
    exactly when the preset has it (the JAX CLI's use_enhance), warms its
    bucket through it and stops at the bind (exit 2)."""
    zeroshot = importlib.import_module("clip_for_dl_tpu_torch.zeroshot")
    serving = importlib.import_module("clip_for_dl_tpu_torch.serving")
    engines = []

    class Recorded(ZeroShotEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    def refuse(*a, **kw):
        raise OSError("the test binds nothing")

    monkeypatch.setattr(zeroshot, "ZeroShotEngine", Recorded)
    monkeypatch.setattr(serving, "create_server", refuse)
    rc = cli.main(["serve", "--preset", preset, "--tiny", "--fp32", "--buckets", "2",
                   "--checkpoint", os.path.join(train_chain[preset], "ck"), "--log-dir",
                   os.path.join(train_chain[preset], "serve")])
    assert rc == 2 and len(engines) == 1
    assert engines[0].use_enhance == (preset == "multimodal_attention")
    assert engines[0].text_features.shape == (16, 64)


def test_shared_adapter_trains_only_its_head_and_writes_the_metrics(train_chain, chain):
    """shared-adapter from the pretrain directory: every tensor but the
    shared adapter's bit-equal to the source checkpoint's, the shared
    adapter moved; its history, predictions and metrics written; the JAX
    package's multilabel_metrics on the predictions CSV's probabilities
    give the printed and saved metrics (1e-6)."""
    from clip_for_dl_tpu.evals.metrics import multilabel_metrics as jmetrics
    from clip_for_dl_tpu_torch.train import CheckpointManager

    src = CheckpointManager(chain["pretrain"])
    before = torch.load(os.path.join(chain["pretrain"], f"{src.best_epoch()}.pt"),
                        weights_only=True)["model"]
    after = torch.load(os.path.join(train_chain["shared"], "ck", "0.pt"),
                       weights_only=True)["model"]
    assert set(after) == set(before)
    for k, v in after.items():
        assert torch.equal(v, before[k]) != k.startswith("shared_adapter."), k
    logs = os.path.join(train_chain["shared"], "logs")
    header, rows = read_rows(os.path.join(logs, "shared_adapter_history.csv"))
    assert header[:3] == ["epoch", "train_loss", "val_loss"] and len(rows) == 1
    header, rows = read_rows(os.path.join(logs, "shared_adapter_predictions.csv"))
    values = np.array(rows, np.float64)
    want = jmetrics(values[:, 0::2], values[:, 1::2], class_names=DISEASE_LABELS)
    with open(os.path.join(logs, "shared_adapter_metrics.json")) as f:
        saved = json.load(f)
    assert_metrics_close(saved, want, tol=1e-6)
    assert train_chain["shared_metrics"] == {k: v for k, v in saved.items()
                                             if not k.startswith("auroc/")}


# -- the A3b options through the command line -------------------------------------------

A3B_FLAGS = ["--loss", "siglip", "--learnable-temperature", "--ema-decay", "0.9",
             "--bf16-moments"]


@pytest.fixture(scope="module")
def a3b_chain(layout, tmp_path_factory):
    """The port's pretrain with the A3b options; eval of its directory with
    and without --use-ema; convert --use-ema to a .pth and eval of that."""
    root = str(tmp_path_factory.mktemp("a3b"))
    pre = os.path.join(root, "pretrain")
    rc, _ = run(cli.main, ["pretrain", *data_flags(layout), *A3B_FLAGS, "--epochs", "1",
                           "--checkpoint-dir", pre, "--log-dir", os.path.join(root, "logs")])
    assert rc == 0
    out = {"root": root, "pretrain": pre, "pth_file": os.path.join(root, "ema.pth")}
    for name, argv in (("ema", [pre, "--use-ema"]), ("live", [pre]), ("pth", [out["pth_file"]])):
        if name == "pth":
            assert run(cli.main, ["convert", "--tiny", "--checkpoint", pre, "--use-ema",
                                  "--out", out["pth_file"]])[0] == 0
        log = os.path.join(root, name)
        rc, stdout = run(cli.main, ["eval", *data_flags(layout), "--checkpoint", *argv,
                                    "--log-dir", log])
        assert rc == 0
        with open(os.path.join(log, "eval_predictions.csv"), "rb") as f:
            out[name] = {"csv": f.read(), "metrics": printed_json(stdout), "log": log}
    return out


def test_a3b_pretrain_writes_the_ema_slot_and_bf16_moments(a3b_chain):
    """The checkpoint holds the EMA slot beside the live weights (the
    calibration scalars in both), the bf16 first moments and fp32 second
    moments; the learned scale stays at or below log 100."""
    from clip_for_dl_tpu_torch.train import CheckpointManager

    best = CheckpointManager(a3b_chain["pretrain"]).best_epoch()
    saved = torch.load(os.path.join(a3b_chain["pretrain"], f"{best}.pt"), weights_only=True)
    assert {"logit_scale", "logit_bias"} <= set(saved["ema"]) <= set(saved["model"])
    assert float(saved["model"]["logit_scale"]) <= np.float32(np.log(100.0))
    assert any(not torch.equal(saved["ema"][k], saved["model"][k]) for k in saved["ema"])
    moments = saved["optimizer"]["state"].values()
    assert moments and all(m["exp_avg"].dtype == torch.bfloat16 and
                           m["exp_avg_sq"].dtype == torch.float32 for m in moments)


def test_eval_and_convert_read_the_ema_slot(a3b_chain):
    """eval --use-ema on the directory and eval of the .pth that convert
    --use-ema wrote: byte-equal eval_predictions.csv and equal metrics; the
    live weights score otherwise."""
    assert a3b_chain["ema"]["csv"] == a3b_chain["pth"]["csv"]
    assert a3b_chain["ema"]["metrics"] == a3b_chain["pth"]["metrics"]
    assert a3b_chain["ema"]["csv"] != a3b_chain["live"]["csv"]


def test_the_jax_cli_scores_the_ports_ema_weights(layout, a3b_chain, tmp_path):
    """The JAX CLI's eval of the converted EMA weights against the port's
    eval --use-ema of the directory: the header and labels equal,
    probabilities and printed metrics within 1e-4."""
    log = str(tmp_path / "jax")
    rc, stdout = run(jcli.main, ["eval", *data_flags(layout), "--checkpoint",
                                 a3b_chain["pth_file"], "--log-dir", log])
    assert rc == 0
    header, rows = read_rows(os.path.join(log, "eval_predictions.csv"))
    got_header, got_rows = read_rows(os.path.join(a3b_chain["ema"]["log"],
                                                  "eval_predictions.csv"))
    assert got_header == header
    want, got = np.array(rows, np.float64), np.array(got_rows, np.float64)
    np.testing.assert_allclose(got[:, 0::2], want[:, 0::2], atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[:, 1::2], want[:, 1::2])
    assert_metrics_close(a3b_chain["ema"]["metrics"], printed_json(stdout))


def test_a3b_pretrain_history_has_the_plain_runs_columns(a3b_chain, chain):
    """training_history.csv of the run with the A3b options: the plain
    run's columns (the JAX CLI's, test_pretrain_history_has_the_jax_clis_columns)
    and one epoch of finite losses."""
    header, rows = read_rows(os.path.join(a3b_chain["root"], "logs", "training_history.csv"))
    assert header == read_rows(os.path.join(chain["logs"], "training_history.csv"))[0]
    assert len(rows) == 1 and np.isfinite(np.array(rows[0], np.float64)).all()


def test_use_ema_on_a_directory_without_the_slot_fails(layout, chain):
    """--use-ema on the plain chain's pretrain directory: the restore raises
    (the JAX CheckpointManager's rule: every parameter of the slot is
    missing), naming the EMA slot."""
    with pytest.raises(ValueError, match="the EMA slot of checkpoint .* lacks"):
        run(cli.main, ["eval", *data_flags(layout), "--checkpoint", chain["pretrain"],
                       "--use-ema", "--log-dir", os.path.join(chain["root"], "no_ema")])


@pytest.mark.parametrize("family", ["rich", "findings"])
def test_report_prompt_families_raise_in_both_clis(layout, family):
    """The JAX CLI calls prompts_for_family without the reports table, so
    --prompts rich|findings raises there; the port's CLI raises the same
    error (the JAX model and engine are stubbed: the error comes first)."""
    argv = ["zeroshot", *data_flags(layout), "--prompts", family]

    class Engine:
        def __init__(self, *a, **kw):
            pass

        def build_text_features(self, prompts):
            raise AssertionError("prompts_for_family did not raise")

    with pytest.raises(ValueError) as want, \
            mock.patch.object(jcli, "_model_and_state", lambda *a, **kw: (None, None)), \
            mock.patch("clip_for_dl_tpu.zeroshot.ZeroShotEngine", Engine):
        jcli.main(argv)
    with pytest.raises(ValueError) as got:
        cli.main(argv)
    assert str(got.value) == str(want.value) == f"{family} prompts need the reports dataframe"


@pytest.mark.parametrize("content", [
    {"Mass": "high"}, {"Mass": 0.5, "Unknown disease": 0.1}, {"Mass": 1.5, "Nodule": -0.1},
    {"Mass": None},
])
def test_serve_thresholds_validation_matches_the_jax_cli(tmp_path, content, capsys):
    """A bad --thresholds file: the same exit status (2) and message as the
    JAX CLI's, before any model is built."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps(content))
    argv = ["serve", "--tiny", "--thresholds", str(path)]
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err
    assert cli.main(argv) == 2
    got = capsys.readouterr().err
    assert got == want and got.startswith("error: --thresholds")


def test_serve_buckets_validation_matches_the_jax_cli(capsys):
    argv = ["serve", "--tiny", "--buckets", "0", "4"]
    assert jcli.main(argv) == cli.main(argv) == 2
    err = capsys.readouterr().err.splitlines()
    assert err == ["error: --buckets entries must be >= 1"] * 2


# -- the pieces the commands write with ---------------------------------------------------


@pytest.mark.parametrize("paths", [False, True])
def test_save_predictions_csv_writes_the_jax_bytes(tmp_path, paths):
    """The csv-module writer gives pandas' bytes for float32 probabilities
    and float32 labels, with and without the image column."""
    rng = np.random.default_rng(5)
    probs = rng.random((9, 16)).astype(np.float32) ** 3
    labels = (rng.random((9, 16)) < 0.3).astype(np.float32)
    col = [f"CXR{i}_IM-0001.png" for i in range(9)] if paths else None
    a = save_predictions_csv(probs, labels, DISEASE_LABELS, str(tmp_path / "p" / "a.csv"), col)
    b = jsave_predictions_csv(probs, labels, DISEASE_LABELS, str(tmp_path / "j" / "b.csv"), col)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_save_reference_checkpoint_writes_the_jax_layout(tmp_path, jax_pth):
    """The port's .pth writer on the port's copy of the JAX variables: the
    JAX writer's epoch, module names, keys, dtypes and tensors."""
    _, variables = jax_pth
    cfg = tiny_jax_config().model
    from clip_for_dl_tpu_torch.core.config import ModelConfig

    model = CXRClip(ModelConfig(**{f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    got = torch.load(save_reference_checkpoint(model_state(model), str(tmp_path / "p.pth"), 3),
                     weights_only=True)
    jsave_reference(variables, str(tmp_path / "j.pth"), epoch=3, text_layers=cfg.text_layers)
    want = torch.load(str(tmp_path / "j.pth"), weights_only=True)
    assert got["epoch"] == want["epoch"] == 3
    assert got["models"].keys() == want["models"].keys()
    for name, sd in want["models"].items():
        assert got["models"][name].keys() == sd.keys(), name
        for k, v in sd.items():
            assert got["models"][name][k].dtype == v.dtype, (name, k)
            torch.testing.assert_close(got["models"][name][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("lengths", [(3, 5), (10, 40), (70, 20), (150, 3), (300, 5)])
def test_encode_bucketed_matches_jax(lengths):
    """The same ids, mask and token types as JAX's on the same texts, at
    every bucket and past the largest (max_length 200)."""
    vocab = build_dev_vocab(DISEASE_LABELS)
    words = sorted(w for w in vocab if w.isalpha())
    rng = np.random.default_rng(sum(lengths))
    texts = [" ".join(rng.choice(words, n)) for n in lengths]
    got = BertTokenizer(vocab).encode_bucketed(texts, max_length=200)
    want = JBertTokenizer(vocab).encode_bucketed(texts, max_length=200)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_day_one_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without --cpu-rehearsal the port's tools/day_one.py needs the card,
    whatever the environment switch says, and writes nothing without it."""
    from clip_for_dl_tpu_torch.tools import day_one

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = tmp_path / "work"
    for switch in (None, "1"):
        if switch is None:
            monkeypatch.delenv("CLIP_FOR_DL_TPU_FORCE_CPU", raising=False)
        else:
            monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", switch)
        with pytest.raises(RuntimeError, match="CUDA GPU is required"):
            day_one.main(["--work", str(work)])
        assert not work.exists()


def test_day_one_rehearsal_runs_the_chain(tmp_path, monkeypatch):
    """The port's tools/day_one.py on its stand-ins (--cpu-rehearsal: --tiny
    --fp32 on the CPU): every stage exits 0 and the report names the
    stand-ins."""
    from clip_for_dl_tpu_torch.tools import day_one

    monkeypatch.delenv("CLIP_FOR_DL_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(day_one, "ASSETS", str(tmp_path / "no_assets"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert day_one.main(["--cpu-rehearsal", "--uids", "16",
                             "--work", str(tmp_path / "work")]) == 0
    text = out.getvalue()
    report = json.loads(next(line for line in text.splitlines() if line.startswith('{"work"')))
    assert report["mode"] == "rehearsal"
    assert report["real"] == {} and set(report["standin"]) == {"images", "vocab", "towers"}
    assert report["cache_channels"] == 1 and text.rstrip().endswith("(all stand-ins — rehearsal)")
    assert all(os.path.getsize(p) > 0 for p in report["converted"])
    prompts = [v[0] for v in prompts_for_family("prediction", DISEASE_LABELS).values()]
    ids = BertTokenizer(report["standin"]["vocab"]).encode(prompts, max_length=32)["input_ids"]
    assert len({tuple(r) for r in ids}) == len(DISEASE_LABELS)  # the vocab holds the prompts


# -- data parallelism (ROADMAP A7) ---------------------------------------------------


def test_pretrain_over_two_virtual_devices_matches_the_jax_cli(layout, jax_pth, tmp_path,
                                                               monkeypatch):
    """``pretrain --virtual-devices 2 --num-devices 2 --tiny --fp32`` from the
    JAX-written .pth, two epochs of synthetic pairs at a global batch of 4:
    the port's two gloo ranks (run by ``testing.ranks``, whose ranks start
    the command in a group) against the JAX CLI's 2-device mesh, both with
    every preset's dropout at 0 (the rate has no flag; the ranks patch the
    port's ``get_preset``, this process the JAX one). The per-epoch train
    and validation losses at 5e-4 (tests/test_torch_train.py's bound on a
    trajectory of AdamW steps); only rank 0 wrote the log, the history and
    the checkpoints."""
    from clip_for_dl_tpu.core import config as jconfig
    from clip_for_dl_tpu_torch.testing import ranks

    argv = ["pretrain", "--tiny", "--fp32", "--synthetic", "--synthetic-samples", "16",
            "--batch-size", "4", "--epochs", "2", "--virtual-devices", "2", "--num-devices",
            "2", "--checkpoint", jax_pth[0]]
    port, jlog = str(tmp_path / "port"), str(tmp_path / "jax")
    out = ranks.launch({"cli": dict(kind="cli", no_dropout=True, argv=argv + [
        "--log-dir", port, "--checkpoint-dir", str(tmp_path / "ckpt")])}, 2,
        str(tmp_path / "ranks"))
    assert [r["cli"]["rc"] for r in out] == [0, 0]
    real = jconfig.get_preset

    def no_dropout(name):
        cfg = real(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))

    monkeypatch.setattr(jconfig, "get_preset", no_dropout)
    assert run(jcli.main, argv + ["--log-dir", jlog])[0] == 0
    header, rows = read_rows(os.path.join(port, "training_history.csv"))
    jheader, jrows = read_rows(os.path.join(jlog, "training_history.csv"))
    assert header == jheader and len(rows) == len(jrows) == 2
    cols = [header.index(c) for c in ("train_loss", "val_loss")]
    np.testing.assert_allclose(np.array(rows, np.float64)[:, cols],
                               np.array(jrows, np.float64)[:, cols], atol=5e-4, rtol=0)
    with open(os.path.join(port, "pretrain.log")) as f:
        assert f.read().count("epoch 1 done") == 1  # one rank's lines
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["0.json", "0.pt", "1.json", "1.pt"]


def test_zeroshot_over_two_virtual_devices_writes_the_single_process_results(layout, jax_pth,
                                                                              tmp_path):
    """``zeroshot --virtual-devices 2 --num-devices 2`` in one launch: the
    command starts two gloo ranks, each scores its slice of every batch, and
    rank 0 writes the CSV of the single-process run (scores at 1e-6) and
    prints its metrics."""
    single, dp = str(tmp_path / "single"), str(tmp_path / "dp")
    flags = ["zeroshot", *data_flags(layout), "--checkpoint", jax_pth[0]]
    assert run(cli.main, flags + ["--log-dir", single])[0] == 0
    assert cli.main(flags + ["--virtual-devices", "2", "--num-devices", "2",
                             "--log-dir", dp]) == 0
    header, rows = read_rows(os.path.join(single, "zero_shot_results.csv"))
    got_header, got = read_rows(os.path.join(dp, "zero_shot_results.csv"))
    assert got_header == header and len(got) == len(rows) > 0
    for a, b in zip(got, rows):
        for x, y in zip(a, b):
            try:
                assert float(x) == pytest.approx(float(y), abs=1e-6)
            except ValueError:
                assert x == y
    assert sorted(os.listdir(dp)) == sorted(os.listdir(single))


# -- tensor parallelism and serving over a group (ROADMAP A7b) -------------------------


def _jax_literal_messages(*functions):
    """The string messages of the ``SystemExit`` calls in the JAX CLI's
    ``functions`` (adjacent literals joined, as Python joins them)."""
    import ast
    import inspect

    out = set()
    for f in functions:
        tree = ast.parse(inspect.getsource(f).lstrip())
        out |= {a.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "SystemExit"
                for a in node.args if isinstance(a, ast.Constant)}
    return out


def _jax_tp_message(argv):
    """What the JAX package says to the TP flags of ``argv`` (``--tiny``:
    2 heads, MLP 128): its ``validate_tp`` on the text tower, or its 2-D
    mesh over ``--num-devices``."""
    from clip_for_dl_tpu.parallel import create_dp_tp_mesh as jmesh
    from clip_for_dl_tpu.parallel import validate_tp as jvalidate

    t, n = int(argv[argv.index("--tp") + 1]), int(argv[argv.index("--num-devices") + 1])
    try:
        jvalidate(2, 128, t)
        jmesh(t, num_devices=n)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"the JAX package takes {argv}")


@pytest.mark.parametrize("argv,message", [
    (["serve", "--exported", "art", "--tp", "2"],
     "--tp does not compose with --exported (the serialized module is a single-device "
     "program)"),
    (["serve", "--head", "adapter", "--tp", "2"], "--tp does not compose with --head adapter"),
    (["zeroshot", "--fused-mlp", "--tp", "2"],
     "--fused-mlp composes with data parallelism only (not --tp/--pp/--ep)"),
    (["serve", "--fused-mlp", "--tp", "2", "--virtual-devices", "2", "--num-devices", "2"],
     "--fused-mlp composes with data parallelism only (not --tp/--pp/--ep)"),
    (["zeroshot", "--tp", "4", "--virtual-devices", "4", "--num-devices", "4"], None),
    (["serve", "--tp", "2", "--virtual-devices", "3", "--num-devices", "3"], None),
], ids=lambda v: "_".join(v)[:60] if isinstance(v, list) else None)
def test_tp_refusals_are_the_jax_clis(argv, message, monkeypatch):
    """``--tp``'s refusals, word for word the JAX CLI's (its ``cmd_serve``
    and ``_apply_tiny`` literals; its ``validate_tp`` and 2-D mesh for the
    degrees), before any rank starts."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--tiny", "--synthetic"])
    if message is None:
        message = _jax_tp_message(argv)
    else:
        assert message in _jax_literal_messages(jcli.cmd_serve, jcli._apply_tiny)
    assert e.value.code == message


def test_zeroshot_tp_over_four_virtual_devices_matches_the_jax_cli(layout, jax_pth, tmp_path):
    """``zeroshot --num-devices 4 --tp 2`` on four gloo ranks (2 x 2, the
    towers tensor-parallel; run by ``testing.ranks``, which records each
    rank's logits) against the JAX CLI's ``--num-devices 4 --tp 2`` on its
    2 x 2 mesh, with test_zeroshot_matches_the_jax_cli's bounds: per-view
    probabilities within TOL on every rank, and the CSV's rows: true labels
    equal, each exam's top-k set equal where
    both views' k-th and (k+1)-th probabilities lie further apart than
    twice the measured difference."""
    from clip_for_dl_tpu_torch.testing import ranks

    flags = ["zeroshot", *data_flags(layout), "--checkpoint", jax_pth[0], "--num-devices",
             "4", "--tp", "2"]
    port, jlog = str(tmp_path / "port"), str(tmp_path / "jax")
    out = ranks.launch({"cli": dict(kind="cli", argv=flags + ["--log-dir", port])}, 4,
                       str(tmp_path / "ranks"))
    assert [r["cli"]["rc"] for r in out] == [0] * 4
    with recorded_logits(JZeroShotEngine, np.asarray) as logits:
        rc, jstdout = run(jcli.main, flags + ["--log-dir", jlog])
    assert rc == 0
    want = 1 / (1 + np.exp(-np.concatenate(logits).astype(np.float64)))
    err = 0.0
    for r in out:
        got = 1 / (1 + np.exp(-r["cli"]["logits"].astype(np.float64)))
        assert got.shape == want.shape
        err = max(err, float(np.abs(got - want).max()))
    assert err <= TOL
    lg = np.log(want / (1 - want))
    sm = np.exp(lg - lg.max(1, keepdims=True))
    sm = np.sort(sm / sm.sum(1, keepdims=True), axis=1)[:, ::-1]
    decided = (sm[:, 2] - sm[:, 3]).reshape(-1, 2).min(1) > 2 * err
    _, rows = read_rows(os.path.join(port, "zero_shot_results.csv"))
    _, jrows = read_rows(os.path.join(jlog, "zero_shot_results.csv"))
    assert len(rows) == len(jrows) > 0
    for r, j, d in zip(rows, jrows, decided):
        if d:
            assert set(r[0].split("; ")) == set(j[0].split("; "))
        assert r[2] == j[2]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jlog))


def test_serve_over_two_ranks_answers_as_one_process_and_stops_both(layout, jax_pth, tmp_path):
    """``serve --virtual-devices 2 --num-devices 2 --tp 2`` as a child: rank
    0 serves, rank 1 follows its batches with its half of the towers; three
    requests (one alone, two together) answer the single-process engine's
    probabilities within 1e-5 (fp32 sums over the two shards); SIGTERM to
    the command stops both ranks (rank 0 broadcasts the stop, rank 1
    reports it) within the wait, and the command exits 0 as one process
    does."""
    import http.client
    import re
    import signal
    import subprocess
    import sys
    import threading
    import time

    from clip_for_dl_tpu_torch.serving import decode_request_image

    pngs = sorted(os.listdir(layout["image_dir"]))
    pngs = [os.path.join(layout["image_dir"], p) for p in pngs if p.endswith(".png")][:3]
    bodies = []
    for p in pngs:
        with open(p, "rb") as f:
            bodies.append(f.read())
    flags = ["serve", "--tiny", "--fp32", "--checkpoint", jax_pth[0], "--buckets", "1", "4"]
    args = cli.build_parser().parse_args(flags)
    args.device = torch.device("cpu")
    tok = cli._tokenizer(args)
    cfg = cli._apply_tiny(cli._preset(args), args, len(tok.vocab))
    engine = cli._live_engine(cfg, args, tok)
    size = cfg.model.image_size
    want = [engine.probs(decode_request_image(b, "image/png", size)[None])[0] for b in bodies]

    env = dict(os.environ, CLIP_FOR_DL_TPU_FORCE_CPU="1", PYTHONUNBUFFERED="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen(
        [sys.executable, "-m", "clip_for_dl_tpu_torch", *flags, "--virtual-devices", "2",
         "--num-devices", "2", "--tp", "2", "--host", "127.0.0.1", "--port", "0",
         "--log-dir", str(tmp_path / "logs")],
        cwd=root, env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
    lines, port = [], []

    def drain():
        for line in child.stderr:
            lines.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port.append(int(m.group(1)))

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 150
        while not port and time.monotonic() < deadline and child.poll() is None:
            time.sleep(0.2)
        assert port, "".join(lines)

        def predict(body):
            conn = http.client.HTTPConnection("127.0.0.1", port[0], timeout=60)
            conn.request("POST", "/predict", body=body, headers={"Content-Type": "image/png"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            conn.close()
            assert resp.status == 200, payload
            return np.array([payload["probs"][d] for d in DISEASE_LABELS])

        got = [predict(bodies[0])]
        pair = [None, None]
        threads = [threading.Thread(target=lambda i=i: pair.__setitem__(i, predict(bodies[i + 1])))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got += pair
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        child.send_signal(signal.SIGTERM)
        child.wait(90)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    reader.join(10)
    text = "".join(lines)
    assert "shutting down" in text, text[-3000:]
    assert re.search(r"rank 1 ran \d+ batches; stopped by rank 0", text), text[-3000:]
    assert child.returncode == 0, text[-3000:]
