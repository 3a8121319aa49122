"""Every command over a process group, on two gloo ranks
(``clip_for_dl_tpu_torch.testing.ranks``), against the same command in one
process: ``eval`` (both heads), ``gradcam``, ``rollout``, ``prep``,
``cache-images`` and ``convert``, on tests/test_torch_cli.py's layout and
JAX-written ``.pth``, the commands that take it with ``--num-processes 2``.

``eval``: every rank loads the whole held-out split and scores its slice of
each batch; the primary writes eval_predictions.csv and prints the metrics:
probabilities and metrics within 1e-5 of one process's, and within
tests/test_torch_cli.py's 1e-4 of the JAX CLI's eval in one process.
``gradcam`` and ``rollout`` draw ``--sample_index`` from the whole split
(the JAX commands index each process's shard); ``prep``, ``cache-images``
and ``convert`` run on the primary alone: their files equal one process's
byte for byte (prep's ``extracted_labels``, a set joined in the order of
the process's string hashes, as a set). Every rank exits 0, and the second opens no file for
writing, so N processes leave one set of files.

The same launch runs the MoE pretrain step (tests/test_torch_moe.py's, at
capacity factor 0.5, so that tokens are dropped) with ``--remat`` over the
two ranks against the step without remat, bit for bit, and with the planted
fault of a recompute outside the forward's context (its MoE layers routing
over one rank's rows): that run departs or raises.
"""

import csv
import os

import numpy as np
import pytest

from clip_for_dl_tpu_torch.testing import ranks
from test_torch_cli import (  # noqa: F401 (module fixtures)
    TOL,
    assert_metrics_close,
    cli,
    data_flags,
    force_cpu,
    jax_pth,
    jcli,
    layout,
    printed_json,
    read_rows,
    run,
)
from test_torch_moe import step_case

GROUP = ["--num-processes", "2"]


def _argvs(layout, checkpoint, out):
    """Each command line, its files under ``out``."""
    def logs(name):
        return ["--log-dir", os.path.join(out, name)]

    return {
        "eval_zeroshot": ["eval", *data_flags(layout, "--bootstrap", "8"), "--checkpoint",
                          checkpoint, *logs("eval_zeroshot")],
        "eval_adapter": ["eval", *data_flags(layout, "--head", "adapter"), "--checkpoint",
                         checkpoint, *logs("eval_adapter")],
        "gradcam": ["gradcam", *data_flags(layout, "--sample_index", "5"), "--checkpoint",
                    checkpoint, *logs("gradcam")],
        "rollout": ["rollout", *data_flags(layout, "--sample_index", "5"), *logs("rollout")],
        "prep": ["prep", "--reports", layout["reports"], "--out",
                 os.path.join(out, "labeled.csv"), "--unlabeled-out",
                 os.path.join(out, "unlabeled.csv")],
        "cache-images": ["cache-images", "--image-dir", layout["image_dir"], "--out",
                         os.path.join(out, "cache"), "--image-size", "64", "--workers", "2"],
        "convert": ["convert", "--tiny", "--checkpoint", checkpoint, "--out",
                    os.path.join(out, "model.safetensors")],
        "convert_pth": ["convert", "--tiny", "--checkpoint", checkpoint, "--out",
                        os.path.join(out, "model.pth")],
    }


def _files(root):
    """{relative path: bytes} of every file under ``root`` but the logs."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".log"):
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def runs(layout, jax_pth, tmp_path_factory):
    """The commands on two ranks (and the MoE remat case), and in this
    process: (the ranks' results, the output roots, this process's
    standard outputs)."""
    work = tmp_path_factory.mktemp("group")
    group, single = str(work / "group"), str(work / "single")
    cases = {name: dict(kind="cli", argv=argv + (GROUP if argv[0] not in (
                            "prep", "cache-images") else []))
             for name, argv in _argvs(layout, jax_pth[0], group).items()}
    cases["moe_remat"] = dict(step_case("pretrain", 0.5), kind="moe_remat", policy="full")
    out = ranks.launch(cases, 2, str(work / "ranks"))
    printed = {}
    for name, argv in _argvs(layout, jax_pth[0], single).items():
        rc, printed[name] = run(cli.main, argv)
        assert rc == 0, name
    return out, group, single, printed


@pytest.mark.parametrize("name", ["eval_zeroshot", "eval_adapter", "gradcam", "rollout",
                                  "prep", "cache-images", "convert"])
def test_every_rank_exits_0_and_only_the_primary_writes(runs, name):
    """(``convert``'s .pth is left out: ``torch.save`` opens its file in
    C++, where the recorder does not see it.)"""
    out, group, _, _ = runs
    assert [o[name]["rc"] for o in out] == [0, 0]
    assert out[1][name]["writes"] == []
    assert any(p.startswith(group) for p in out[0][name]["writes"])


def _labeled_rows(data: bytes) -> list:
    """prep's labeled CSV with each row's ``extracted_labels`` as a set: the
    reference joins a set there, in the order of the process's string hashes
    (PYTHONHASHSEED; tests/test_torch_data_files.py), and the ranks are other
    processes than this one. Every other field byte for byte."""
    rows = list(csv.reader(data.decode().splitlines()))
    i = rows[0].index("extracted_labels")
    return [r[:i] + [frozenset(r[i].split(", "))] + r[i + 1:] for r in rows]


# the files (or directories) each command writes under its root
WRITTEN = {"gradcam": ("gradcam",), "rollout": ("rollout",),
           "prep": ("labeled.csv", "unlabeled.csv"), "cache-images": ("cache",),
           "convert": ("model.safetensors",), "convert_pth": ("model.pth",)}


@pytest.mark.parametrize("name", list(WRITTEN))
def test_files_equal_one_process_byte_for_byte(runs, name):
    """The files, byte for byte (gradcam's and rollout's overlays of the
    whole split's sample 5); what the command printed, on the primary
    alone (cache-images' rate apart)."""
    out, group, single, printed = runs
    got, want = ({k: v for k, v in _files(root).items() if k.split(os.sep)[0] in WRITTEN[name]}
                 for root in (group, single))
    assert want and got.keys() == want.keys()
    for k in want:
        if k == "labeled.csv":
            assert _labeled_rows(got[k]) == _labeled_rows(want[k])
        else:
            assert got[k] == want[k], k
    if name in ("gradcam", "rollout"):
        assert len(want) >= 2 and all(os.path.basename(k).startswith("sample5_") for k in want)
    said, want_said = out[0][name]["stdout"], printed[name].replace(single, group)
    if name == "cache-images":
        said, want_said = said.split(" (")[0], want_said.split(" (")[0]
    assert said == want_said and said
    assert out[1][name]["stdout"] == ""


@pytest.mark.parametrize("head", ["zeroshot", "adapter"])
def test_eval_equals_one_process(runs, head):
    """eval_predictions.csv: the header and labels equal, probabilities
    within 1e-5; the printed metrics within 1e-5, printed by the primary
    alone."""
    out, group, single, printed = runs
    name = f"eval_{head}"
    got_head, got = read_rows(os.path.join(group, name, "eval_predictions.csv"))
    want_head, want = read_rows(os.path.join(single, name, "eval_predictions.csv"))
    got, want = np.array(got, np.float64), np.array(want, np.float64)
    assert got_head == want_head and got.shape == want.shape and len(got) > 4
    np.testing.assert_allclose(got[:, 0::2], want[:, 0::2], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, 1::2], want[:, 1::2])
    assert_metrics_close(printed_json(out[0][name]["stdout"]), printed_json(printed[name]),
                         tol=1e-5)
    assert "{" not in out[1][name]["stdout"]


def test_eval_over_the_group_matches_the_jax_clis_eval(runs, layout, jax_pth, tmp_path):
    """The two ranks' eval (zero-shot head, --bootstrap 8) against the JAX
    CLI's in one process: probabilities and metrics within 1e-4, labels
    equal."""
    out, group, _, _ = runs
    log = str(tmp_path / "jax")
    rc, stdout = run(jcli.main, ["eval", *data_flags(layout, "--bootstrap", "8"),
                                 "--checkpoint", jax_pth[0], "--log-dir", log])
    assert rc == 0
    got_head, got = read_rows(os.path.join(group, "eval_zeroshot", "eval_predictions.csv"))
    want_head, want = read_rows(os.path.join(log, "eval_predictions.csv"))
    got, want = np.array(got, np.float64), np.array(want, np.float64)
    assert got_head == want_head and got.shape == want.shape
    np.testing.assert_allclose(got[:, 0::2], want[:, 0::2], atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[:, 1::2], want[:, 1::2])
    assert_metrics_close(printed_json(out[0]["eval_zeroshot"]["stdout"]),
                         printed_json(stdout))


def test_moe_step_with_remat_over_two_ranks_equals_it_without(runs):
    """The step's loss and every parameter change bit for bit, each rank;
    the planted fault (the recompute routing over one rank's rows) raises
    or departs."""
    out, _, _, _ = runs
    for r in out:
        plain, remat, fault = (r["moe_remat"][k] for k in ("plain", "remat", "fault"))
        assert "error" not in plain and "error" not in remat, (plain, remat)
        assert remat["losses"] == plain["losses"]
        assert remat["delta"].keys() == plain["delta"].keys()
        for k, v in plain["delta"].items():
            np.testing.assert_array_equal(remat["delta"][k], v, err_msg=k)
        assert "error" in fault or any(not np.array_equal(fault["delta"][k], v)
                                       for k, v in plain["delta"].items())
