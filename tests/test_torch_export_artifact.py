"""The port's deployment artifacts (``clip_for_dl_tpu_torch/export.py``,
``tools/export_inference.py``, ``serve --exported``) against the JAX
package's (``clip_for_dl_tpu/export.py``) on the CPU, at a tiny geometry
with seeded numpy weights carried into both packages.

The fold of BatchNorm against JAX's fold; the folded model against the
unfolded one; each of the four programs against the JAX program exported
from the same folded weights and bank (``platforms=("cpu",)``), at b = 1
and at b = 3 (the port's programs are traced at b = 2); the port's
operators in each program's graph; the loaders, the service, the tool and
the command; loading with no model code imported; and every kernel
wrapper on CPU tensors bit-equal to its plain version, gradients included.
"""

import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jex

from clip_for_dl_tpu import export as jexport
from clip_for_dl_tpu.core import config as jconfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.resnet import fold_clip_image_tower as jfold
from clip_for_dl_tpu_torch import export
from clip_for_dl_tpu_torch.core import config
from clip_for_dl_tpu_torch.inference import AdapterEngine
from clip_for_dl_tpu_torch.models import CXRClip, fold_clip_image_tower, state_dict_from_jax
from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.ops import image_prep as prep
from clip_for_dl_tpu_torch.ops import mlp_block as blk
from clip_for_dl_tpu_torch.ops import mlp_train as mlp
from clip_for_dl_tpu_torch.ops import similarity as sim
from clip_for_dl_tpu_torch.serving import ZeroShotService
from clip_for_dl_tpu_torch.testing.png import encode_png
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family
from clip_for_dl_tpu_torch.zeroshot.prompts import create_basic_prompts

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = config.DISEASE_LABELS
MEAN, STD = config.CLIP_MEAN, config.CLIP_STD
SIZE, SOURCE, LENGTH = 32, 48, 16
TINY = dict(
    image_size=SIZE, max_text_length=LENGTH, text_embedding_dim=64, text_layers=1,
    text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64, text_max_position=32,
    resnet_stages=(1, 1, 1, 1), resnet_width=8, flash_attention=True,
)
# each program's bound against the JAX program (fp32 compute, but the
# multi-view scorer's bf16 image prep, as both sessions prep)
PROGRAM_TOL = {"multiview": 2e-6, "singleview": 2e-5, "adapter": 2e-5, "text": 2e-6}
# the port's operators each program's graph holds
PROGRAM_OPS = {"multiview": {"preprocess_images", "similarity"},
               "singleview": {"preprocess_images", "similarity"},
               "adapter": {"preprocess_images"}, "text": {"flash_attention_packed"}}


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


@pytest.fixture(scope="module")
def weights():
    """One seeded tiny model in both packages, unfolded and folded; the
    folded port model's prompt features (basic prompts) and serving bank."""
    vocab = build_dev_vocab(LABELS)
    cfg = dict(TINY, vocab_size=len(vocab))
    # JAX's flash attention cannot be exported at a symbolic batch (its
    # Pallas cost estimate takes ints), so the JAX side runs its plain
    # attention; the port's BERT runs cxr::flash_attention_packed
    jcfg = jconfig.ModelConfig(**dict(cfg, flash_attention=False))
    jmodel = JCXRClip(jcfg, fold_bn=True)
    shapes = jax.eval_shape(JCXRClip(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, LENGTH), jnp.int32))
    rng = np.random.default_rng(7)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    jfolded = jfold(variables)
    model = CXRClip(config.ModelConfig(**cfg)).eval()
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    folded = CXRClip(config.ModelConfig(**cfg), fold_bn=True).eval()
    folded.load_state_dict(state_dict_from_jax(jfolded["params"], {}))
    tokenizer = BertTokenizer(vocab)
    engine = ZeroShotEngine(folded, tokenizer, LABELS, config.ZeroShotConfig(), MEAN, STD,
                            SIZE, LENGTH, torch.float32)
    bank = engine.build_text_features(prompts_for_family("prediction", LABELS))
    enc = tokenizer.encode(create_basic_prompts(LABELS), max_length=LENGTH)
    text = engine._encode_text(enc["input_ids"], enc["attention_mask"]).clone()
    return dict(variables=variables, jfolded=jfolded, jmodel=jmodel, model=model,
                folded=folded, tokenizer=tokenizer, engine=engine, bank=bank, text=text,
                enc=enc)


@pytest.fixture(scope="module")
def programs(weights, tmp_path_factory):
    """The four programs of both packages from the folded weights: the
    port's in an artifact directory, JAX's deserialized."""
    w = weights
    jv = {"params": w["jfolded"]["params"]}
    jm, bank, text = w["jmodel"], w["bank"].numpy(), w["text"].numpy()
    out = str(tmp_path_factory.mktemp("artifact"))
    f32, hw = torch.float32, (SOURCE, SOURCE)
    export.write_artifact(
        out, export.export_multiview_scorer(w["folded"], text, SIZE, MEAN, STD),
        export.export_text_encoder(w["folded"], LENGTH),
        manifest={"disease_labels": list(LABELS)},
        singleview_bytes=export.export_singleview_scorer(
            w["folded"], bank, SIZE, MEAN, STD, 0.5, source_hw=hw, compute_dtype=f32),
        adapter_bytes=export.export_adapter_scorer(w["folded"], SIZE, MEAN, STD,
                                                   source_hw=hw, compute_dtype=f32))
    port = {"multiview": export.ExportedScorer(out, device="cpu"),
            "text": export.ExportedTextEncoder(out, device="cpu"),
            "singleview": export.ExportedEngine(out, device="cpu"),
            "adapter": export.ExportedEngine(out, module=export.ADAPTER_FILE, device="cpu")}
    cpu = dict(platforms=("cpu",))
    jprograms = {
        "multiview": jexport.export_multiview_scorer(jm, jv, text, SIZE, MEAN, STD, **cpu),
        "singleview": jexport.export_singleview_scorer(
            jm, jv, bank, SIZE, MEAN, STD, 0.5, source_hw=hw, compute_dtype=jnp.float32, **cpu),
        "adapter": jexport.export_adapter_scorer(jm, jv, SIZE, MEAN, STD, source_hw=hw,
                                                 compute_dtype=jnp.float32, **cpu),
        "text": jexport.export_text_encoder(jm, jv, LENGTH, **cpu),
    }
    return out, port, {k: jex.deserialize(v) for k, v in jprograms.items()}


def _images(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# BatchNorm folding
# ---------------------------------------------------------------------------


def test_fold_matches_the_jax_fold(weights):
    """The port's fold of its own state dict against JAX's
    ``fold_clip_image_tower`` carried over: the same tensors within 1e-6."""
    got = fold_clip_image_tower(weights["model"].state_dict())
    want = state_dict_from_jax(weights["jfolded"]["params"], {})
    assert got.keys() == want.keys()
    assert not any(".bn" in k or "downsample.1" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_folded_model_matches_unfolded_and_is_eval_only(weights):
    """fp32 zero-shot logits of the folded model within 1e-5 of the
    unfolded one's, on the same bank; the folded tower refuses train mode."""
    engine = weights["engine"]
    live = ZeroShotEngine(weights["model"], weights["tokenizer"], LABELS,
                          config.ZeroShotConfig(), MEAN, STD, SIZE, LENGTH, torch.float32)
    live.text_features = engine.text_features
    imgs = _images(1, 4, SIZE, SIZE, 3)
    np.testing.assert_allclose(engine.logits(imgs), live.logits(imgs), atol=1e-5, rtol=0)
    tower = weights["folded"].image_tower
    with pytest.raises(RuntimeError, match="eval mode"):
        tower.train()(torch.zeros(1, SIZE, SIZE, 3))
    tower.eval()


# ---------------------------------------------------------------------------
# The programs against JAX's
# ---------------------------------------------------------------------------


def _run(port, name):
    if name == "multiview":
        return lambda x: port[name](x)[1]
    return port[name] if name == "text" else port[name].logits


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", sorted(PROGRAM_TOL))
def test_program_matches_the_jax_program(programs, weights, name, b):
    _, port, jprograms = programs
    run = _run(port, name)
    if name == "text":
        ids = weights["enc"]["input_ids"][:b]
        mask = weights["enc"]["attention_mask"][:b]
        got, want = run(ids, mask), jprograms[name].call(ids, mask)
    else:
        shape = (b, 2, SIZE, SIZE, 3) if name == "multiview" else (b, SOURCE, SOURCE, 3)
        imgs = _images(b, *shape)
        got, want = run(imgs), jprograms[name].call(imgs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=PROGRAM_TOL[name], rtol=0)


@pytest.mark.parametrize("name", sorted(PROGRAM_OPS))
def test_program_graph_holds_the_operators(programs, name):
    """Each program's graph calls the port's operators, not their bodies."""
    out = programs[0]
    file = {"multiview": export.SCORER_FILE, "singleview": export.SINGLEVIEW_FILE,
            "adapter": export.ADAPTER_FILE, "text": export.TEXT_ENCODER_FILE}[name]
    with open(os.path.join(out, file), "rb") as f:
        graph = torch.export.load(f).graph
    ops = {str(n.target).split(".")[1] for n in graph.nodes
           if n.op == "call_function" and str(n.target).startswith("cxr.")}
    assert ops == PROGRAM_OPS[name]


def test_programs_match_the_live_models(programs, weights):
    """The single-view and adapter programs against the live engines on the
    same folded weights and bank, bit for bit at b = 5; the text encoder
    against ``encode_text``."""
    port = programs[1]
    imgs = _images(5, 5, SOURCE, SOURCE, 3)
    np.testing.assert_array_equal(port["singleview"].logits(imgs),
                                  weights["engine"].logits(imgs))
    adapter = AdapterEngine(weights["folded"], MEAN, STD, SIZE, torch.float32)
    np.testing.assert_array_equal(port["adapter"].logits(imgs), adapter.logits(imgs))
    enc = weights["enc"]
    np.testing.assert_array_equal(port["text"](enc["input_ids"], enc["attention_mask"]),
                                  weights["text"].numpy())


# ---------------------------------------------------------------------------
# The loaders and the service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", ["zeroshot", "adapter"])
def test_exported_engine_serves_through_zeroshot_service(programs, head):
    """Each single-image answer equals the engine's probabilities (1e-6,
    host against device sigmoid); multi-view batches flatten to views."""
    engine = programs[1]["adapter" if head == "adapter" else "singleview"]
    assert engine.image_size == SOURCE and engine.disease_list == list(LABELS)
    mv = _images(6, 2, 2, SOURCE, SOURCE, 3)
    np.testing.assert_array_equal(engine.logits(mv), engine.logits(mv.reshape(4, *mv.shape[2:])))
    service = ZeroShotService(engine, LABELS, buckets=(1, 2), max_wait_ms=1.0,
                              image_size=SOURCE)
    try:
        for img in _images(7, 2, SOURCE, SOURCE, 3):
            answer = service.predict_one(img)
            np.testing.assert_allclose([answer["probs"][d] for d in LABELS],
                                       engine.probs(img[None])[0], atol=1e-6, rtol=0)
    finally:
        service.close()


def test_geometry_length_and_manifest_checks(programs, tmp_path):
    out = programs[0]
    engine = export.ExportedEngine(out, device="cpu")
    with pytest.raises(ValueError, match="exported geometry"):
        engine.logits(_images(0, 2, SIZE, SIZE, 3))
    scorer = export.ExportedScorer(out, threshold=0.7, device="cpu")
    assert scorer.input_hw == (SIZE, SIZE) and scorer.disease_list == list(LABELS)
    preds, probs = scorer(_images(0, 2, 2, SIZE, SIZE, 3))
    assert (preds == (probs > 0.7)).all()
    with pytest.raises(ValueError, match="exported geometry"):
        scorer(_images(0, 2, 2, SOURCE, SOURCE, 3))
    encoder = export.ExportedTextEncoder(out, device="cpu")
    assert encoder.max_text_length == LENGTH
    with pytest.raises(ValueError, match="max_text_length"):
        encoder(np.zeros((2, 8), np.int32), np.zeros((2, 8), np.int32))
    export.write_artifact(str(tmp_path), None, manifest={"disease_labels": list(LABELS)[:16]},
                          singleview_bytes=open(os.path.join(out, export.SINGLEVIEW_FILE),
                                                "rb").read())
    assert export.ExportedEngine(str(tmp_path), device="cpu").disease_list == list(LABELS)[:16]
    with pytest.raises(FileNotFoundError, match="export_inference --stablehlo"):
        export.ExportedEngine(str(tmp_path), module=export.ADAPTER_FILE, device="cpu")


def test_loading_needs_no_model_code(programs):
    """A child process loads and runs a program with none of ``models``,
    ``text``, ``train`` or ``cli`` imported."""
    out = programs[0]
    code = (
        "import sys, numpy as np\n"
        "from clip_for_dl_tpu_torch.export import ExportedEngine\n"
        f"e = ExportedEngine({out!r}, device='cpu')\n"
        f"print(e.logits(np.zeros((1, {SOURCE}, {SOURCE}, 3), np.uint8)).shape)\n"
        "print(sorted(m for m in sys.modules if m.startswith('clip_for_dl_tpu')))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    shape, mods = run.stdout.strip().splitlines()[-2:]
    assert shape == f"(1, {len(LABELS)})"
    for part in ("models", "text", "train", "cli"):
        assert f"clip_for_dl_tpu_torch.{part}" not in mods
    assert "'clip_for_dl_tpu'" not in mods and "'clip_for_dl_tpu." not in mods


# ---------------------------------------------------------------------------
# The tool and the command
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tool_artifact(tmp_path_factory):
    from clip_for_dl_tpu_torch.tools import export_inference

    out = tmp_path_factory.mktemp("tool") / "artifact"
    assert export_inference.main(["--checkpoint", "fresh", "--out", str(out), "--tiny",
                                  "--stablehlo", "--cpu"]) == 0
    return str(out)


def test_tool_writes_a_runnable_artifact(tool_artifact):
    """The tool's files; the folded weights load back (``load_folded_model``)
    and score as the program does, bit for bit; the manifest records the
    tracing."""
    from clip_for_dl_tpu_torch.tools.export_inference import load_folded_model

    out = tool_artifact
    for name in (export.SCORER_FILE, export.SINGLEVIEW_FILE, export.ADAPTER_FILE,
                 export.TEXT_ENCODER_FILE, "weights.safetensors", "manifest.json"):
        assert os.path.exists(os.path.join(out, name)), name
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert manifest["fold_bn"] is True and manifest["disease_labels"] == list(LABELS)
    assert manifest["stablehlo"]["torch_version"] == torch.__version__
    assert manifest["stablehlo"]["traced_on"] == "cpu"
    scorer = export.ExportedScorer(out, device="cpu")
    s = scorer.input_hw[0]
    preds, probs = scorer(_images(2, 2, 2, s, s, 3))
    assert probs.shape == (2, len(LABELS)) and ((probs >= 0) & (probs <= 1)).all()
    model = load_folded_model(out, device="cpu")
    assert model.fold_bn
    pre = manifest["preprocess"]
    engine = ZeroShotEngine(model, None, LABELS, image_size=s, compute_dtype=torch.float32,
                            mean=tuple(pre["mean"]), std=tuple(pre["std"]))
    program = export.ExportedEngine(out, device="cpu")
    engine.text_features = torch.export.load(
        os.path.join(out, export.SINGLEVIEW_FILE)).state_dict["text_features"]
    imgs = _images(3, 3, s, s, 3)
    np.testing.assert_array_equal(program.logits(imgs), engine.logits(imgs))


def _cli():
    import importlib

    return importlib.import_module("clip_for_dl_tpu_torch.cli.main")


@pytest.mark.parametrize("extra", [["--checkpoint", "ckpts"], ["--use-ema"]],
                         ids=["checkpoint", "use_ema"])
def test_serve_exported_rejects_what_does_not_compose(tool_artifact, monkeypatch, extra):
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    with pytest.raises(SystemExit, match="does not compose with --exported"):
        _cli().main(["serve", "--exported", tool_artifact] + extra)


def test_serve_exported_tp_names_a7(tool_artifact, monkeypatch):
    """``--tp`` is ported (ROADMAP A7b); with ``--exported`` it is refused
    with the JAX CLI's message, as the JAX server refuses it."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    with pytest.raises(SystemExit) as e:
        _cli().main(["serve", "--exported", tool_artifact, "--tp", "2"])
    assert e.value.code == ("--tp does not compose with --exported (the serialized module is "
                            "a single-device program)")


def test_serve_exported_command_answers(tool_artifact, tmp_path):
    """``python -m clip_for_dl_tpu_torch serve --exported DIR --head
    adapter`` on the CPU: 200 on /predict with every label, /healthz names
    the artifact, exit 0 on SIGINT."""
    env = dict(os.environ, CLIP_FOR_DL_TPU_FORCE_CPU="1", PYTHONUNBUFFERED="1")
    child = subprocess.Popen(
        [sys.executable, "-m", "clip_for_dl_tpu_torch", "serve", "--exported", tool_artifact,
         "--head", "adapter", "--host", "127.0.0.1", "--port", "0", "--buckets", "1", "2",
         "--log-dir", str(tmp_path / "logs")],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = child.stderr.readline()
            if not line and child.poll() is not None:
                break
            lines.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "".join(lines)
        assert any("warmed batch bucket 2" in line for line in lines)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict", body=encode_png(_images(4, 80, 70, 3)),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 200 and sorted(payload["probs"]) == sorted(LABELS)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["checkpoint"] == tool_artifact
        conn.close()
        child.send_signal(signal.SIGINT)
        assert child.wait(60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


# ---------------------------------------------------------------------------
# Every wrapper on CPU tensors: its plain version, bit for bit
# ---------------------------------------------------------------------------


def _t(rng, *shape, grad=True):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, requires_grad=grad)


def _grads(out, inputs, seed):
    cot = torch.tensor(np.random.default_rng(seed).standard_normal(out.shape),
                       dtype=out.dtype)
    return torch.autograd.grad(out, inputs, cot)


def test_similarity_and_image_prep_wrappers_equal_their_plain_versions():
    rng = np.random.default_rng(0)
    img, txt = _t(rng, 5, 64), _t(rng, 16, 64)
    got, want = sim.similarity(img, txt, 0.5), sim.similarity_reference(img, txt, 0.5)
    assert torch.equal(got, want)
    for g, w in zip(_grads(got, (img, txt), 1), _grads(want, (img, txt), 1)):
        assert torch.equal(g, w)
    images = _t(rng, 2, 40, 36, 3)
    args = (SIZE, SIZE, MEAN, STD, torch.float32)
    got, want = prep.preprocess_images(images, *args), prep.preprocess_reference(images, *args)
    assert torch.equal(got, want)
    assert torch.equal(_grads(got, (images,), 2)[0], _grads(want, (images,), 2)[0])
    u8 = torch.as_tensor(_images(3, 2, 40, 36, 1))
    assert torch.equal(prep.preprocess_images(u8, 32, 32, MEAN, STD),
                       prep.preprocess_reference(u8, 32, 32, MEAN, STD))


def test_attention_and_mlp_wrappers_equal_their_plain_versions():
    rng = np.random.default_rng(1)
    B, N, H, D = 2, 7, 2, 16
    qkv, bias = _t(rng, B, N, 3 * H * D), torch.zeros(B, N)
    got = fa.flash_attention_packed(qkv, H, bias)
    assert torch.equal(got, fa.flash_attention_packed_reference(qkv, H, bias))
    do = torch.tensor(rng.standard_normal(got.shape), dtype=torch.float32)
    (dqkv,) = torch.autograd.grad(got, qkv, do)
    assert torch.equal(dqkv, fa.flash_attention_packed_bwd_reference(qkv.detach(), do, H, bias))
    x, w1, b1, w2, b2 = (_t(rng, *s) for s in ((6, 32), (64, 32), (64,), (32, 64), (32,)))
    got = mlp.dense_gelu_dense(x, w1, b1, w2, b2)
    assert torch.equal(got, mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2))
    dy = torch.tensor(rng.standard_normal(got.shape), dtype=torch.float32)
    (dx,) = torch.autograd.grad(got, x, dy)
    assert torch.equal(dx, mlp.dense_gelu_dense_bwd_reference(
        x.detach(), w1.detach(), b1.detach(), w2.detach(), dy)[0])
    x, ls, lb, w1, b1, w2, b2 = (_t(rng, *s) for s in ((3, 4, 128), (128,), (128,), (256, 128),
                                                        (256,), (128, 256), (128,)))
    inputs = (x, ls, lb, w1, b1, w2, b2)
    for wrapper in (blk.fused_mlp_block, blk.fused_mlp_block_trainable):
        want = blk.fused_mlp_block_reference(x.reshape(12, 128), *inputs[1:]).reshape(x.shape)
        got = wrapper(*inputs)
        assert torch.equal(got, want)
        for g, w in zip(_grads(got, inputs, 3), _grads(want, inputs, 3)):
            assert torch.equal(g, w)
