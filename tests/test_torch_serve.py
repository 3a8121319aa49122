"""The port's HTTP server (clip_for_dl_tpu_torch/serving.py) against the JAX
package's, on the CPU in fp32.

Request decoding is held byte for byte against the JAX
``decode_request_image`` (cv2 and the JAX package's native runtime) on PNGs
of every kind. Then a port server and a JAX server, each on port 0 over a
tiny engine with the same weights (drawn from a seed, carried across by
``state_dict_from_jax``), answer the same requests: probabilities within
1e-4 (the zero-shot slice's tolerance), the same predictions and status
codes. Last, ``python -m clip_for_dl_tpu_torch serve`` runs as a child
process on the CPU and stops on SIGINT with exit 0.
"""

import base64
import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_for_dl_tpu import serving as jserving
from clip_for_dl_tpu.core import config as jconfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.zeroshot import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu_torch import serving
from clip_for_dl_tpu_torch.core import config
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.testing.png import encode_png
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = config.DISEASE_LABELS
TOL = 1e-4


# -- request decoding ---------------------------------------------------------------


def _image(seed, h, w, c, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hi, (h, w, c) if c > 1 else (h, w), dtype=np.int64)
    return img.astype(dtype)


def _cv2_png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _pil_png(mode, seed=4):
    rng = np.random.default_rng(seed)
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 256, (37, 41, 3), dtype=np.uint8)).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=17)
    else:  # 1-bit grey
        im = Image.fromarray(rng.integers(0, 2, (37, 41), dtype=np.uint8) * 255).convert("1")
    out = io.BytesIO()
    im.save(out, format="PNG")
    return out.getvalue()


PNGS = {
    "grey": lambda: _cv2_png(_image(1, 50, 61, 1)),
    "rgb": lambda: _cv2_png(_image(2, 47, 33, 3)),
    "rgba": lambda: _cv2_png(_image(3, 40, 40, 4)),
    "grey16": lambda: _cv2_png(_image(4, 45, 52, 1, np.uint16)),
    "rgb16": lambda: _cv2_png(_image(5, 31, 29, 3, np.uint16)),
    "palette": lambda: _pil_png("P"),
    "bilevel": lambda: _pil_png("1"),
    "interlaced": lambda: encode_png(_image(6, 43, 38, 3), filters="random", interlace=True),
    "interlaced16": lambda: encode_png(_image(7, 21, 34, 1, np.uint16), filters="random",
                                       interlace=True),
}


@pytest.mark.parametrize("kind", list(PNGS))
@pytest.mark.parametrize("size", [32, 224])
@pytest.mark.parametrize("as_json", [False, True])
def test_decode_request_image_is_byte_equal_to_jax(kind, size, as_json):
    raw = PNGS[kind]()
    body, ctype = raw, "image/png"
    if as_json:
        body, ctype = json.dumps({"image_b64": base64.b64encode(raw).decode()}).encode(), \
            "application/json"
    got = serving.decode_request_image(body, ctype, size)
    want = jserving.decode_request_image(body, ctype, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("body,ctype,match", [
    (b"not an image", "image/png", "^could not decode image bytes$"),
    (_cv2_png(_image(8, 20, 20, 3))[:60], "image/png", "^could not decode image bytes$"),
    (b'{"image": 1}', "application/json", "bad JSON request"),
    (b"{", "application/json", "bad JSON request"),
])
def test_undecodable_requests_raise_as_jax_does(body, ctype, match):
    with pytest.raises(ValueError, match=match):
        serving.decode_request_image(body, ctype, 32)
    with pytest.raises(ValueError):
        jserving.decode_request_image(body, ctype, 32)


@pytest.mark.parametrize("fmt", [".jpg", ".bmp", ".tiff", ".webp"])
def test_jpeg_and_bmp_decode_as_jax_others_get_the_a2c_error(fmt):
    """cv2 (and so the JAX server) reads all four; the port decodes JPEG,
    BMP and TIFF to JAX's bytes and names A2c for WebP."""
    ok, buf = cv2.imencode(fmt, _image(9, 24, 24, 3))
    assert ok
    want = jserving.decode_request_image(buf.tobytes(), "image/jpeg", 32)
    assert want.shape == (32, 32, 3)
    if fmt in (".jpg", ".bmp", ".tiff"):
        np.testing.assert_array_equal(
            serving.decode_request_image(buf.tobytes(), "image/jpeg", 32), want)
    else:
        with pytest.raises(ValueError, match="A2c"):
            serving.decode_request_image(buf.tobytes(), "image/jpeg", 32)


# -- a port server and a JAX server over the same weights ------------------------------

TINY = dict(
    image_size=32, max_text_length=16, text_embedding_dim=64, text_layers=2,
    text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    flash_attention=True,
)


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
def engines():
    vocab = build_dev_vocab(LABELS)
    cfg = dict(TINY, vocab_size=len(vocab))
    jmodel = JCXRClip(jconfig.ModelConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    rng = np.random.default_rng(17)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    model = CXRClip(config.ModelConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    prompts = prompts_for_family("prediction", LABELS)
    common = dict(image_size=32, max_text_length=16)
    jeng = JZeroShotEngine(jmodel, variables, JBertTokenizer(vocab), LABELS,
                           jconfig.ZeroShotConfig(), jconfig.CLIP_MEAN, jconfig.CLIP_STD,
                           compute_dtype=jnp.float32, **common)
    jeng.build_text_features(prompts)
    eng = ZeroShotEngine(model, BertTokenizer(vocab), LABELS, config.ZeroShotConfig(),
                         config.CLIP_MEAN, config.CLIP_STD, compute_dtype=torch.float32,
                         **common)
    eng.build_text_features(prompts)
    return {"jax": (jserving, jeng), "port": (serving, eng)}


INFO = {"image_size": 32, "checkpoint": "fresh", "buckets": [1, 4]}


class _Served:
    """A service and its server on 127.0.0.1, port 0, in a thread."""

    def __init__(self, module, engine, threshold=0.5, max_pending=None):
        self.service = module.ZeroShotService(engine, LABELS, threshold=threshold, buckets=(1, 4),
                                              max_wait_ms=1.0, image_size=32,
                                              max_pending=max_pending)
        self.server = module.create_server(self.service, "127.0.0.1", 0, model_info=INFO)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, ctype="image/png"):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            headers = {"Content-Type": ctype} if body is not None else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()


@pytest.fixture(scope="module")
def servers(engines):
    thresholds = {"Cardiomegaly": 0.3, "Mass": 0.7}
    served = {tag: _Served(mod, eng, threshold=thresholds) for tag, (mod, eng) in
              engines.items()}
    yield served
    for s in served.values():
        s.close()


def _requests():
    rng = np.random.default_rng(21)
    out = []
    for i in range(6):
        h, w = (48, 48) if i % 2 else (60, 52)
        raw = _cv2_png(rng.integers(0, 256, (h, w), dtype=np.uint8))
        if i % 3 == 2:
            out.append((json.dumps({"image_b64": base64.b64encode(raw).decode()}).encode(),
                        "application/json"))
        else:
            out.append((raw, "image/png"))
    return out


def test_predictions_match_the_jax_server(servers):
    """Each 200 answer: probabilities within 1e-4 of the JAX server's and
    the same predictions under per-disease thresholds; the same answer as
    the service alone; /stats counts them."""
    answers = {}
    for tag, s in servers.items():
        answers[tag] = []
        for body, ctype in _requests():
            status, _, payload = s.request("POST", "/predict", body, ctype)
            assert status == 200, payload
            answers[tag].append(payload)
    for got, want in zip(answers["port"], answers["jax"]):
        assert list(got["probs"]) == list(want["probs"]) == list(LABELS)
        np.testing.assert_allclose([got["probs"][d] for d in LABELS],
                                   [want["probs"][d] for d in LABELS], atol=TOL, rtol=0)
        assert got["predictions"] == want["predictions"]
    stats = {tag: s.request("GET", "/stats")[2] for tag, s in servers.items()}
    assert stats["port"].keys() == stats["jax"].keys()
    assert stats["port"]["requests"] >= len(_requests())


def test_concurrent_requests_resolve_each_its_own(servers, engines):
    """8 client threads at once against the port's server: every answer is
    the engine's probabilities for its own image (1e-6)."""
    s, (_, eng) = servers["port"], engines["port"]
    reqs = _requests() * 2
    results = [None] * len(reqs)

    def client(i):
        results[i] = s.request("POST", "/predict", *reqs[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (body, ctype), (status, _, payload) in zip(reqs, results):
        assert status == 200
        want = eng.probs(serving.decode_request_image(body, ctype, 32)[None])[0]
        np.testing.assert_allclose([payload["probs"][d] for d in LABELS], want, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("method,path,body,ctype", [
    ("POST", "/predict", b"garbage", "image/png"),
    ("POST", "/predict", b'{"image_b64": "Z2FyYmFnZQ=="}', "application/json"),
    ("POST", "/predict", b'{"image": 1}', "application/json"),
    ("POST", "/nowhere", b"x", "image/png"),
    ("GET", "/nowhere", None, None),
    ("GET", "/healthz", None, None),
])
def test_status_codes_and_bodies_match_the_jax_server(servers, method, path, body, ctype):
    """400 for a body that does not decode, 404 off the routes, /healthz
    equal (it carries no timings)."""
    got = servers["port"].request(method, path, body, ctype)
    want = servers["jax"].request(method, path, body, ctype)
    assert got[0] == want[0]
    if path == "/healthz":
        assert got[2] == want[2] == {"status": "ok", "diseases": list(LABELS), **INFO}
    assert set(got[2]) == set(want[2])


def test_a_non_png_body_gets_400_naming_a2c(servers):
    """A JPEG body is answered 200 with the JAX server's answer; a WebP
    body still gets 400 naming A2c (the JAX server answers it)."""
    ok, buf = cv2.imencode(".jpg", _image(10, 40, 40, 3))
    status, _, payload = servers["port"].request("POST", "/predict", buf.tobytes(),
                                                 "image/jpeg")
    jstatus, _, jpayload = servers["jax"].request("POST", "/predict", buf.tobytes(),
                                                  "image/jpeg")
    assert status == jstatus == 200
    np.testing.assert_allclose([payload["probs"][d] for d in LABELS],
                               [jpayload["probs"][d] for d in LABELS], atol=TOL, rtol=0)
    assert payload["predictions"] == jpayload["predictions"]
    ok, buf = cv2.imencode(".webp", _image(10, 40, 40, 3))
    status, _, payload = servers["port"].request("POST", "/predict", buf.tobytes(),
                                                 "image/webp")
    assert status == 400 and "A2c" in payload["error"]
    assert servers["jax"].request("POST", "/predict", buf.tobytes(), "image/webp")[0] == 200


class _Gated:
    """An engine whose dispatch waits for ``gate``: the batcher holds the
    first request while the backlog fills."""

    def __init__(self, engine):
        self.engine, self.gate, self.entered = engine, threading.Event(), threading.Event()

    def _dispatch(self, images):
        self.entered.set()
        self.gate.wait(30)
        return self.engine._dispatch(images)

    def probs(self, images):
        return self.engine.probs(images)


@pytest.mark.parametrize("tag", ["port", "jax"])
def test_a_burst_past_max_pending_gets_429_with_retry_after(engines, tag):
    """max_pending 1: one request in the engine, one queued, the third
    shed with 429 and Retry-After: 1; the first two then answer 200."""
    module, eng = engines[tag]
    gated = _Gated(eng)
    s = _Served(module, gated, max_pending=1)
    body, ctype = _requests()[0]
    results = []
    try:
        first = threading.Thread(target=lambda: results.append(s.request(
            "POST", "/predict", body, ctype)))
        first.start()
        assert gated.entered.wait(30)
        second = threading.Thread(target=lambda: results.append(s.request(
            "POST", "/predict", body, ctype)))
        second.start()
        deadline = time.monotonic() + 30
        while s.service.batcher.queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        status, headers, payload = s.request("POST", "/predict", body, ctype)
        assert status == 429 and headers["Retry-After"] == "1", payload
        assert "max_pending=1" in payload["error"]
        gated.gate.set()
        first.join(60)
        second.join(60)
        assert [r[0] for r in results] == [200, 200]
        assert s.service.batcher.stats()["shed"] == 1
    finally:
        gated.gate.set()
        s.close()


# -- the command in a child process ------------------------------------------------------


def test_serve_command_answers_and_stops_on_sigint(tmp_path):
    """``python -m clip_for_dl_tpu_torch serve --port 0`` on the CPU (the
    switch set, --tiny --fp32): the bound port from its "serving on" line,
    200 on /predict and /healthz, exit 0 on SIGINT, also when the child
    starts with SIGINT ignored (as a shell starts a background job, where
    Python installs no KeyboardInterrupt). A thread reads the child's log to
    its end, so that no pipe left unread can stop the child (its standard
    input and output are closed to it), and each wait is long enough for a
    loaded machine and fails with the log of the child."""
    env = dict(os.environ, CLIP_FOR_DL_TPU_FORCE_CPU="1", PYTHONUNBUFFERED="1")
    thresholds = tmp_path / "t.json"
    thresholds.write_text(json.dumps({"Mass": 0.4}))
    child = subprocess.Popen(
        [sys.executable, "-m", "clip_for_dl_tpu_torch", "serve", "--tiny", "--fp32",
         "--host", "127.0.0.1", "--port", "0", "--buckets", "1", "4", "--thresholds",
         str(thresholds), "--log-dir", str(tmp_path / "logs")],
        cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: signal.signal(signal.SIGINT, signal.SIG_IGN))
    lines, serving = [], threading.Event()

    def read_log():
        for line in child.stderr:
            lines.append(line)
            if "serving on" in line:
                serving.set()
        serving.set()  # the child closed its log: it has exited

    reader = threading.Thread(target=read_log, daemon=True)
    reader.start()
    try:
        assert serving.wait(300), "no 'serving on' line in 300 s:\n" + "".join(lines)
        found = [re.search(r"serving on http://[\d.]+:(\d+)", line) for line in lines]
        port = next((int(m.group(1)) for m in found if m), None)
        assert port, "the child exited before it served:\n" + "".join(lines)
        assert any("warmed batch bucket 4" in line for line in lines)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/predict", body=_cv2_png(_image(11, 80, 70, 1)),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 200 and len(payload["probs"]) == len(LABELS), payload
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["image_size"] == 64 and health["buckets"] == [1, 4]
        conn.close()
        child.send_signal(signal.SIGINT)
        try:
            code = child.wait(120)
        except subprocess.TimeoutExpired:
            pytest.fail("still running 120 s after SIGINT:\n" + "".join(lines))
        assert code == 0, "".join(lines)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        reader.join(10)
