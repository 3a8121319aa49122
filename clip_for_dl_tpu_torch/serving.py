"""Serving: a micro-batcher, the zero-shot service over the port's engine,
and its HTTP server (counterpart of ``clip_for_dl_tpu.serving``).

Single uint8 image requests are coalesced into bucketed batches (1/4/16/64
by default); the assembler thread dispatches a batch to the engine, which
queues it on the GPU and returns at once, and a finalizer thread waits for
each batch's result and resolves the callers' futures, so the device
computes batch N while batch N+1 assembles.

:func:`create_server` binds a ``ThreadingHTTPServer`` over a
:class:`ZeroShotService`: ``POST /predict`` (raw image bytes, or JSON
``{"image_b64": ...}``) → 200 with the probabilities and the predictions;
400 for a body that does not decode, 429 with ``Retry-After: 1`` past the
batcher's ``max_pending``, 500 for a failure in the engine; ``GET
/healthz`` and ``GET /stats``; 404 elsewhere.
:func:`decode_request_image` decodes PNG, JPEG and BMP on the port's
decoders (``native/bindings.py decode_image``: the bytes cv2.imdecode and
the native runtime give, in RGB order) and TIFF and Netpbm too
(``native.DECODED``); the other formats the JAX server reads through cv2
(``native.unported_format``) get a 400 that names ROADMAP A2c.

Serving over a process group (``serve --num-devices N [--tp T]``, the JAX
server's engine on a mesh): every rank builds the engine, its prompt bank
encoded collectively; rank 0 binds the HTTP server and runs the
micro-batcher over a :class:`GroupEngine`, which broadcasts each batch's
shape and then its uint8 rows before it dispatches the batch itself; every
other rank runs :func:`follow`, which receives each batch and dispatches
it, so that every rank scores its share (its data slice, its tower shard
under TP) and the logits are gathered as the engine gathers them. Rank 0
broadcasts a stop when it shuts down (on SIGINT or SIGTERM), and an idle
beat while no batch comes, so that no rank waits in a collective past the
group's timeout. A failure of the engine, or of a broadcast, on any rank
is fatal to the group, since the ranks' collectives would fall out of
step: that rank logs it and leaves (rank 0 shuts its server down, every
later dispatch raises), and its exit fails the other ranks' pending
collective at once under gloo, while under NCCL ``torchrun`` stops them.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Full, Queue
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .core.device import to_device
from .native.bindings import decode_image, resize_u8
from .zeroshot.engine import HostCopy

logger = logging.getLogger("clip_for_dl_tpu_torch.serving")

DEFAULT_BUCKETS = (1, 4, 16, 64)


class BacklogFull(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when the pending queue is at
    ``max_pending``, so overload sheds at admission instead of inflating
    every accepted request's latency."""


def _percentiles(samples) -> Dict[str, float]:
    if not samples:
        return {}
    arr = np.sort(np.asarray(samples, np.float64))

    def pct(q):
        return round(float(arr[min(len(arr) - 1, int(q * len(arr)))]), 3)

    return {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)}


class MicroBatcher:
    """Coalesce single-image requests into bucketed device batches, with
    the device kept busy while the next batch assembles.

    Two pipeline stages, so that assembly overlaps device compute:

    - **assembler** thread: takes the first queued request, waits up to
      `max_wait_ms` for more (up to the largest bucket), pads to the next
      bucket size and *dispatches* `predict_fn`. With the port's engine the
      dispatch is asynchronous — the call returns once the batch is queued
      on the GPU — so the assembler immediately starts coalescing batch
      N+1 while batch N runs.
    - **finalizer** thread: fetches each dispatched result (`fetch_fn`,
      default `np.asarray`; the service waits for the result's copy to
      the host, :class:`HostCopy`) and resolves the callers' Futures.

    The bounded hand-off queue (depth 2) is the double buffer: at most one
    batch computing + one assembled-and-dispatched behind it.

    Per-stage timings (ms) are kept for the last `stats_window` batches and
    surfaced by :meth:`stats` as p50/p90/p99: ``queue`` (submit → assembly
    start), ``assemble`` (stack+pad+dispatch), ``fetch`` (dispatch →
    result on host ≈ device compute + D2H).
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_wait_ms: float = 5.0,
        fetch_fn: Optional[Callable] = None,
        stats_window: int = 512,
        max_pending: Optional[int] = None,
    ):
        self.predict_fn = predict_fn
        self.fetch_fn = fetch_fn or np.asarray
        self.buckets = tuple(sorted(buckets))
        self.max_wait_ms = max_wait_ms
        self.max_pending = max_pending
        # bounded queue = the admission bound itself: put_nowait is atomic,
        # so concurrent handler threads can never overshoot max_pending the
        # way a check-then-put on qsize() could (maxsize 0 = unbounded)
        self.queue: "Queue[Tuple[np.ndarray, Future, float]]" = Queue(
            maxsize=max_pending or 0
        )
        # depth-2 hand-off = double buffer (one computing, one staged)
        self._inflight: Queue = Queue(maxsize=2)
        self.requests = 0
        self.batches = 0
        self.rows_padded = 0
        self.shed = 0
        self._t_queue = deque(maxlen=stats_window)
        self._t_assemble = deque(maxlen=stats_window)
        self._t_fetch = deque(maxlen=stats_window)
        # achieved (pre-padding) batch sizes, windowed like the timings —
        # the occupancy distribution a load benchmark needs, not just the
        # lifetime mean
        self._batch_sizes = deque(maxlen=stats_window)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._finalizer = threading.Thread(target=self._finalize, daemon=True)
        self._worker.start()
        self._finalizer.start()

    def submit(self, image_u8: np.ndarray) -> Future:
        """Queue one image; raises :class:`BacklogFull` past ``max_pending``.

        Shedding at admission (instead of queueing unboundedly) keeps the
        latency of ACCEPTED requests bounded under overload."""
        fut: Future = Future()
        try:
            self.queue.put_nowait((image_u8, fut, time.monotonic()))
        except Full:
            with self._lock:
                self.shed += 1
            raise BacklogFull(
                f"batcher backlog at max_pending={self.max_pending}"
            ) from None
        with self._lock:
            self.requests += 1
        return fut

    def stats(self) -> Dict[str, float]:
        with self._lock:
            batches = max(1, self.batches)
            return {
                "requests": self.requests,
                "shed": self.shed,
                "batches": self.batches,
                "mean_batch_size": round(self.requests / batches, 3),
                "rows_padded": self.rows_padded,
                "queue_ms": _percentiles(self._t_queue),
                "assemble_ms": _percentiles(self._t_assemble),
                "fetch_ms": _percentiles(self._t_fetch),
                "batch_size_hist": {
                    str(k): v
                    for k, v in sorted(Counter(self._batch_sizes).items())
                },
            }

    def close(self):
        # Drain WHILE waiting for the threads to die, not once after: the
        # assembler can be blocked in the bounded hand-off put() (e.g. the
        # finalizer is mid-fetch) — draining frees
        # the slot so it exits, and the final sweep below catches an entry
        # deposited after the finalizer's stop-and-empty exit check.
        self._stop.set()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and (
            self._worker.is_alive() or self._finalizer.is_alive()
        ):
            self._fail_pending()
            self._worker.join(timeout=0.1)
            self._finalizer.join(timeout=0.1)
        self._fail_pending()  # final sweep once both threads are dead

    def _fail_pending(self):
        """Fail queued/inflight work fast instead of leaving callers to
        hit their result() timeout during shutdown."""
        for q in (self._inflight, self.queue):
            while True:
                try:
                    entry = q.get_nowait()
                except Empty:
                    break
                futs = (
                    [f for _, f in entry[0]]
                    if q is self._inflight
                    else [entry[1]]
                )
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(RuntimeError("batcher closed"))

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run(self):
        max_bucket = self.buckets[-1]
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.05)
            except Empty:
                continue
            t_start = time.monotonic()
            items = [(first[0], first[1])]
            queue_waits = [t_start - first[2]]
            deadline = t_start + self.max_wait_ms / 1e3
            while len(items) < max_bucket:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    im, fut, t_sub = self.queue.get(timeout=remaining)
                    items.append((im, fut))
                    queue_waits.append(time.monotonic() - t_sub)
                except Empty:
                    break
            size = len(items)
            try:
                # batch assembly is inside the guard too: a shape-mismatched
                # submission must fail its callers, not kill the worker
                t_asm = time.monotonic()
                images = np.stack([im for im, _ in items])
                size = self._bucket(len(items))
                if size > len(items):
                    pad = np.zeros((size - len(items), *images.shape[1:]),
                                   images.dtype)
                    images = np.concatenate([images, pad])
                # async dispatch: returns a device handle; the GPU computes
                # while this thread loops back to assemble the next batch
                handle = self.predict_fn(images)
                asm_ms = (time.monotonic() - t_asm) * 1e3
                self._put_inflight(
                    (items, handle, None, time.monotonic(), asm_ms,
                     queue_waits, size)
                )
            except Exception as exc:
                self._put_inflight(
                    (items, None, exc, time.monotonic(), 0.0,
                     queue_waits, size)
                )

    def _put_inflight(self, entry):
        """Bounded hand-off put that cannot outlive shutdown: once _stop is
        set the entry's callers are failed here instead of being deposited
        into a queue whose finalizer/drain may already be gone."""
        while not self._stop.is_set():
            try:
                self._inflight.put(entry, timeout=0.1)
                return
            except Full:
                continue
        exc = entry[2] or RuntimeError("batcher closed")
        for _, fut in entry[0]:
            if not fut.done():
                fut.set_exception(exc)

    def _finalize(self):
        while not (self._stop.is_set() and self._inflight.empty()):
            try:
                (items, handle, exc, t_disp, asm_ms, queue_waits,
                 size) = self._inflight.get(timeout=0.05)
            except Empty:
                continue
            if exc is None:
                try:
                    probs = self.fetch_fn(handle)
                    for i, (_, fut) in enumerate(items):
                        fut.set_result(np.asarray(probs)[i])
                except Exception as e:  # surface to every caller
                    exc = e
            if exc is not None:
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(exc)
                size = len(items)
            fetch_ms = (time.monotonic() - t_disp) * 1e3
            with self._lock:
                self.batches += 1
                self.rows_padded += size - len(items)
                self._batch_sizes.append(len(items))
                self._t_queue.extend(w * 1e3 for w in queue_waits)
                self._t_assemble.append(asm_ms)
                self._t_fetch.append(fetch_ms)


def decode_request_image(body: bytes, content_type: str,
                         image_size: int) -> np.ndarray:
    """Request payload → RGB uint8 [image_size, image_size, 3].

    Accepts raw PNG, JPEG, BMP, TIFF or Netpbm bytes, or JSON
    {"image_b64": ...} holding them. Raises ValueError on undecodable input (``UnportedFormat``, a
    ValueError naming ROADMAP A2c, for a format cv2 reads and the port does
    not)."""
    if content_type.startswith("application/json"):
        try:
            payload = json.loads(body)
            raw = base64.b64decode(payload["image_b64"])
        except Exception as exc:
            raise ValueError(f"bad JSON request: {exc}") from exc
    else:
        raw = body
    img = decode_image(raw)
    if img is None:
        raise ValueError("could not decode image bytes")
    return resize_u8(img, image_size, image_size)


# what a header broadcast announces: a batch (its shape follows), an idle
# beat, or the stop
_BATCH, _IDLE, _STOP = 0, 1, 2
_HEADER = 7  # kind, ndim, up to five dims
# seconds without a batch after which rank 0 broadcasts an idle beat: far
# inside the group's timeout, which a follower waiting for a batch must not
# reach
IDLE_BEAT_S = 60.0


def _header(device, kind: int, shape=()) -> torch.Tensor:
    h = torch.zeros(_HEADER, dtype=torch.int64, device=device)
    h[0], h[1] = kind, len(shape)
    if shape:
        h[2:2 + len(shape)] = torch.tensor(shape, dtype=torch.int64)
    return h


class GroupEngine:
    """Rank 0's view of an engine that runs over a process group: each
    batch is broadcast to the other ranks (:func:`follow`) before this rank
    dispatches it; the engine's own collectives then run on every rank.
    One lock orders the broadcasts of the batcher's thread, the idle beat
    and :meth:`stop`.

    A failure of the engine or of a broadcast stops the engine for good
    (``failed`` holds it; no stop is broadcast, every later dispatch
    raises) and calls ``on_failure``, with which the server shuts down."""

    def __init__(self, engine, group, on_failure: Optional[Callable[[], None]] = None):
        self.engine, self.group = engine, group
        self.device = engine.device
        self.failed: Optional[BaseException] = None
        self._on_failure = on_failure
        self._src = dist.get_global_rank(group, 0)
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._done = threading.Event()
        self._beat = threading.Thread(target=self._idle_beats, daemon=True)
        self._beat.start()

    def _send(self, kind: int, shape=()) -> None:
        dist.broadcast(_header(self.device, kind, shape), self._src, group=self.group)
        self._last = time.monotonic()

    def _fail(self, exc: BaseException) -> None:
        """Under the lock: the group's end (see the class)."""
        self.failed = exc
        self._done.set()
        logger.error("the engine failed under the process group (%r): the server stops", exc)
        if self._on_failure is not None:
            self._on_failure()

    def _idle_beats(self) -> None:
        while not self._done.wait(IDLE_BEAT_S / 4):
            with self._lock:
                if not self._done.is_set() and time.monotonic() - self._last >= IDLE_BEAT_S:
                    try:
                        self._send(_IDLE)
                    except Exception as exc:
                        self._fail(exc)

    def _dispatch(self, images_u8):
        with self._lock:
            if self._done.is_set():
                raise RuntimeError("the group engine has stopped")
            try:
                imgs = to_device(images_u8, self.device).contiguous()
                self._send(_BATCH, tuple(imgs.shape))
                dist.broadcast(imgs, self._src, group=self.group)
                return self.engine._dispatch(imgs)
            except Exception as exc:
                self._fail(exc)
                raise

    def logits(self, images_u8) -> np.ndarray:
        out, n_real = self._dispatch(images_u8)
        return out.cpu().numpy()[:n_real]

    def probs(self, images_u8) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits(images_u8)))

    def stop(self) -> None:
        """The stop to every other rank (once, unless the group failed);
        later dispatches raise."""
        with self._lock:
            if not self._done.is_set():
                self._done.set()
                self._send(_STOP)
        self._beat.join()


def follow(engine, group) -> int:
    """A rank other than 0 while rank 0 serves: dispatch every batch rank 0
    broadcasts until it broadcasts the stop; returns the batches run. A
    failure here is logged and raised: the process leaves the group."""
    src = dist.get_global_rank(group, 0)
    batches = 0
    try:
        while True:
            header = torch.empty(_HEADER, dtype=torch.int64, device=engine.device)
            dist.broadcast(header, src, group=group)
            kind, ndim, *dims = header.tolist()
            if kind == _STOP:
                return batches
            if kind == _IDLE:
                continue
            imgs = torch.empty(dims[:ndim], dtype=torch.uint8, device=engine.device)
            dist.broadcast(imgs, src, group=group)
            engine._dispatch(imgs)
            batches += 1
    except Exception as exc:
        logger.error("rank %d: the group failed after %d batches (%r): leaving it",
                     dist.get_rank(), batches, exc)
        raise


class ZeroShotService:
    """Engine + batcher + prediction formatting, independent of HTTP.

    ``threshold`` is a scalar, or a per-disease mapping (the calibration
    ``zeroshot --dynamic`` writes to thresholds.json); a disease the mapping
    lacks is decided at 0.5."""

    def __init__(
        self,
        engine,
        disease_list: Sequence[str],
        threshold: Union[float, Mapping[str, float]] = 0.5,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_wait_ms: float = 5.0,
        image_size: int = 224,
        max_pending: Optional[int] = None,
    ):
        self.disease_list = list(disease_list)
        if isinstance(threshold, Mapping):
            self.thresholds = np.array([float(threshold.get(d, 0.5)) for d in disease_list],
                                       np.float64)
        else:
            self.thresholds = np.full(len(disease_list), float(threshold), np.float64)
        self.image_size = image_size

        # dispatch queues the batch, the sigmoid and the copy of the result
        # to the host, so the GPU computes batch N while the batcher
        # assembles batch N+1; the finalizer thread waits for that copy.
        def dispatch(images_u8):
            out, _ = engine._dispatch(images_u8)
            return HostCopy(torch.sigmoid(out))

        self.batcher = MicroBatcher(
            dispatch, buckets, max_wait_ms,
            fetch_fn=HostCopy.numpy, max_pending=max_pending,
        )

    def predict_one(self, image_u8: np.ndarray,
                    timeout_s: float = 30.0) -> Dict:
        t0 = time.perf_counter()
        probs = self.batcher.submit(image_u8).result(timeout=timeout_s)
        return {
            "probs": {d: float(p) for d, p in zip(self.disease_list, probs)},
            "predictions": [d for d, p, t in zip(self.disease_list, probs, self.thresholds)
                            if p > t],
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
        }

    def close(self):
        self.batcher.close()


def _make_handler(service: ZeroShotService, model_info: Dict):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict, headers: Sequence[Tuple[str, str]] = ()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "diseases": service.disease_list,
                                 **model_info})
            elif self.path == "/stats":
                self._send(200, service.batcher.stats())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"no route {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._send(400, {"error": "empty body"})
                return
            body = self.rfile.read(length)
            try:
                image = decode_request_image(body, self.headers.get("Content-Type", ""),
                                             service.image_size)
            except ValueError as exc:
                self._send(400, {"error": str(exc)})
                return
            try:
                self._send(200, service.predict_one(image))
            except BacklogFull as exc:
                # deliberate load shedding, not a failure: clients back off
                # and retry (Retry-After is advisory)
                self._send(429, {"error": str(exc)}, (("Retry-After", "1"),))
            except Exception as exc:
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

        def log_message(self, fmt, *args):  # to the log, not stderr
            logger.info(fmt, *args)

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of concurrent clients past
    # it gets connection resets before the batcher sees them. Overload is
    # the batcher's max_pending → 429, not the accept queue's.
    request_queue_size = 128


def create_server(
    service: ZeroShotService,
    host: str = "0.0.0.0",
    port: int = 8008,
    model_info: Optional[Dict] = None,
) -> ThreadingHTTPServer:
    """Bind (port 0 → ephemeral) and return the server; call
    ``serve_forever()`` on it (or run it in a thread) to start handling."""
    return _Server((host, port), _make_handler(service, model_info or {}))
