"""Host-side batch loader with threaded prefetch, and the copy of its
batches to the device (counterpart of ``clip_for_dl_tpu.data.loader``).

The reference uses torch DataLoader with 4 worker processes
(0425/prepare_data.py:256-268). Here a thread pool decodes images (zlib and
numpy's larger operations release the interpreter lock) and batches
assemble into fixed-shape numpy arrays, a bounded queue ahead of the
consumer.

Fixed shapes: the final partial batch is padded and carries a ``mask``, so
every batch has one shape.

``prefetch_to_device`` copies batch N+1 to the card while batch N computes:
from pinned host memory, on a side CUDA stream, and the consumer's stream
waits for that copy's event before it uses the batch.

One reference fault is not copied: the JAX ``_drain_producer`` gives up on
a producer that does not stop (a dataset ``__getitem__`` stuck in I/O)
without a word, leaking the thread and its pool; this one logs an error
naming the thread.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device

logger = logging.getLogger("clip_for_dl_tpu_torch.loader")


def length_grouped_order(
    order: np.ndarray,
    lengths: Sequence[int],
    batch_size: int,
    window_batches: int = 50,
) -> np.ndarray:
    """Reorder a SHUFFLED epoch order so contiguous batches are
    length-homogeneous: chunk the shuffled order into windows of
    ``window_batches * batch_size`` samples and sort each window by
    length, descending (stable).

    With per-batch length bucketing (``encode_bucketed``) a uniformly
    shuffled epoch wastes the win: at B=128 on the real Indiana report
    distribution (p50=34, p99≈100 tokens) almost every batch contains one
    long report and pads to the 128/200 bucket. Grouping recovers it —
    the windows come from the shuffled order, so window CONTENTS stay
    random across epochs; only lengths within a window are grouped (the
    standard length-grouped sampler scheme, cf. HF transformers
    LengthGroupedSampler). Descending sort puts each window's longest
    batch first, so an OOM would surface on batch 0.

    Pure function of its inputs, so the loader's (seed, epoch)-keyed
    shuffle + mid-epoch resume semantics are unchanged.
    """
    lengths = np.asarray(lengths)
    window = max(1, window_batches) * batch_size
    chunks = []
    for start in range(0, len(order), window):
        w = order[start : start + window]
        # stable sort on negated lengths = descending, ties keep shuffle order
        chunks.append(w[np.argsort(-lengths[w], kind="stable")])
    return np.concatenate(chunks) if chunks else order


def _collate(samples: Sequence[Dict]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)  # strings / tuples stay host-side
    return out


class HostLoader:
    """Iterate fixed-size batches with background decode threads.

    pad_final=True pads the last batch to batch_size and adds ``mask``
    [B] float32 (1 = real sample); drop_last=True mirrors torch's behavior.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_threads: int = 4,
        drop_last: bool = False,
        pad_final: bool = True,
        prefetch: int = 2,
        shard_index: int = 0,
        num_shards: int = 1,
        even_shards: bool = False,
        pad_shards: bool = False,
        lengths: Optional[Sequence[int]] = None,
        length_group_window: int = 50,
    ):
        """`shard_index`/`num_shards`: multi-host data parallelism — every
        host sees the same global shuffle (seed+epoch) and takes a disjoint
        strided slice, so per-host batches stack into the global batch.

        ``even_shards=True`` truncates the (shuffled) global order to a
        multiple of ``num_shards`` so every shard yields exactly the same
        number of batches — REQUIRED for synchronized multi-process
        training, where a one-batch length skew would deadlock the ranks
        in a collective.

        ``pad_shards=True`` is the EVAL counterpart: instead of truncating,
        the global order is padded up to a multiple of ``num_shards`` with
        repeated samples whose ``mask`` entries are 0 — shards stay
        length-synchronized (no collective deadlock) and every sample is
        scored exactly once (run_eval drops mask-0 rows). Requires
        ``pad_final=True`` (the mask channel)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.prefetch = prefetch
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        if even_shards and pad_shards:
            raise ValueError("even_shards and pad_shards are exclusive")
        if pad_shards and not pad_final:
            raise ValueError("pad_shards needs pad_final (the mask channel)")
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.even_shards = even_shards
        self.pad_shards = pad_shards
        # per-sample sequence lengths → length-grouped batches (see
        # length_grouped_order); applied to the shuffled order only, so
        # eval/deterministic iteration is untouched
        if lengths is not None and len(lengths) != len(dataset):
            raise ValueError(
                f"lengths has {len(lengths)} entries for a "
                f"{len(dataset)}-sample dataset"
            )
        self.lengths = None if lengths is None else np.asarray(lengths)
        self.length_group_window = length_group_window
        self._epoch = 0
        self._step = 0
        self._resume = False

    def set_lengths(self, lengths: Sequence[int]) -> None:
        """Install per-sample sequence lengths after construction (the CLI
        tokenizes once the tokenizer exists, after the loader is built).
        Same validation as the constructor path."""
        lengths = np.asarray(lengths)
        if len(lengths) != len(self.dataset):
            raise ValueError(
                f"lengths has {len(lengths)} entries for a "
                f"{len(self.dataset)}-sample dataset"
            )
        self.lengths = lengths

    def _shard_size(self) -> int:
        n = len(self.dataset)
        if self.even_shards:
            return n // self.num_shards
        if self.pad_shards and self.num_shards > 1:
            return -(-n // self.num_shards)
        return len(range(self.shard_index, n, self.num_shards))

    def __len__(self) -> int:
        n = self._shard_size()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self) -> Iterator[tuple]:
        """Yields (indices, valid) — `valid` marks shard-padding entries
        (repeated samples added by pad_shards) whose mask must be 0."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            if self.lengths is not None:
                order = length_grouped_order(
                    order, self.lengths, self.batch_size,
                    self.length_group_window,
                )
        valid = np.ones(len(order), bool)
        if self.num_shards > 1:
            if self.even_shards:
                order = order[: self.num_shards * (n // self.num_shards)]
                valid = valid[: len(order)]
            elif self.pad_shards and n % self.num_shards:
                extra = self.num_shards - n % self.num_shards
                order = np.concatenate([order, order[:extra]])
                valid = np.concatenate([valid, np.zeros(extra, bool)])
            order = order[self.shard_index :: self.num_shards]
            valid = valid[self.shard_index :: self.num_shards]
        m = len(order)
        stop = (m // self.batch_size) * self.batch_size if self.drop_last else m
        for start in range(0, stop, self.batch_size):
            sl = slice(start, start + self.batch_size)
            yield order[sl], valid[sl]

    # -- mid-epoch resume ---------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        """Deterministic iterator state: the in-flight epoch and how many
        batches the consumer has taken from it. Save alongside the model
        checkpoint to resume mid-epoch after preemption — the shuffle is a
        pure function of (seed, epoch), so skipping `step` batches replays
        the exact remaining order."""
        return {"epoch": self._epoch, "step": self._step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._epoch = int(state["epoch"])
        self._step = int(state["step"])
        self._resume = True

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self._resume:
            skip = self._step  # continue the in-flight epoch
            self._resume = False
        else:
            self._epoch += 1
            self._step = 0
            skip = 0
        queue: Queue = Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for i, (idx, valid) in enumerate(self._batch_indices()):
                        if stop.is_set():
                            return
                        if i < skip:
                            continue
                        samples = list(
                            pool.map(self.dataset.__getitem__, idx)
                        )
                        batch = _collate(samples)
                        real = len(idx)
                        if self.pad_final and real < self.batch_size:
                            batch = _pad_batch(batch, self.batch_size, real)
                        elif self.pad_final:
                            batch["mask"] = np.ones(real, np.float32)
                        if self.pad_final and not valid.all():
                            batch["mask"][:real] *= valid.astype(np.float32)
                        if not _bounded_put(queue, batch, stop):
                            return  # consumer abandoned the epoch
            except BaseException as exc:
                # a dataset __getitem__ raising (decode failure, cache
                # miss in rows mode) must surface in the CONSUMER — a
                # dead producer with no sentinel would hang queue.get()
                # forever
                _bounded_put(queue, exc, stop)
                return
            _bounded_put(queue, sentinel, stop)

        thread = threading.Thread(target=producer, daemon=True,
                                  name=f"HostLoader-producer-epoch{self._epoch}")
        thread.start()
        try:
            while True:
                item = queue.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                self._step += 1
                yield item
        finally:
            # A consumer that abandons the epoch mid-stream (break, or a
            # generator above this one being closed) would otherwise leave
            # this producer — and its ThreadPoolExecutor — blocked forever
            # on a full queue.
            _drain_producer(queue, stop, thread)


def _bounded_put(queue: Queue, item, stop: threading.Event) -> bool:
    """``queue.put`` that gives up once ``stop`` is set — an unbounded put
    would block the producer thread forever when the consumer abandons the
    stream with the queue full. Returns False when abandoned."""
    while not stop.is_set():
        try:
            queue.put(item, timeout=0.1)
            return True
        except Full:
            continue
    return False


def _drain_producer(queue: Queue, stop: threading.Event, thread,
                    timeout: float = 5.0) -> bool:
    """Deterministic producer shutdown: signal stop, drain, then join and
    drain once more — a producer already inside ``queue.put`` (past its
    stop check) can complete the put AFTER the first drain. Returns whether
    the thread ended; a producer still alive after both joins (stuck in a
    dataset ``__getitem__``) is logged as an error, by thread name, since it
    keeps its pool and the batch it is building."""
    stop.set()
    for _ in range(2):
        try:
            while True:
                queue.get_nowait()
        except Empty:
            pass
        thread.join(timeout=timeout)
    if thread.is_alive():
        logger.error("%s did not stop within %.1f s of the consumer leaving the epoch "
                     "(a dataset __getitem__ is stuck); the thread and its pool leak",
                     thread.name, 2 * timeout)
        return False
    return True


def _pad_batch(batch: Dict[str, Any], size: int, real: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray):
            # `*_rows` entries are device-cache row indices; -1 is the
            # zero-image slot (data/device_cache.py), so padded samples
            # gather the same zero image streaming pads with
            fill = -1 if key.endswith("_rows") else 0
            pad = np.full((size - real, *val.shape[1:]), fill, val.dtype)
            out[key] = np.concatenate([val, pad])
        else:
            out[key] = list(val) + [val[-1]] * (size - real)
    mask = np.zeros(size, np.float32)
    mask[:real] = 1.0
    out["mask"] = mask
    return out


def prefetch_to_device(
    iterator: Iterator[Dict[str, Any]],
    device=None,
    keys: Optional[Sequence[str]] = None,
    transform: Optional[Callable[[Dict], Dict]] = None,
    threaded: bool = False,
    depth: int = 2,
) -> Iterator[Dict[str, Any]]:
    """Double-buffered host-to-device copy: batch N+1 is copied while batch
    N computes. ``device`` is the card unless another is named (the CPU
    tests pass ``"cpu"``).

    Each numpy entry (of ``keys``, when given) becomes a tensor on
    ``device``; tensors already there and other entries (strings, lists)
    pass through untouched. ``transform`` runs on the host first. On the
    card an entry is staged in pinned memory and copied with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    that copy's event before the batch is yielded, and each copied tensor
    is recorded on the consumer's stream, so the allocator does not reuse
    its memory while the consumer's work is queued.

    ``threaded=True`` moves the host read and the copy into a producer
    thread behind a queue ``depth`` batches deep; the producer's exceptions
    re-raise in the consumer, and a consumer that leaves early stops it."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    consumer = torch.cuda.current_stream(dev) if cuda else None

    def put(batch: Dict[str, Any]):
        if transform is not None:
            batch = transform(batch)
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and (keys is None or k in keys):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    with torch.cuda.stream(side):
                        t = t.pin_memory().to(dev, non_blocking=True)
                else:
                    t = t.to(dev)
                out[k] = t
            else:
                out[k] = v
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(item):
        out, done = item
        if done is not None:
            consumer.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                    v.record_stream(consumer)
        return out

    if threaded:
        q: Queue = Queue(maxsize=max(1, depth))
        finished = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in iterator:
                    if stop.is_set() or not _bounded_put(q, put(batch), stop):
                        return
            except BaseException as exc:  # re-raised consumer-side
                _bounded_put(q, exc, stop)
                return
            _bounded_put(q, finished, stop)

        t = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
        t.start()
        try:
            while True:
                item = q.get()
                if item is finished:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield ready(item)
        finally:
            _drain_producer(q, stop, t)
        return

    pending = None
    for batch in iterator:
        nxt = put(batch)
        if pending is not None:
            yield ready(pending)
        pending = nxt
    if pending is not None:
        yield ready(pending)
