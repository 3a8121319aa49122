"""Epoch orchestration (counterpart of ``clip_for_dl_tpu.train.loop``): the
reference's train_clip / train_epoch / validate control flow
(0425/train.py:608-730) on top of the port's steps.

``History``, ``run_epoch``, ``run_eval``, ``fit`` and ``resume_or_init``
follow the JAX functions line for line; what differs is the framework:

- the state is the port's mutable ``TrainState`` (model, optimizer, step),
  which a step updates in place and returns;
- ``rng_stream`` yields ``torch.Generator`` objects, each handed to the
  train step as its ``generator`` (the JAX loop hands out PRNG keys);
  ``itertools.repeat(generator)`` gives one generator whose state advances
  from step to step;
- ``run_eval`` moves each step's ``probs`` (and the batch's ``labels`` and
  ``mask``) to host numpy arrays; the multi-host gather is ROADMAP A7;
- ``History.save_csv`` writes with the ``csv`` module (the GPU machine has
  no pandas), with the JAX frame's columns in the same order.

Loss scalars are read on the host only at the log cadence, so the device
is not synchronised between steps.
"""

from __future__ import annotations

import csv
import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from ..evals.metrics import MeanAccumulator
from .optim import CosineSchedule, EarlyStopping, ReduceLROnPlateau, warmup_scale
from .state import TrainState

logger = logging.getLogger("clip_for_dl_tpu_torch.train")


class History:
    """history dict → rows (plot_training_history / CSV compatible)."""

    def __init__(self):
        self.rows: List[Dict[str, float]] = []

    def append(self, **kw: float) -> None:
        self.rows.append({k: float(v) for k, v in kw.items()})

    @property
    def columns(self) -> List[str]:
        """Every key in order of first appearance, as a DataFrame of the
        rows orders its columns."""
        return list(dict.fromkeys(k for row in self.rows for k in row))

    def save_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns)
            writer.writeheader()
            writer.writerows(self.rows)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def run_epoch(
    step_fn: Callable,
    state: TrainState,
    loader: Iterable[Mapping[str, Any]],
    lrs: Mapping[str, float],
    rng_stream,
    step_args: tuple = (),
    log_every: int = 10,
    epoch: int = 0,
    preemption_guard=None,
    warmup_steps: int = 0,
) -> tuple[TrainState, float, bool]:
    """One training epoch; returns (state, mean loss, interrupted).

    `interrupted` is True when `preemption_guard` fired mid-epoch — the
    loop broke before the loader was exhausted, so the caller can save a
    step-granular checkpoint (state + loader cursor) instead of losing the
    partial epoch.

    ``warmup_steps > 0``: linear LR warmup over the first N global steps —
    the per-group lrs are scaled host-side per batch. The global step is
    read from the state once per epoch and counted host-side after that, so
    the warmup survives resume."""
    meter = MeanAccumulator()
    timer = time.perf_counter()
    metrics = None
    interrupted = False
    global_step = int(state.step) if warmup_steps > 0 else 0
    for i, batch in enumerate(loader):
        if warmup_steps > 0 and global_step < warmup_steps:
            scale = warmup_scale(global_step, warmup_steps)
            batch_lrs = {k: v * scale for k, v in lrs.items()}
        else:
            batch_lrs = dict(lrs)
        global_step += 1
        state, metrics = step_fn(
            state, batch, *step_args, batch_lrs, next(rng_stream)
        )
        if (i + 1) % log_every == 0 or i == 0:
            loss = float(metrics["loss"])  # device sync only at log cadence
            meter.update(loss)
            span = max(i % log_every, 1) if i else 1
            per_batch = (time.perf_counter() - timer) / span
            timer = time.perf_counter()
            logger.info(
                "epoch %d batch %d loss %.4f (%.3fs/batch)",
                epoch, i, loss, per_batch,
            )
        if preemption_guard is not None and preemption_guard.requested:
            interrupted = True
            logger.warning(
                "preemption mid-epoch %d — stopping after batch %d",
                epoch, i,
            )
            break
    if metrics is None:
        raise ValueError("empty training loader")
    # final sync so the epoch mean reflects the last state
    final_loss = float(metrics["loss"])
    if meter.count == 0:
        meter.update(final_loss)
    return state, meter.mean, interrupted


def run_eval(
    eval_fn: Callable,
    state: TrainState,
    loader: Iterable[Mapping[str, Any]],
    step_args: tuple = (),
) -> Dict[str, Any]:
    """Validation pass; returns mean loss plus stacked prob matrices if the
    eval step emits them. Rows whose batch ``mask`` is 0 (the padded tail of
    a last batch) are dropped from ``probs`` and ``labels``."""
    losses: List[float] = []
    probs: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    for batch in loader:
        metrics = eval_fn(state, batch, *step_args)
        losses.append(float(metrics["loss"]))
        if "probs" in metrics:
            probs.append(_host(metrics["probs"]))
            if "labels" in batch:
                labels.append(_host(batch["labels"]))
            if "mask" in batch and batch["mask"] is not None:
                masks.append(_host(batch["mask"]))
    out: Dict[str, Any] = {"loss": float(np.mean(losses))}
    if probs:
        out["probs"] = np.concatenate(probs)
        if labels:
            out["labels"] = np.concatenate(labels)
        if masks:
            m = np.concatenate(masks).astype(bool)
            out["probs"] = out["probs"][m]
            if labels:
                out["labels"] = out["labels"][m]
    return out


def fit(
    state: TrainState,
    train_step: Callable,
    eval_step: Optional[Callable],
    train_loader_fn: Callable[[], Iterable],
    val_loader_fn: Optional[Callable[[], Iterable]],
    base_lrs: Mapping[str, float],
    num_epochs: int,
    rng_stream,
    scheduler: str = "cosine",
    eta_min: float = 0.0,
    plateau_patience: int = 1,
    plateau_factor: float = 0.8,
    early_stop_patience: Optional[int] = 5,
    epoch_args_fn: Optional[Callable[[TrainState], tuple]] = None,
    checkpointer=None,
    start_epoch: int = 0,
    log_every: int = 10,
    preemption_guard=None,
    metric_writer=None,
    stateful_loader=None,
    warmup_steps: int = 0,
) -> tuple[TrainState, History]:
    """The full train_clip loop. `epoch_args_fn` supplies per-epoch extras
    (e.g. precomputed text features) threaded into both steps.
    `preemption_guard` (train.preemption.PreemptionGuard) stops cleanly with
    a final checkpoint when a termination signal arrives — checked every
    batch, so a mid-epoch signal loses at most one step of work.
    `stateful_loader` is the underlying loader (state_dict /
    load_state_dict); when given together with `checkpointer`, a mid-epoch
    preemption persists the loader cursor so `resume_or_init(...,
    loader=...)` replays the exact remaining batch order of the in-flight
    epoch."""
    history = History()
    cosine = CosineSchedule(dict(base_lrs), t_max=num_epochs, eta_min=eta_min)
    plateau = ReduceLROnPlateau(
        dict(base_lrs), factor=plateau_factor, patience=plateau_patience
    )
    stopper = EarlyStopping(early_stop_patience or 10**9)
    lrs = dict(base_lrs)
    best_val = float("inf")

    for epoch in range(start_epoch, num_epochs):
        if scheduler == "cosine":
            lrs = cosine.at_epoch(epoch)
        extra = epoch_args_fn(state) if epoch_args_fn else ()
        t0 = time.perf_counter()
        state, train_loss, interrupted = run_epoch(
            train_step, state, train_loader_fn(), lrs, rng_stream,
            step_args=extra, log_every=log_every, epoch=epoch,
            preemption_guard=preemption_guard, warmup_steps=warmup_steps,
        )
        epoch_time = time.perf_counter() - t0
        if interrupted:
            if checkpointer is not None:
                extra_state = {"mid_epoch": True}
                if stateful_loader is not None:
                    extra_state["loader"] = stateful_loader.state_dict()
                    try:
                        extra_state["num_batches"] = len(stateful_loader)
                    except TypeError:
                        pass
                if hasattr(checkpointer, "save_preempt"):
                    # dedicated slot outside best-k retention: a metric-less
                    # save parked at val_loss=inf among the ranked epochs
                    # would be dropped as the worst at the next save
                    checkpointer.save_preempt(epoch, state, extra_state)
                else:
                    checkpointer.save(
                        epoch, state, extra=extra_state,
                        metrics={"val_loss": float("inf")},
                    )
                logger.warning(
                    "mid-epoch checkpoint saved at epoch %d — restart "
                    "resumes the remaining batches", epoch,
                )
            break
        val_loss = train_loss
        if eval_step is not None and val_loader_fn is not None:
            val = run_eval(eval_step, state, val_loader_fn(), step_args=extra)
            val_loss = val["loss"]
        if scheduler == "plateau":
            lrs = plateau.step(val_loss)
        history.append(
            epoch=epoch, train_loss=train_loss, val_loss=val_loss,
            epoch_time=epoch_time, **{f"lr/{k}": v for k, v in lrs.items()},
        )
        logger.info(
            "epoch %d done: train %.4f val %.4f (%.1fs)",
            epoch, train_loss, val_loss, epoch_time,
        )
        if metric_writer is not None:
            metric_writer.write(
                epoch,
                {"train_loss": train_loss, "val_loss": val_loss,
                 "epoch_time": epoch_time, **{f"lr/{k}": v for k, v in lrs.items()}},
            )
        if checkpointer is not None:
            checkpointer.save(
                epoch, state, metrics={"val_loss": float(val_loss)}
            )
        if val_loss < best_val:
            best_val = val_loss
        if preemption_guard is not None and preemption_guard.requested:
            logger.warning("preemption requested — stopping after epoch %d",
                           epoch)
            break
        if early_stop_patience and stopper.step(val_loss):
            logger.info("early stop at epoch %d (best %.4f)", epoch, best_val)
            break
    if checkpointer is not None:
        checkpointer.wait()
    return state, history


def resume_or_init(checkpointer, state_template: TrainState, loader=None):
    """Auto-resume: (state, start_epoch) from the latest checkpoint, or the
    template at epoch 0 (the reference's resume-from-checkpoint.pth path,
    0425/train.py:653-663, made automatic for preempted restarts). A restore
    loads into the template's model and optimizer, on their device.

    When the latest checkpoint is a mid-epoch preemption save and `loader`
    (the train loader, with state_dict / load_state_dict) is given, the
    loader cursor is replayed so the interrupted epoch continues with its
    exact remaining batch order — start_epoch is then the *same* epoch, not
    the next one."""
    if checkpointer is None:
        return state_template, 0
    latest = checkpointer.latest_epoch()
    preempt_epoch = (
        checkpointer.preempt_latest()
        if hasattr(checkpointer, "preempt_latest") else None
    )
    if preempt_epoch is not None and (latest is None
                                      or preempt_epoch > latest):
        # the newest durable state is a mid-epoch preemption save
        state, extra = checkpointer.restore_preempt(state_template)
        extra = extra or {"mid_epoch": True}
        latest = preempt_epoch
    elif latest is None:
        return state_template, 0
    else:
        state, extra = checkpointer.restore(state_template, latest)
    if extra and extra.get("mid_epoch"):
        loader_state = extra.get("loader")
        num_batches = extra.get("num_batches")
        exhausted = (
            loader_state is None
            or (num_batches is not None
                and loader_state.get("step", 0) >= num_batches)
        )
        if loader is not None and not exhausted:
            loader.load_state_dict(loader_state)
            logger.info(
                "resumed mid-epoch %d at batch %d", latest,
                loader_state["step"],
            )
            return state, latest
        logger.info(
            "mid-epoch checkpoint at epoch %d but %s — starting epoch %d",
            latest,
            "loader cursor exhausted" if loader_state else "no loader given",
            latest + 1,
        )
        return state, latest + 1
    logger.info("resumed from checkpoint epoch %d", latest)
    return state, latest + 1
