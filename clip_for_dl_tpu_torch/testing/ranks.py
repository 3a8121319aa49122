"""The rank side of the CPU data-parallel tests (``tests/test_torch_dp.py``,
``test_torch_global_batch.py``, ``test_torch_accum.py``), of the tensor
and sequence parallel ones (``tests/test_torch_tp.py``, ``test_torch_sp.py``:
each case builds its 2-D layout over the ranks, ``parallel.tp.create_dp_tp_mesh``)
of the MoE and expert parallel ones (``tests/test_torch_moe.py``,
``test_torch_ep.py``) and of the pipeline parallel ones
(``tests/test_torch_pp.py``: each case builds its ``(data, stage)`` layout,
``parallel.pp.create_dp_pp_mesh``).

A test writes its cases to ``WORKDIR/cases.pkl`` (numpy arrays and plain
values: flax-layout variables, model configurations, batches), starts N gloo
ranks under ``torchrun`` running ``parallel.worker`` on :func:`run_cases`,
and reads each rank's results from ``WORKDIR/out{r}.pkl``.
Each case runs the port's code on this rank's rows of the case's global
batch; the test holds the results against the JAX package and against the
port's single-process run on the global batch. The functions live in the
package because a child process imports its target by module name.
"""

from __future__ import annotations

import builtins
import os
import pickle
import contextlib
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import ModelConfig
from ..losses import contrastive, global_batch
from ..models import CXRClip, init_weights, state_dict_from_jax
from ..models.resnet import _bn, batch_norm_context
from ..parallel import data_parallel_step, multihost, replicate_state, shard_batch, shard_rows
from ..train import (
    CheckpointManager,
    PreemptionGuard,
    TrainState,
    fit,
    make_accum_clip_pretrain_step,
    make_adapter_eval_step,
    make_adapter_train_step,
    make_clip_pretrain_step,
    make_label_fn,
    make_multiview_train_step,
    make_optimizer,
    make_shared_adapter_train_step,
    run_eval,
)


def device_of(case) -> torch.device:
    """The case's device: the CPU, or with ``device="cuda"`` this rank's card."""
    if case.get("device", "cpu") == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def model_from(case) -> CXRClip:
    """The case's model on its device, from its flax-layout ``variables``
    (or, where JAX is absent, the port's init from ``seed``); the
    multi-view fusion's dropout off (the JAX side patches flax's Dropout)."""
    model = CXRClip(ModelConfig(**case["config"]))
    if "variables" in case:
        v = case["variables"]
        model.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats", {})),
                              strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(case["seed"]))
    model.view_fusion.fusion[2].p = 0.0
    return model.to(device_of(case))


def sgd(model, label_fn) -> torch.optim.SGD:
    """SGD (the update is −lr · the clipped gradient), one group per label."""
    groups: Dict[str, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(label_fn(tuple(name.split("."))), []).append(p)
    return torch.optim.SGD([{"params": ps, "label": k} for k, ps in groups.items()], lr=1.0)


def tensors(batch, device="cpu") -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def host_state(model) -> dict:
    return {k: v.detach().cpu().clone().numpy() for k, v in model.state_dict().items()}


def state_checksum(model) -> float:
    return float(sum(float(t.double().sum()) for t in model.state_dict().values()))


@contextmanager
def fp32_exact():
    """cuDNN deterministic, and TF32 off in matmuls and convolutions, while
    inside (a card's fp32 otherwise rounds products to TF32's 10 bits)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = (
        True, False, False, False)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = flags


def step_case(case, group=None):
    """One step of the case's kind on this rank's rows (with ``group``) or
    on the global batch (without): (loss, the state after, the parameters'
    change). On a card, in fp32 without TF32 (:func:`fp32_exact`)."""
    with fp32_exact():
        return _step_case(case, group)


def _step_case(case, group):
    model = model_from(case)
    kind = case["kind"]
    trainable = {"adapter": ["adapter"], "shared": ["shared_adapter"]}.get(kind,
                                                                          case.get("groups", []))
    label_fn = make_label_fn(trainable)
    if case.get("adamw"):
        opt = make_optimizer(model, label_fn, weight_decay=case.get("weight_decay", 0.0))
    else:
        opt = sgd(model, label_fn)
    prep = dict(image_size=case["image_size"], mean=case["mean"], std=case["std"],
                compute_dtype=torch.float32)
    dp = {} if group is None else {"group": group}
    rest = ()
    if kind == "pretrain":
        if case.get("accum", 1) > 1:
            step = make_accum_clip_pretrain_step(model, opt, label_fn, case["accum"],
                                                 case["loss"], case["temperature"],
                                                 max_grad_norm=case["clip"], **dp, **prep)
        else:
            local = {"local_loss": True} if case.get("local") else {}
            step = make_clip_pretrain_step(model, opt, label_fn, case["loss"],
                                           case["temperature"], max_grad_norm=case["clip"],
                                           **dp, **local, **prep)
    elif kind == "adapter":
        step = make_adapter_train_step(model, opt, label_fn, **dp, **prep)
    elif kind == "shared":
        step = make_shared_adapter_train_step(model, opt, label_fn, **dp, **prep)
    else:
        step = make_multiview_train_step(model, opt, label_fn, case["temperature"],
                                         use_enhance=case.get("enhance", False), augment=False,
                                         max_grad_norm=case["clip"], **dp, **prep)
        rest = (torch.from_numpy(case["bank"]).to(device_of(case)),)
    state = TrainState(model, opt)
    if group is not None:
        replicate_state(state, group)
        step = data_parallel_step(step, group, microbatches=case.get("accum", 1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = []
    for _ in range(case.get("steps", 1)):
        state, metrics = step(state, tensors(case["batch"], device_of(case)), *rest,
                              case["lrs"])
        losses.append(float(metrics["loss"]))
    delta = {n: (p.detach() - before[n]).cpu().numpy() for n, p in model.named_parameters()}
    return losses, model, delta


def _pretrain_like(case):
    losses, model, delta = step_case(case, dist.group.WORLD)
    # the replicated state stays replicated: every rank's bits agree
    multihost.assert_same_across_processes(state_checksum(model), "the state after the steps")
    out = {"losses": losses}
    if dist.get_rank() == 0:
        out.update(state=host_state(model), delta=delta)
    return out


def _bn_case(case):
    """``_bn`` under the group on this rank's rows: Σ over the rank's rows
    of out · c, backward; returns the rows' output and input gradient, the
    weight's and bias's gradient of this rank and the running statistics."""
    bn = torch.nn.BatchNorm2d(case["x"].shape[1], eps=1e-5).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(case[name]))
    r, n = dist.get_rank(), dist.get_world_size()
    x = shard_rows(torch.from_numpy(case["x"]), r, n).requires_grad_()
    c = shard_rows(torch.from_numpy(case["c"]), r, n)
    with batch_norm_context(dist.group.WORLD):
        out = _bn(bn, x)
    (out * c).sum().backward()
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


LOSSES = {
    "global_clip_self_distill": lambda t, i, lbl, bank, s, b: (
        global_batch.global_clip_self_distill_loss(t, i, 2.0)),
    "global_info_nce": lambda t, i, lbl, bank, s, b: global_batch.global_info_nce_loss(i, t, 0.5),
    "global_multilabel": lambda t, i, lbl, bank, s, b: (
        global_batch.global_multilabel_contrastive_loss(i, bank, lbl, 0.07)),
    "global_siglip": lambda t, i, lbl, bank, s, b: global_batch.global_siglip_loss(t, i, s, b),
    "ring_siglip": lambda t, i, lbl, bank, s, b: global_batch.ring_siglip_loss(t, i, s, b),
    "local_info_nce": lambda t, i, lbl, bank, s, b: global_batch.local_info_nce_loss(i, t, 0.5),
    "local_clip_self_distill": lambda t, i, lbl, bank, s, b: (
        global_batch.local_clip_self_distill_loss(t, i, 2.0)),
    "make_global": lambda t, i, lbl, bank, s, b: global_batch.make_global(
        contrastive.clip_self_distill_loss)(t, i, 2.0),
}


def _losses_case(case):
    """Every global-batch loss on this rank's rows: its value and the
    gradients of the rows, the scale and the bias, each divided by the
    world size (the factor the data-parallel average takes out)."""
    r, n = dist.get_rank(), dist.get_world_size()
    x = tensors({k: case[k] for k in ("txt", "img", "labels", "bank")}, device_of(case))
    out = {}
    for name, fn in LOSSES.items():
        t = shard_rows(x["txt"], r, n).clone().requires_grad_()
        i = shard_rows(x["img"], r, n).clone().requires_grad_()
        lbl = shard_rows(x["labels"], r, n)
        s = torch.tensor(case["scale"], requires_grad=True, device=t.device)
        b = torch.tensor(case["bias"], requires_grad=True, device=t.device)
        loss = fn(t, i, lbl, x["bank"], s, b)
        loss.backward()
        out[name] = {"loss": float(loss.detach()),
                     "dtxt": np.zeros(t.shape, np.float32) if t.grad is None
                     else (t.grad / n).cpu().numpy(),
                     "dimg": (i.grad / n).cpu().numpy(),
                     "dscale": None if s.grad is None else float(s.grad),
                     "dbias": None if b.grad is None else float(b.grad)}
    return out


def _eval_case(case):
    """``run_eval`` of the adapter's eval step over the case's global
    batches, each rank fed its rows (the command line's feed)."""
    model = model_from(case)
    step = make_adapter_eval_step(model, image_size=case["image_size"], mean=case["mean"],
                                  std=case["std"], compute_dtype=torch.float32,
                                  group=dist.group.WORLD)
    state = TrainState(model, None)
    batches = [shard_batch(tensors(b), dist.group.WORLD) for b in case["batches"]]
    real = [int(b["mask"].sum()) for b in batches]
    return {"eval": run_eval(step, state, batches), "real_rows": real}


@contextmanager
def recorded_writes():
    """The paths this process opens for writing (``open`` with w, a or x)
    or renames a file to (``os.replace``: ``torch.save`` opens its file in
    C++)."""
    paths, original, replace = [], builtins.open, os.replace

    def recording(file, mode="r", *a, **kw):
        if isinstance(file, (str, os.PathLike)) and any(c in mode for c in "wax"):
            paths.append(os.fspath(file))
        return original(file, mode, *a, **kw)

    def renaming(src, dst, *a, **kw):
        paths.append(os.fspath(dst))
        return replace(src, dst, *a, **kw)

    builtins.open, os.replace = recording, renaming
    try:
        yield paths
    finally:
        builtins.open, os.replace = original, replace


def _checkpoint_case(case):
    """``write``: one AdamW step on the group, then a save (the files this
    rank wrote); ``restore``: the latest checkpoint into a fresh model and
    optimizer, replicated, and one more step."""
    case = dict(case, adamw=True)
    model = model_from(case)
    label_fn = make_label_fn(case["groups"])
    opt = make_optimizer(model, label_fn, weight_decay=1e-3)
    step = data_parallel_step(make_clip_pretrain_step(
        model, opt, label_fn, case["loss"], case["temperature"], image_size=case["image_size"],
        mean=case["mean"], std=case["std"], compute_dtype=torch.float32,
        max_grad_norm=case["clip"], group=dist.group.WORLD), dist.group.WORLD)
    manager = CheckpointManager(case["dir"], max_to_keep=2)
    state = TrainState(model, opt)
    out = {}
    if case["mode"] == "write":
        replicate_state(state, dist.group.WORLD)
        state, _ = step(state, tensors(case["batch"]), case["lrs"])
        with recorded_writes() as written:
            manager.save(0, state, metrics={"val_loss": 1.0})
            manager.wait()
        out["written"] = written
    else:
        state, _ = manager.restore(state)
        replicate_state(state, dist.group.WORLD)
        out["restored"] = host_state(model)
        out["step"] = state.step
        state, metrics = step(state, tensors(case["batch"]), case["lrs"])
        out["loss"] = float(metrics["loss"])
        multihost.assert_same_across_processes(state_checksum(model), "the state")
    return out


def _preempt_case(case):
    """``fit`` with a preemption signal that reaches rank 1 alone after its
    step ``at``: every rank must stop after the same step and the
    mid-epoch checkpoint be written once."""
    model = model_from(case)
    label_fn = make_label_fn(case["groups"])
    opt = sgd(model, label_fn)
    group = dist.group.WORLD
    inner = data_parallel_step(make_clip_pretrain_step(
        model, opt, label_fn, case["loss"], case["temperature"], image_size=case["image_size"],
        mean=case["mean"], std=case["std"], compute_dtype=torch.float32,
        max_grad_norm=case["clip"], group=group), group)
    taken = []

    with PreemptionGuard(signals=()) as guard:
        def step(state, batch, lrs, generator):
            state, metrics = inner(state, batch, lrs)
            taken.append(state.step)
            if dist.get_rank() == 1 and state.step == case["at"]:
                guard.trigger()
            return state, metrics

        manager = CheckpointManager(case["dir"])
        batches = [tensors(case["batch"])] * case["steps"]
        _, history = fit(TrainState(model, opt), step, None, lambda: iter(batches), None,
                         case["lrs"], num_epochs=2, rng_stream=iter([None] * 100),
                         scheduler="none", checkpointer=manager, preemption_guard=guard)
    return {"taken": taken, "epochs": len(history.rows),
            "preempt": manager.preempt_latest(), "requested": guard.requested}


def _cli_case(case):
    """The command line (``cli.main(argv)``) on this rank of the group, with
    every preset's dropout at 0 (its rate has no flag) when the case says
    ``no_dropout``: the JAX CLI's run, patched the same way, then draws no
    mask either; with ``moe_capacity_factor``, the MoE layers' capacity
    factor (``capacity_factor`` E keeps every token, whatever the rows'
    order). Returns the exit status, the logits of the batches the zero-shot
    engine dispatched (None for a command without one), what the command
    printed and the paths it opened for writing."""
    import contextlib
    import dataclasses
    import importlib
    import io
    from unittest import mock

    from ..core import config

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    real = config.get_preset

    def patched(name):
        cfg = real(name)
        model = cfg.model
        if case.get("no_dropout"):
            model = dataclasses.replace(model, dropout=0.0)
        if case.get("moe_capacity_factor"):
            model = dataclasses.replace(model, moe_capacity_factor=case["moe_capacity_factor"])
        return cfg.replace(model=model)

    from ..zeroshot.engine import ZeroShotEngine

    logits, dispatch = [], ZeroShotEngine._dispatch

    def recording(self, images):
        out, n = dispatch(self, images)
        logits.append(out[:n].float().cpu().numpy())
        return out, n

    printed = io.StringIO()
    with mock.patch.object(config, "get_preset", patched), \
            mock.patch.object(ZeroShotEngine, "_dispatch", recording), \
            contextlib.redirect_stdout(printed), recorded_writes() as writes:
        rc = cli.main(list(case["argv"]))
    # the zero-shot engine's logits of every batch, as this rank holds them
    return {"rc": rc, "logits": np.concatenate(logits) if logits else None,
            "stdout": printed.getvalue(), "writes": writes}


def _tp_tower(case):
    """The case's bare tower (``bert``: ``BertEncoder``, ``vit``: ``ViT``)
    in eval mode with its state dict."""
    from ..models.bert import BertEncoder
    from ..models.vit import ViT

    kind = BertEncoder if case["tower"] == "bert" else ViT
    tower = kind(**case["config"])
    tower.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    return tower.to(device_of(case)).eval()


def _tp_forward_case(case):
    """The tower tensor-parallel over the case's layout, each data slice
    fed its rows; the output gathered over the data axis."""
    from ..parallel.collectives import all_gather_rows
    from ..parallel.tp import create_dp_tp_mesh, tensor_parallel_

    mesh = create_dp_tp_mesh(case["tp"])
    tower = tensor_parallel_(_tp_tower(case), mesh)
    rows = {k: shard_rows(v, mesh.data_index, mesh.data_size)
            for k, v in tensors(case["inputs"], device_of(case)).items()}
    with torch.no_grad(), fp32_exact():
        out = tower(*rows.values())
        if mesh.data_group is not None:
            out = all_gather_rows(out, mesh.data_group)
        return {"out": out.cpu().numpy()}


@contextmanager
def attention_seeds(seeds, mesh):
    """``flash_attention.dropout_seeds`` replaced by the case's seeds of
    each layer in turn (``seeds[i]`` [B, 1] over the global batch), this
    rank's data slice of them: the JAX side draws the same per layer."""
    from unittest import mock

    from ..ops import flash_attention as fa

    calls = []

    def fixed(generator, batch, device=None):
        t = torch.from_numpy(seeds[len(calls) % len(seeds)])
        calls.append(batch)
        return shard_rows(t, mesh.data_index, mesh.data_size).to(device)

    with mock.patch.object(fa, "dropout_seeds", fixed):
        yield calls


def _tp_step_case(case):
    """One AdamW pretrain step through ``tensor_parallel_step`` on the
    case's layout (with ``plain``: the unsharded step in one process): the
    attention dropout at the case's rate with its seeds, every other
    dropout off (the JAX side patches flax's Dropout); returns the loss,
    this rank's shard of the state after and of the clipped gradient. On a
    card, in fp32 without TF32 (:func:`fp32_exact`)."""
    with fp32_exact():
        return _tp_step(case)


def _tp_step(case):
    from ..parallel.tp import (
        create_dp_tp_mesh, shard_state_tp, step_groups, tensor_parallel_step,
    )

    mesh = create_dp_tp_mesh(1 if case.get("plain") else case["tp"])
    model = model_from(case)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Dropout) and not name.endswith("attention.self.dropout"):
            m.p = 0.0
    label_fn = make_label_fn(case["groups"])
    opt = make_optimizer(model, label_fn, weight_decay=case["weight_decay"])
    state = TrainState(model, opt)
    prep = dict(image_size=case["image_size"], mean=case["mean"], std=case["std"],
                compute_dtype=torch.float32, max_grad_norm=case["clip"])
    if case.get("plain"):
        step = make_clip_pretrain_step(model, opt, label_fn, "clip_self_distill", 2.0, **prep)
    else:
        state = shard_state_tp(state, mesh)
        step = tensor_parallel_step(make_clip_pretrain_step(
            model, opt, label_fn, "clip_self_distill", 2.0, **prep, **step_groups(mesh)), mesh)
    dev = device_of(case)
    with attention_seeds(case["seeds"], mesh) as calls:
        state, metrics = step(state, tensors(case["batch"], dev), case["lrs"],
                              mesh.generator(0, dev))
    return {"loss": float(metrics["loss"]), "state": host_state(model),
            "grads": {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()},
            "seed_calls": len(calls), "grid": mesh.grid.tolist()}


def _tp_engine_case(case):
    """The zero-shot engine on the case's layout (towers tensor-parallel,
    images over the data axis) on the case's uneven batch."""
    from ..core.config import DISEASE_LABELS, ZeroShotConfig
    from ..parallel.tp import create_dp_tp_mesh
    from ..text import BertTokenizer
    from ..zeroshot import ZeroShotEngine, prompts_for_family

    mesh = create_dp_tp_mesh(case["tp"])
    with fp32_exact():
        engine = ZeroShotEngine(model_from(case), BertTokenizer(case["vocab"]), DISEASE_LABELS,
                                ZeroShotConfig(), image_size=case["image_size"],
                                max_text_length=case["max_text_length"],
                                compute_dtype=torch.float32, mesh=mesh)
        engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
        return {"logits": engine.logits(case["images"])}


def _sp_case(case):
    """``sequence_sharded_fn`` of the case's BERT on its layout."""
    from ..parallel.sp import sequence_sharded_fn
    from ..parallel.tp import create_dp_tp_mesh

    mesh = create_dp_tp_mesh(case["tp"])
    fn = sequence_sharded_fn(_tp_tower(case), mesh, tp_params=case["tp_params"])
    with fp32_exact():
        return {"out": fn(*tensors(case["inputs"], device_of(case)).values()).cpu().numpy()}


class _RowSums:
    """A stand-in engine for the group server's protocol: records each
    batch it dispatches and scores a row by its sum; with ``fail_at``, its
    dispatch of that batch (counted from 0) raises."""

    device = torch.device("cpu")

    def __init__(self, fail_at=None):
        self.seen, self.fail_at = [], fail_at

    def _dispatch(self, images):
        if len(self.seen) == self.fail_at:
            raise RuntimeError("the stand-in engine fails")
        self.seen.append(images.tolist())
        return images.double().sum(dim=tuple(range(1, images.dim())))[:, None], len(images)


def _group_serve_case(case):
    """Rank 0 runs a ``serving.GroupEngine`` over the world, idles past the
    case's idle beat, dispatches the case's batches and stops; every other
    rank follows. Returns the batches each rank dispatched, rank 0's logits
    and the beats it sent."""
    import time
    from unittest import mock

    from .. import serving

    engine = _RowSums()
    header, beats = serving._header, []

    def counting(device, kind, shape=()):
        beats.append(kind == serving._IDLE)
        return header(device, kind, shape)

    with mock.patch.object(serving, "IDLE_BEAT_S", case["beat"]), \
            mock.patch.object(serving, "_header", counting):
        if dist.get_rank():
            return {"seen": engine.seen, "followed": serving.follow(engine, dist.group.WORLD)}
        group_engine = serving.GroupEngine(engine, dist.group.WORLD)
        time.sleep(case["idle"])
        logits = [group_engine.logits(b) for b in case["batches"]]
        group_engine.stop()
        return {"seen": engine.seen, "logits": logits, "beats": sum(beats)}


def _group_serve_fault_case(case):
    """The group server's protocol when the engine of rank ``case["fail"]``
    raises at batch ``case["at"]``. Rank 0 dispatches the case's batches
    until its engine stops (its own failure, or the failure of its idle
    beat's broadcast once the failed follower has left), then tries one
    more; it returns what it saw and exits 0. A failed follower's
    ``follow`` raises, and so does every follower's once rank 0 has left."""
    import time
    from unittest import mock

    from .. import serving

    me = dist.get_rank()
    engine = _RowSums(case["at"] if me == case["fail"] else None)
    with mock.patch.object(serving, "IDLE_BEAT_S", case["beat"]):
        if me:
            serving.follow(engine, dist.group.WORLD)
            return {"followed": True}
        calls = []
        group_engine = serving.GroupEngine(engine, dist.group.WORLD,
                                           on_failure=lambda: calls.append(time.monotonic()))
        raised = []
        for b in case["batches"]:
            try:
                group_engine.logits(b)
            except RuntimeError as exc:
                raised.append(str(exc))
                break
        deadline = time.monotonic() + case["wait"]
        while group_engine.failed is None and time.monotonic() < deadline:
            time.sleep(0.05)
        try:
            group_engine.logits(case["batches"][0])
        except RuntimeError as exc:
            raised.append(str(exc))
        group_engine.stop()
        return {"seen": len(engine.seen), "raised": raised, "on_failure": len(calls),
                "failed": repr(group_engine.failed)}


def _moe_dp_case(case):
    """N = 2 data parallel over the data group of a 2 x 2 layout (the two
    ranks of each model index a run of their own) with a MoE text tower;
    with ``local_routing``, the planted fault: each rank routes its own
    rows alone (its own capacity and queue positions)."""
    from unittest import mock

    from ..models import moe
    from ..parallel.common import create_2d_mesh
    from ..train import steps

    mesh = create_2d_mesh(2)
    local = (lambda group=None: moe.routing(None)) if case.get("local_routing") else moe.routing
    with mock.patch.object(steps, "routing", local):
        losses, model, delta = step_case(dict(case, kind="pretrain"), mesh.data_group)
    return {"losses": losses, "delta": delta}


def _moe_remat_case(case):
    """The case's pretrain step over the whole group (data parallel, the
    MoE layers routing over the global batch) without remat, with remat
    under the case's ``policy``, and with remat and the planted fault of a
    recompute that runs outside the forward's context (so its MoE layers
    route over this rank's rows alone): each run's losses and parameter
    changes, or the error it raised."""
    from unittest import mock

    from ..models import remat

    def lost_context(fn, args, generator, start):
        import contextvars

        return contextvars.Context().run(fn, *args)

    config = dict(case["config"], remat=True, remat_conv=True, remat_policy=case["policy"])
    out = {}
    for name, cfg, fault in (("plain", case["config"], False), ("remat", config, False),
                             ("fault", config, True)):
        with mock.patch.object(remat, "_recompute", lost_context) if fault \
                else contextlib.nullcontext():
            try:
                losses, _, delta = step_case(dict(case, kind="pretrain", config=cfg),
                                             dist.group.WORLD)
                out[name] = {"losses": losses, "delta": delta}
            except RuntimeError as exc:
                out[name] = {"error": str(exc)}
    return out


def _ep_case(case):
    """One AdamW pretrain step through ``expert_parallel_step`` on the
    case's ``(data, expert)`` layout, dropout off: the loss, this rank's
    clipped gradients (its expert shards among them) and state after; with
    ``dir``, a checkpoint written through ``WholeCheckpoints``."""
    from ..parallel.ep import (
        WholeCheckpoints, create_dp_ep_mesh, expert_parallel_step, shard_state_ep,
    )
    from ..parallel.tp import step_groups

    mesh = create_dp_ep_mesh(case["ep"])
    with fp32_exact():
        model = model_from(case)
        label_fn = make_label_fn(case["groups"])
        opt = make_optimizer(model, label_fn, weight_decay=case["weight_decay"])
        state = shard_state_ep(TrainState(model, opt), mesh)
        prep = dict(image_size=case["image_size"], mean=case["mean"], std=case["std"],
                    compute_dtype=torch.float32, max_grad_norm=case["clip"])
        step = expert_parallel_step(make_clip_pretrain_step(
            model, opt, label_fn, "clip_self_distill", 2.0, **prep, **step_groups(mesh)), mesh)
        dev = device_of(case)
        state, metrics = step(state, tensors(case["batch"], dev), case["lrs"],
                              mesh.generator(0, dev))
        out = {"loss": float(metrics["loss"]), "state": host_state(model),
               "grads": {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()},
               "expert_index": mesh.model_index, "data_index": mesh.data_index}
        if case.get("dir"):
            ckpt = WholeCheckpoints(CheckpointManager(case["dir"]), mesh)
            ckpt.save(0, state, metrics={"val_loss": 0.0})
            ckpt.wait()
            # the shards are back after the save
            out["after_save"] = host_state(model)
    return out


class _ScaledGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def _summing_broadcast(self, parts):
    """Planted fault: the stage group's broadcast of the last stage's
    output with ``all_reduce_sum``, whose backward sums the stages'
    identical cotangents: every text gradient S times."""
    from ..parallel.collectives import all_reduce_sum

    if self.group is not None:
        return all_reduce_sum(parts[0], self.group)
    return _ScaledGrad.apply(sum(parts[1:], parts[0]), self.size)


# the planted faults of the pipeline's stage group: name -> (the
# StageContext method, its faulty version)
PP_FAULTS = {
    "summing_broadcast": ("broadcast", _summing_broadcast),
    # each stage keeps its own copy's gradient of the embeddings: the stage
    # sum left out
    "no_stage_sum": ("enter", lambda self, xs: xs),
}


@contextmanager
def pp_fault(name=None):
    """While inside, the planted fault ``name`` of :data:`PP_FAULTS` (None:
    none) in every pipeline's :class:`~clip_for_dl_tpu_torch.parallel.pp.StageContext`."""
    from unittest import mock

    from ..parallel.pp import StageContext

    if name is None:
        yield
        return
    method, fault = PP_FAULTS[name]
    with mock.patch.object(StageContext, method, fault):
        yield


def _pp_forward_case(case):
    """The case's tower (``bert`` or ``vit``) cut to this rank's stage of
    the case's ``(data, stage)`` layout and pipelined there in ``m``
    microbatches, each data slice fed its rows, with the case's planted
    ``fault``; with ``cot``, the backward of Σ out · cot. Returns the output
    gathered over the data axis and this rank's gradients (its stage's
    layers, the embeddings or stem, the ViT's head), each summed over the
    data group."""
    from ..parallel import pp
    from ..parallel.collectives import all_gather_rows

    mesh = pp.create_dp_pp_mesh(case["pp"])
    tower = pp.shard_stage_(_tp_tower(case), mesh.model_index, mesh.model_size)
    rows = {k: shard_rows(v, mesh.data_index, mesh.data_size)
            for k, v in tensors(case["inputs"], device_of(case)).items()}
    with fp32_exact(), pp_fault(case.get("fault")):
        if case["tower"] == "bert":
            out = pp.pipelined_bert_forward(tower, rows["ids"], rows["mask"], mesh, case["m"])
        else:
            out = pp.pipelined_vit_forward(tower, rows["images"], mesh, case["m"])
        grads = {}
        if "cot" in case:
            cot = shard_rows(torch.from_numpy(case["cot"]), mesh.data_index, mesh.data_size)
            (out * cot.to(out.device)).sum().backward()
            for name, p in tower.named_parameters():
                if p.grad is not None:
                    g = p.grad.clone()
                    if mesh.data_group is not None:
                        dist.all_reduce(g, group=mesh.data_group)
                    grads[name] = g.cpu().numpy()
        out = out.detach()
        if mesh.data_group is not None:
            out = all_gather_rows(out, mesh.data_group)
    return {"out": out.cpu().numpy(), "grads": grads, "stage": mesh.model_index,
            "data_index": mesh.data_index}


def _pp_step_case(case):
    """One pretrain step through ``pipeline_parallel_step`` on the case's
    ``(data, stage)`` layout in ``m`` microbatches (SGD, or AdamW with
    ``adamw``), dropout as the case's config has it: the loss, this rank's
    parameter changes (its stage's layers and every replicated tensor) and
    the elements it holds of each parameter and AdamW moment; with ``dir``,
    a checkpoint written through ``WholeCheckpoints`` (and the rank's
    tensors after it). On a card, in fp32 without TF32."""
    from ..parallel import pp
    from ..parallel.ep import WholeCheckpoints

    mesh = pp.create_dp_pp_mesh(case["pp"])
    with fp32_exact():
        model = model_from(case)
        label_fn = make_label_fn(case["groups"])
        if case.get("adamw"):
            opt = make_optimizer(model, label_fn, weight_decay=case["weight_decay"])
        else:
            opt = sgd(model, label_fn)
        state = pp.shard_state_pp(TrainState(model, opt), mesh)
        step = pp.pipeline_parallel_step(pp.make_pp_clip_pretrain_step(
            model, opt, label_fn, mesh, case["m"], "clip_self_distill", case["temperature"],
            image_size=case["image_size"], mean=case["mean"], std=case["std"],
            compute_dtype=torch.float32, max_grad_norm=case["clip"]), mesh)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        dev = device_of(case)
        state, metrics = step(state, tensors(case["batch"], dev), case["lrs"],
                              mesh.generator(0, dev))
        out = {"loss": float(metrics["loss"]), "stage": mesh.model_index,
               "data_index": mesh.data_index,
               "delta": {n: (p.detach() - before[n]).cpu().numpy()
                         for n, p in model.named_parameters() if p.numel()},
               "held": {n: p.numel() for n, p in model.named_parameters()},
               "moments": {n: {k: v.numel() for k, v in opt.state.get(p, {}).items()
                               if torch.is_tensor(v) and v.dim()}
                           for n, p in model.named_parameters()}}
        if case.get("dir"):
            ckpt = WholeCheckpoints(CheckpointManager(case["dir"]), mesh, pp.whole_state)
            ckpt.save(0, state, metrics={"val_loss": 0.0})
            ckpt.wait()
            out["after_save"] = {n: p.numel() for n, p in model.named_parameters()}
            out["state"] = host_state(model)
    return out


CASES = {"pp_forward": _pp_forward_case, "pp_step": _pp_step_case,
         "tp_forward": _tp_forward_case, "moe_dp": _moe_dp_case, "moe_remat": _moe_remat_case, "ep_step": _ep_case, "group_serve": _group_serve_case,
         "group_serve_fault": _group_serve_fault_case, "tp_step": _tp_step_case,
         "tp_engine": _tp_engine_case, "sp": _sp_case, "cli": _cli_case, "pretrain": _pretrain_like, "adapter": _pretrain_like, "shared": _pretrain_like,
         "multiview": _pretrain_like, "bn": _bn_case, "losses": _losses_case,
         "eval": _eval_case, "checkpoint": _checkpoint_case, "preempt": _preempt_case}


def run_cases(workdir: str) -> None:
    """Every case of ``WORKDIR/cases.pkl`` (name → case) on this rank;
    the results to ``WORKDIR/out{rank}.pkl``."""
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {name: CASES[case["kind"]](case) for name, case in cases.items()}
    with open(os.path.join(workdir, f"out{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(cases: dict, world: int, workdir: str, timeout: float = 180.0,
           device: str = "cpu") -> list:
    """Run ``cases`` on ``world`` ranks in ``workdir`` (gloo on the CPU; with
    ``device="cuda"`` NCCL, a card a rank); returns each rank's results, in
    rank order. Raises with the ranks' output when one fails; stops them all
    past ``timeout`` seconds (torchrun's SIGTERM to the ranks, then SIGKILL)."""
    import signal
    import subprocess

    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    log = os.path.join(workdir, "ranks.log")
    command = multihost.torchrun_command(
        world, "clip_for_dl_tpu_torch.parallel.worker",
        [f"{__name__}:run_cases", workdir, "--device", device, "--timeout", str(timeout)])
    with open(log, "w") as out:
        proc = subprocess.Popen(command, cwd=root, stdout=out, stderr=subprocess.STDOUT)
        try:
            code = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(40)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            raise TimeoutError(f"ranks still running after {timeout} s: stopped")
    if code:
        with open(log) as f:
            raise RuntimeError(f"a rank failed (torchrun exit {code}):\n" + f.read()[-8000:])
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def launch_unsupervised(cases: dict, world: int, workdir: str, timeout: float = 60.0) -> list:
    """Run ``cases`` on ``world`` gloo ranks started as plain processes (no
    ``torchrun`` to stop the others when one fails): a collective waits at
    most ``timeout`` seconds. Returns each rank's (exit code, output,
    results or None), in rank order; every rank is killed after
    2·``timeout`` seconds."""
    import socket
    import subprocess
    import sys

    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        logs.append(os.path.join(workdir, f"rank{r}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "clip_for_dl_tpu_torch.parallel.worker",
                 f"{__name__}:run_cases", workdir, "--timeout", str(timeout)],
                cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT))
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(2 * timeout))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
    out = []
    for r, code in enumerate(codes):
        with open(logs[r]) as f:
            text = f.read()
        path = os.path.join(workdir, f"out{r}.pkl")
        results = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                results = pickle.load(f)
        out.append((code, text, results))
    return out
