"""Command-line entry points of the PyTorch port (counterpart of
``clip_for_dl_tpu.cli.main``):

  prep          01_datapreprocess: raw reports CSV → labeled CSV + unlabeled CSV
  cache-images  decode and resize the image set once into a memmap cache
  pretrain      CLIP contrastive pretraining (notebook phase A)
  train         the scripts' multi-view training (0426/train.py; the
                multimodal_attention preset adds the cross-modal attention)
  adapter       frozen-CLIP C-Adapter training (notebook phase B)
  shared-adapter  the shared-embedding adapter over concat(image, report)
  zeroshot      zero-shot evaluation (union-max or dynamic-threshold pipeline)
  gradcam       Grad-CAM saliency for one sample (--sample_index)
  rollout       ViT attention-rollout saliency for one sample
  eval          metric suite over a checkpoint on the held-out split
  serve         dynamic-batching HTTP inference server
  convert       checkpoint directory / .pth / .safetensors → reference layout

The parser is the JAX CLI's, command for command and flag for flag, so a
JAX command line parses unchanged. A flag the port does not run yet exits
with status 2 and names the ROADMAP item that owns it.

``pretrain``, ``train``, ``adapter``, ``shared-adapter``, ``zeroshot`` and
``serve`` run data-parallel over a ``torch.distributed`` group
(``parallel/``), with the JAX CLI's flags and messages: ``--num-devices N``
in one launch starts N ranks, one a card (the JAX single-process mesh: each
rank takes its contiguous slice of every global batch); under ``torchrun`` the process
joins the group ``torchrun`` made; ``--num-processes`` with
``--coordinator`` and ``--process-id`` joins by TCP, each process loading
its strided shard of the data (the JAX multi-process run);
``--virtual-devices N`` emulates N devices as N gloo ranks on the CPU.
``zeroshot`` and ``serve`` also take ``--tp T`` with ``--num-devices N``:
the towers tensor-parallel over T ranks of an N/T x T layout
(``parallel/tp.py``); ``serve`` binds its server on rank 0, whose batches
the other ranks follow (``serving.py``). ``pretrain --ep P`` with
``--moe-experts E`` runs the MoE text tower's experts sharded over P ranks
of an N/P x P layout (``parallel/ep.py``); ``pretrain --pp S
--pp-microbatches M`` pipelines the text tower's layers over S stages of an
N/S x S layout (``parallel/pp.py``) and writes the whole model to
``<checkpoint-dir>/unstacked`` at the end. Every command takes
``--moe-experts E`` (``models/moe.py``: every other BERT layer's MLP routed
over E experts; a MoE layer routes over the global batch of a group). Only
rank 0 writes logs, checkpoints, CSV and metric files. ``pretrain
--local-loss`` takes the contrastive loss's block form (siglip's ring) and
``--accum-steps A`` the GradCache step (``train/accum.py``).

Every command runs on the card (the kernels of ``ops/``); with
``CLIP_FOR_DL_TPU_FORCE_CPU`` set it runs on the CPU, where every kernel's
wrapper runs its plain version. With neither a card nor the switch, every
command fails. Each command runs end to end on synthetic data when the
Indiana images are absent (``--synthetic``, or auto-detected).
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import sys

import numpy as np

ENV_FORCE_CPU = "CLIP_FOR_DL_TPU_FORCE_CPU"
# where the ranks of a ``--num-devices`` launch note a clean exit (``_spawn``)
ENV_RANK_EXITS = "CLIP_FOR_DL_TPU_RANK_EXITS"

# flag → (the values it takes unported, the ROADMAP item); ``None`` stands
# for any value but the ones a single-device, default run passes. Every
# flag of the JAX CLI runs: none is left.
_ANY = None
UNPORTED_FLAGS: dict = {}
# the commands that run data-parallel over a process group
DP_COMMANDS = ("pretrain", "train", "adapter", "shared-adapter", "zeroshot")
# ... and serve, whose ranks follow rank 0's batches: the commands whose
# --num-devices N starts N ranks (a mesh in the JAX CLI; the others take none)
MESH_COMMANDS = DP_COMMANDS + ("serve",)
# every command joins a group under torchrun or --num-processes: eval,
# gradcam and rollout score over it and the primary writes; prep,
# cache-images and convert run on the primary alone while the others wait
GROUP_COMMANDS = MESH_COMMANDS + ("eval", "gradcam", "rollout", "prep", "cache-images",
                                  "convert")


def _unported(args) -> str | None:
    """Why ``args`` cannot run in the port, or None."""
    for dest, (values, item) in UNPORTED_FLAGS.items():
        v = getattr(args, dest, None)
        if values is _ANY:
            used = v not in (None, False, 0)
        else:
            used = v in values
        if used:
            flag = "--" + dest.replace("_", "-")
            where = item if item.startswith("not ported") else f"ROADMAP {item}"
            return f"{flag} {v!r} is not ported yet ({where})"
    return None


def _serve_single(args) -> bool:
    """``serve --exported`` or ``--head adapter``: the JAX server gives them
    no mesh, so they run in one process whatever ``--num-devices`` says."""
    return args.command == "serve" and bool(args.exported or args.head == "adapter")


def _in_group(args) -> bool:
    """The command runs over a process group when it has one."""
    return args.command in GROUP_COMMANDS and not _serve_single(args)


def _meshed(args) -> bool:
    """The command runs over a mesh of ``--num-devices`` (a group it starts,
    or joins as a whole)."""
    return args.command in MESH_COMMANDS and _in_group(args)


def _processes(args) -> int:
    """``--num-processes`` (prep and cache-images take none)."""
    return int(getattr(args, "num_processes", None) or 1)


def _visible_devices(args) -> int:
    """The devices a mesh may cover: the group's ranks (one device each),
    the emulated CPU devices, the CPU, or the cards."""
    from ..parallel import multihost

    if _processes(args) > 1:
        return _processes(args)
    if multihost.launched():
        return int(os.environ["WORLD_SIZE"])
    if getattr(args, "virtual_devices", None):
        return int(args.virtual_devices)
    if os.environ.get(ENV_FORCE_CPU):
        return 1
    import torch

    return torch.cuda.device_count()


def _mesh_devices(args) -> int:
    """The JAX ``_effective_dp_devices``: ``--num-devices``, or the whole
    group in a multi-process run; 0 for a single-device run."""
    from ..parallel import multihost

    n = int(getattr(args, "num_devices", None) or 0)
    if not n and (_processes(args) > 1 or multihost.launched()):
        n = _visible_devices(args)
    return n


def _dp_devices(args) -> int:
    """The world the command runs at: :func:`_mesh_devices`, or pretrain's
    ``--pp`` or ``--ep`` degree without ``--num-devices`` (the JAX CLI's
    ``_num_devices(args) or pp``)."""
    n = _mesh_devices(args)
    return n or next((d for d in (_pp(args), _ep(args)) if d > 1), 0)


def _pp(args) -> int:
    """pretrain's pipeline degree (0 under ``--lora``, as the JAX CLI sets
    it after its refusal)."""
    if args.command != "pretrain" or args.lora:
        return 0
    return int(args.pp or 0)


def _ep(args) -> int:
    """pretrain's expert-parallel degree (the JAX LoRA path ignores ``--ep``)."""
    if args.command != "pretrain" or args.lora:
        return 1
    return int(args.ep or 1)


def _ep_refused(args, n: int) -> None:
    """``pretrain --ep P``: the JAX CLI's four refusals, in its order and
    with its messages, before any rank starts."""
    from ..parallel.ep import validate_ep

    ep = _ep(args)
    cfg = _apply_tiny(_preset(args), args, 1)
    experts = cfg.model.text_moe_experts
    if not experts:
        raise SystemExit("--ep requires --moe-experts")
    if n % ep:
        raise SystemExit(f"--num-devices {n} must divide into --ep {ep}")
    try:
        validate_ep(experts, ep)
    except ValueError as e:
        raise SystemExit(str(e))
    bs = args.batch_size or cfg.data.batch_size
    if bs % (n // ep):
        raise SystemExit(f"batch size {bs} must divide over the data axis ({n // ep})")


def _pp_refused(args, cfg, n: int) -> None:
    """``pretrain --pp S``: the JAX CLI's refusals of its branch, in its
    order and with its messages, before any rank starts."""
    from ..parallel.pp import validate_pp

    pp = _pp(args)
    if args.learnable_temperature:
        raise SystemExit(
            "--learnable-temperature does not compose with --pp (the "
            "staged step computes the loss at the fixed temperature)"
        )
    if _ep(args) > 1:
        raise SystemExit("--pp does not compose with --ep")
    if cfg.model.text_moe_experts:
        raise SystemExit("--pp does not compose with --moe-experts")
    bs = args.batch_size or cfg.data.batch_size
    if n % pp:
        raise SystemExit(f"--num-devices {n} must divide into --pp {pp}")
    try:
        validate_pp(cfg.model.text_layers, pp, args.pp_microbatches, bs)
    except ValueError as e:
        raise SystemExit(str(e))
    if (bs // args.pp_microbatches) % (n // pp):
        raise SystemExit(
            f"microbatch size {bs // args.pp_microbatches} must divide "
            f"over the data axis ({n // pp})"
        )


def _dp_refused(args) -> None:
    """The JAX CLI's refusals of the data-parallel and pipeline flags and
    their compositions, its messages word for word (raised as
    ``SystemExit``), before any rank starts."""
    if not _meshed(args):
        return
    n, pp = _dp_devices(args), _pp(args)
    if args.command == "pretrain" and not args.lora:
        # the config first, as in the JAX CLI: --fused-mlp's refusal
        cfg = _apply_tiny(_preset(args), args, 1)
        if args.ema_decay and pp > 1:
            raise SystemExit("--ema-decay does not compose with --pp "
                             "(the stacked stage layout)")
        sharded = pp > 1 or _ep(args) > 1
        if args.local_loss:
            if _mesh_devices(args) <= 1:
                raise SystemExit(
                    "--local-loss requires a dp mesh (--num-devices > 1, "
                    "or a multi-process run whose slice has > 1 device)"
                )
            if sharded:
                raise SystemExit(
                    "--local-loss composes with plain --num-devices data "
                    "parallelism only (not --pp/--ep)"
                )
        if int(args.accum_steps or 1) > 1:
            if args.local_loss:
                raise SystemExit("--accum-steps does not compose with --local-loss")
            if sharded:
                raise SystemExit("--accum-steps composes with plain dp only (not "
                                 "--pp/--ep)")
            if args.learnable_temperature:
                raise SystemExit(
                    "--learnable-temperature does not compose with "
                    "--accum-steps (the GradCache step caches features at "
                    "a fixed temperature — the scalars would silently "
                    "train at zero gradient)"
                )
        if pp > 1:
            _pp_refused(args, cfg, n)
    if args.command == "pretrain" and args.lora and (args.pp or 0) > 1:
        raise SystemExit("--pp does not compose with --lora")
    if args.command == "pretrain" and args.lora and n > 1:
        raise SystemExit("--num-devices is not supported with --lora")
    if _ep(args) > 1 and pp <= 1:
        _ep_refused(args, n)
    if n <= 1:
        return
    if pp > 1:
        # the JAX create_2d_mesh's refusal
        if n > _visible_devices(args):
            raise SystemExit(f"requested {n} devices, {_visible_devices(args)} visible")
    elif args.command in DP_COMMANDS and args.command != "zeroshot" and _ep(args) == 1:
        preset = "adapter" if args.command in ("adapter", "shared-adapter") else None
        bs = args.batch_size or _preset(args, preset).data.batch_size
        if bs % n:
            raise SystemExit(f"--num-devices {n} must divide the batch size ({bs})")
    from ..parallel import check_devices, multihost

    try:
        check_devices(n, _visible_devices(args))
    except ValueError as e:
        raise SystemExit(str(e))
    if n != _visible_devices(args) and (_strided(args) or multihost.launched()):
        raise SystemExit(f"--num-devices {n} != {_visible_devices(args)} processes in the "
                         "group: the mesh must cover every rank")
    _inference_layout_refused(args, n)


def _tp(args) -> int:
    return int(getattr(args, "tp", None) or 1)


def _tp_refused(cfg, tp: int) -> None:
    """The JAX ``_inference_mesh``'s check: tp divides the text tower's
    heads and MLP hidden, and the ViT's when the preset has one."""
    from ..parallel.tp import validate_tp

    try:
        validate_tp(cfg.model.text_heads, cfg.model.text_intermediate_dim, tp)
        if cfg.model.image_tower == "vit_b16":
            validate_tp(cfg.model.vit_heads, cfg.model.vit_mlp_dim, tp)
    except ValueError as e:
        raise SystemExit(str(e))


def _inference_layout_refused(args, n: int) -> None:
    """zeroshot and serve at ``--tp T`` over n > 1 devices: the towers'
    and the layout's refusals, before any rank starts."""
    if args.command not in ("zeroshot", "serve") or _tp(args) <= 1:
        return
    from ..parallel.common import rank_grid

    _tp_refused(_apply_tiny(_preset(args), args, 1), _tp(args))
    try:
        rank_grid(n, _tp(args))
    except ValueError as e:
        raise SystemExit(str(e))


def _inference_mesh(args, cfg):
    """zeroshot's and serve's layout (the JAX ``_inference_mesh``): under
    ``--tp T`` > 1 over more than one device, the ``(data, model)`` mesh of
    the group; else None, and the engine runs data-parallel over the
    group, if there is one."""
    if _dp_devices(args) <= 1 or _tp(args) <= 1:
        return None
    _tp_refused(cfg, _tp(args))
    from ..parallel.tp import create_dp_tp_mesh

    try:
        return create_dp_tp_mesh(_tp(args), num_devices=_dp_devices(args))
    except ValueError as e:
        raise SystemExit(str(e))


def _engine_layout(args, cfg) -> dict:
    """The engine's keyword: the TP mesh, the data-parallel group, or none."""
    mesh = _inference_mesh(args, cfg)
    return {"mesh": mesh} if mesh is not None else _dp(_group())


def _lora_refused(args) -> int | None:
    """The JAX CLI's refusals of ``pretrain --lora``, its messages word for
    word, ahead of the unported flags (after the config's ``--fused-mlp``
    refusal, ``--local-loss`` and ``--accum-steps`` are refused for their
    composition with LoRA first, as in the JAX CLI; ``--pp`` and
    ``--num-devices`` after them, by ``_dp_refused``). Returns an exit
    status, or None."""
    if args.command != "pretrain" or not args.lora:
        return None
    if args.lora < 0:
        print("error: --lora rank must be >= 1 (0 disables)", file=sys.stderr)
        return 2
    _apply_tiny(_preset(args), args, 1)
    if getattr(args, "local_loss", False):
        raise SystemExit("--local-loss does not compose with --lora")
    if getattr(args, "ema_decay", 0.0):
        raise SystemExit("--ema-decay does not compose with --lora "
                         "(adapter params train, not the towers)")
    if int(getattr(args, "accum_steps", 1) or 1) > 1:
        raise SystemExit("--accum-steps does not compose with --lora")
    if getattr(args, "learnable_temperature", False):
        raise SystemExit(
            "--learnable-temperature does not compose with --lora "
            "(the LoRA step trains adapter deltas only — the "
            "calibration scalars would receive no gradient)"
        )
    return None


def _on_cpu(args) -> bool:
    """``CLIP_FOR_DL_TPU_FORCE_CPU``, or ``--virtual-devices`` (the JAX
    CLI's emulated CPU devices: gloo ranks on the CPU, never the card)."""
    return bool(os.environ.get(ENV_FORCE_CPU) or getattr(args, "virtual_devices", None))


def _device(args):
    """The card, or the CPU (see :func:`_on_cpu`); raises RuntimeError
    without a card. A process of a group drives its rank's device."""
    import torch
    import torch.distributed as dist

    from ..core.device import require_cuda

    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    if _on_cpu(args):
        return torch.device("cpu")
    return require_cuda()


def _group():
    """The process group a command runs data-parallel over, or None."""
    from ..parallel import multihost

    if not multihost.is_distributed():
        return None
    import torch.distributed as dist

    return dist.group.WORLD


def _dp(group) -> dict:
    """The steps' keyword for ``group``: none for a single-device run."""
    return {} if group is None else {"group": group}


def _primary() -> bool:
    """True on the process that writes logs, checkpoints and metric files
    (the JAX CLI's ``_primary``)."""
    from ..parallel import multihost

    return multihost.is_primary()


def _setup_logging(log_dir: str, name: str) -> None:
    """Log to stderr, and on the primary to ``<log_dir>/<name>.log``."""
    handlers = [logging.StreamHandler()]
    if _primary():
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir, f"{name}.log")))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers,
    )


def _tokenizer(args):
    from ..core.config import DISEASE_LABELS
    from ..text import BertTokenizer
    from ..text.tokenizer import build_dev_vocab

    if args.vocab and os.path.exists(args.vocab):
        return BertTokenizer(args.vocab, do_lower_case=False)
    logging.warning("no vocab file — building a synthetic dev vocabulary")
    return BertTokenizer(build_dev_vocab(DISEASE_LABELS))


def _apply_tiny(cfg, args, vocab_size: int):
    """--tiny: shrink towers for smoke runs; also size the text tower's
    vocabulary to the loaded tokenizer."""
    import dataclasses

    model = dataclasses.replace(cfg.model, vocab_size=vocab_size)
    if getattr(args, "fast_gelu", False):
        model = dataclasses.replace(model, vit_gelu_approximate=True)
    if getattr(args, "fused_mlp", False):
        if (
            (getattr(args, "tp", 1) or 1) > 1
            or (getattr(args, "pp", 0) or 0) > 1
            or (getattr(args, "ep", 1) or 1) > 1
        ):
            # B9 takes no model-axis shard: it is refused as the JAX CLI
            # refuses it
            raise SystemExit(
                "--fused-mlp composes with data parallelism only "
                "(not --tp/--pp/--ep)"
            )
        model = dataclasses.replace(model, vit_fused_mlp=True)
    if getattr(args, "bf16_attention_probs", False):
        model = dataclasses.replace(model, bf16_attention_probs=True)
    if getattr(args, "flash_attention", False):
        model = dataclasses.replace(model, flash_attention=True)
    if getattr(args, "bert_fused_mlp", False):
        model = dataclasses.replace(model, bert_fused_mlp=True)
    if getattr(args, "vit_fused_mlp_train", False):
        model = dataclasses.replace(model, vit_fused_mlp_train=True)
    if getattr(args, "moe_experts", 0):
        model = dataclasses.replace(model, text_moe_experts=args.moe_experts)
    if getattr(args, "learnable_temperature", False):
        loss = getattr(args, "loss", None) or cfg.train.loss
        model = dataclasses.replace(
            model, learnable_temperature=True,
            # siglip trains from the paper's operating point (s = 10,
            # b = -10); the softmax losses start at the preset's fixed T
            logit_scale_init=10.0 if loss == "siglip" else None,
        )
    if getattr(args, "remat", False):
        model = dataclasses.replace(
            model, remat=True, remat_conv=True,
            remat_policy=getattr(args, "remat_policy", "full"),
        )
    if getattr(args, "tiny", False):
        model = dataclasses.replace(
            model,
            image_size=64, max_text_length=32, text_embedding_dim=64,
            text_layers=2, text_heads=2, text_intermediate_dim=128,
            shared_embedding_dim=64, resnet_stages=(1, 1, 1, 1),
            resnet_width=16, vit_layers=2, vit_hidden=64, vit_heads=2,
            vit_mlp_dim=128,
        )
    return cfg.replace(model=model)


def _compute_dtype(args):
    import torch

    return torch.float32 if args.fp32 else torch.bfloat16


def _preset(args, name=None):
    from ..core.config import get_preset

    name = name or args.preset
    try:
        return get_preset(name)
    except KeyError:
        raise SystemExit(f"unknown preset {name!r}")


def _model(cfg, args, train: bool = False):
    """The model of ``cfg`` on the command's device, from ``--checkpoint``
    and the tower files. Serving: matmul weights in the compute dtype.
    Training (``train``): fp32 master weights, cast to the compute dtype in
    the forward, as flax's ``param_dtype=float32`` does."""
    import torch

    from ..core.device import cast_in_forward
    from ..inference import load_trained_model

    compute = _compute_dtype(args)
    model = load_trained_model(
        args.checkpoint, cfg, torch.float32 if train else compute,
        allow_partial=getattr(args, "allow_partial_restore", False),
        use_ema=getattr(args, "use_ema", False),
        init_image_tower=getattr(args, "init_image_tower", None),
        init_text_tower=getattr(args, "init_text_tower", None),
        device=args.device,
    )
    if train and compute != torch.float32:
        cast_in_forward(model, compute)
    return model


def _apply_data_paths(cfg, args):
    """--reports-csv/--projections-csv/--image-dir override the preset."""
    import dataclasses

    updates = {}
    if getattr(args, "reports_csv", None):
        updates["reports_csv"] = args.reports_csv
    if getattr(args, "projections_csv", None):
        updates["projections_csv"] = args.projections_csv
    if getattr(args, "image_dir", None):
        updates["image_dir"] = args.image_dir
    if getattr(args, "batch_size", None):
        updates["batch_size"] = args.batch_size
    if updates:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **updates))
    return cfg


def _loaders(cfg, args, multi_view=True, shard=True):
    """The train and validation loaders. In a ``--num-processes`` run each
    process loads its strided shard (``shard``; zeroshot's engine shards
    the batches itself), at its slice of the global batch."""
    cfg = _apply_data_paths(cfg, args)
    from ..data import (
        ChestXrayMultiViewDataset,
        HostLoader,
        SyntheticImageTextDataset,
        SyntheticMultiViewDataset,
        build_exam_index,
        split_by_uid,
    )

    have_real = (
        not args.synthetic
        and os.path.exists(cfg.data.reports_csv)
        and os.path.exists(cfg.data.projections_csv)
        and os.path.isdir(cfg.data.image_dir)
    )
    dcache = None
    if have_real:
        from ..data import frame_to_image_text_dataset, merge_image_report, read_csv
        from ..data.frame import key

        cache = None
        if getattr(args, "image_cache", None):
            from ..data import ImageCache

            cache = ImageCache(args.image_cache)
            logging.info(
                "image cache: %d preprocessed images from %s",
                len(cache), args.image_cache,
            )
            unsupported = [f for f in ("tp", "pp", "ep") if (getattr(args, f, 1) or 1) > 1]
            if _strided(args):
                # each process already loads its own slice
                unsupported = unsupported or ["num-processes"]
            if getattr(args, "device_cache", False) and unsupported:
                logging.warning("--device-cache composes with dp only (got --%s) — "
                                "streaming instead", unsupported[0])
            elif getattr(args, "device_cache", False):
                from ..data import DeviceCacheBudgetError, DeviceImageCache

                # one resident copy a rank, on its card (the JAX cache is
                # replicated over the mesh)
                try:
                    dcache = DeviceImageCache(cache, device=args.device)
                except DeviceCacheBudgetError as e:
                    logging.warning("--device-cache: %s — streaming instead", e)
        elif getattr(args, "device_cache", False):
            raise SystemExit("--device-cache requires --image-cache")
        image_rows = dcache is not None
        reports = read_csv(cfg.data.reports_csv)
        projections = read_csv(cfg.data.projections_csv)
        merged = merge_image_report(projections, reports)
        train_f, val_f = split_by_uid(merged, cfg.data.test_size, cfg.data.seed)
        if multi_view:
            def exams(frame):
                uids = {key(u) for u in frame.column("uid")}
                index = build_exam_index(reports.where(lambda r: key(r["uid"]) in uids),
                                         projections, cfg.data.image_dir)
                return ChestXrayMultiViewDataset(index, cfg.model.image_size, cache=cache,
                                                 image_rows=image_rows)

            train_ds, val_ds = exams(train_f), exams(val_f)
        else:
            # CLIP pretrain: flat (image, report) pairs over every image
            # (02 nb cell 12 semantics — 4497 rows, not per-exam views)
            train_ds, val_ds = (
                frame_to_image_text_dataset(f, cfg.data.image_dir, cfg.model.image_size,
                                            cache=cache, image_rows=image_rows)
                for f in (train_f, val_f))
    else:
        if getattr(args, "device_cache", False):
            # the user asked for the device-resident feed and would otherwise
            # get silently streamed synthetic data
            raise SystemExit(
                "--device-cache requires the real dataset "
                "(reports/projections CSVs + --image-dir resolve), which "
                "was not found"
            )
        logging.warning("Indiana images unavailable — using synthetic data")
        n = args.synthetic_samples
        kind = SyntheticMultiViewDataset if multi_view else SyntheticImageTextDataset
        train_ds = kind(n, cfg.model.image_size, 0)
        val_ds = kind(n // 4, cfg.model.image_size, 1)
    # train: drop the ragged final batch (a zero-padded sample would skew the
    # batch-global contrastive losses); eval: pad + mask so nothing is lost.
    bs, shard_kwargs = cfg.data.batch_size, {}
    if shard and _strided(args):
        from ..parallel import multihost

        # the ranks of a pipeline's stage group, or of an expert group, load
        # the same rows: a shard a data index (rank r at data r // inner)
        inner = max(_pp(args), _ep(args), 1)
        shard_kwargs = multihost.process_sharded_loader_kwargs(
            cfg.data.batch_size, multihost.process_index() // inner,
            multihost.process_count() // inner)
        bs = shard_kwargs.pop("batch_size")
    train_loader = HostLoader(
        train_ds, bs, shuffle=True, seed=cfg.data.seed,
        num_threads=cfg.data.num_workers,
        drop_last=len(train_ds) > bs, pad_final=True, **shard_kwargs,
    )
    # eval keeps every sample: pad the shard (mask-0 repeats keep the ranks
    # in step) instead of truncating like the train loader
    val_shard_kwargs = dict(shard_kwargs)
    if val_shard_kwargs.pop("even_shards", False):
        val_shard_kwargs["pad_shards"] = True
    val_loader = HostLoader(
        val_ds, bs, shuffle=False, seed=cfg.data.seed,
        num_threads=cfg.data.num_workers, pad_final=True, **val_shard_kwargs,
    )
    if dcache is not None:
        from ..data import DeviceFeedLoader

        train_loader = DeviceFeedLoader(train_loader, dcache)
        val_loader = DeviceFeedLoader(val_loader, dcache)
    return train_loader, val_loader


def _step_images(batch, single_view: bool = False):
    """Image entry of a collated batch, ready for the step. Host batches
    become contiguous numpy (``prefetch_to_device`` copies them); batches
    the ``--device-cache`` feed gathered on the device stay there. The
    multi-view → frontal-only select runs wherever the batch lives."""
    import torch

    img = batch.get("image", batch.get("images"))
    if single_view and img.ndim == 5:
        img = img[:, 0]
    return img if isinstance(img, torch.Tensor) else np.ascontiguousarray(img)


def _rng_stream(args, cfg, mesh=None):
    """The dropout generator stream of ``fit`` (the JAX CLI's
    ``KeyChain(cfg.data.seed)``): one ``torch.Generator`` on the command's
    device, seeded with the data seed, whose state advances from step to
    step; it seeds the attention kernel's dropout. The dropout layers
    outside the kernel draw from torch's global generator, seeded here with
    the same seed, so that a run repeats."""
    import torch

    from ..parallel import multihost

    # each data slice its own stream, so that rows at the same place of two
    # slices do not share their dropout masks; the ranks of one slice of a
    # 2-D ``mesh`` share theirs
    seed = cfg.data.seed + (multihost.process_index() if mesh is None else mesh.data_index)
    torch.manual_seed(seed)
    return itertools.repeat(torch.Generator(args.device).manual_seed(seed))


def _strided(args) -> bool:
    """A ``--num-processes`` run: each process loads its own strided shard."""
    return _processes(args) > 1


def _feed(args, batches, microbatches: int = 1, group=None):
    """Batches on the command's device. Under ``--num-devices`` (a group
    whose ranks load the same global batches) each rank keeps its slice
    over ``group`` (by default the whole group): its contiguous rows, or
    with ``microbatches`` its share of each global microbatch."""
    from ..data import prefetch_to_device

    if group is None:
        group = _group()
    if group is not None and not _strided(args):
        from ..parallel import shard_batch

        batches = (shard_batch(b, group, microbatches) for b in batches)
    return prefetch_to_device(batches, device=args.device)


def _replicated(state):
    """``state`` with rank 0's weights on every rank of the group."""
    group = _group()
    if group is not None:
        from ..parallel import replicate_state

        replicate_state(state, group)
    return state


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------


def _on_primary(run) -> int:
    """``run()`` on the primary alone, its exit status; in a group the other
    ranks wait for it and exit 0, or 1 when it failed, so that N processes
    leave the files one process leaves (the JAX CLI has every process write
    them at once)."""
    from ..parallel import multihost

    code = 1
    try:
        code = run() if _primary() else 0
    finally:
        failed = multihost.agree_any(_primary() and code != 0)
    return 1 if failed and not code else code


def cmd_prep(args) -> int:
    from ..data.labels import prepare_labeled_csv

    def run():
        df = prepare_labeled_csv(args.reports, args.out, args.unlabeled_out)
        print(f"labeled {len(df)} reports → {args.out}")
        return 0

    return _on_primary(run)


def cmd_cache_images(args) -> int:
    """One-time decode+resize of the dataset into a memmap cache
    (data/cache.py); later runs pass --image-cache DIR to skip the
    per-epoch decode."""
    return _on_primary(lambda: _cache_images(args))


def _cache_images(args) -> int:
    import time

    from ..data import build_image_cache, read_csv

    if args.projections_csv and os.path.exists(args.projections_csv):
        names = [str(n) for n in read_csv(args.projections_csv).column("filename")]
        paths = [os.path.join(args.image_dir, n) for n in names]
    else:
        exts = (".png", ".jpg", ".jpeg")
        paths = sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(args.image_dir)
            for f in files
            if f.lower().endswith(exts)
        )
    if not paths:
        print(f"error: no images found under {args.image_dir}",
              file=sys.stderr)
        return 2
    t0 = time.time()
    cache = build_image_cache(
        paths, args.image_size, args.out, workers=args.workers,
        channels=getattr(args, "channels", "auto"),
    )
    dt = time.time() - t0
    layout = "gray-packed (1ch)" if cache.channels == 1 else "rgb (3ch)"
    print(
        f"cached {len(cache)} images at {args.image_size}px {layout} → "
        f"{args.out} ({dt:.1f}s, {len(cache) / max(dt, 1e-9):.0f} img/s)"
    )
    return 0


def cmd_pretrain(args) -> int:
    import torch

    from ..evals import MetricWriter
    from ..train import (
        CheckpointManager,
        PreemptionGuard,
        TrainState,
        fit,
        make_accum_clip_pretrain_step,
        make_clip_eval_step,
        make_clip_pretrain_step,
        make_label_fn,
        make_optimizer,
        resume_or_init,
    )

    cfg = _preset(args)
    group = _group()
    _setup_logging(args.log_dir, "pretrain")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args, train=True)
    compute = _compute_dtype(args)

    groups = {g.name: g.lr for g in cfg.train.groups} or {"default": cfg.train.lr}
    groups.setdefault("default", cfg.train.lr)
    label_fn = make_label_fn([g for g in groups if g != "default"])
    # AdamW over the model's parameters, or with --lora over the factors
    adamw = dict(weight_decay=cfg.train.weight_decay,
                 moment_dtype=torch.bfloat16 if getattr(args, "bf16_moments", False) else None)

    train_loader, val_loader = _loaders(cfg, args, multi_view=False)
    max_len = cfg.model.max_text_length

    if getattr(args, "length_grouped", False):
        if not args.bucket_text:
            raise SystemExit(
                "--length-grouped requires --bucket-text (grouping only "
                "pays off when batches pad to their own bucket)"
            )
        ds = train_loader.dataset
        texts = getattr(ds, "texts", None)
        if texts is None and hasattr(ds, "base"):  # synthetic wrapper
            # read the precomputed findings list — indexing ds itself would
            # synthesize (and discard) every image just to reach the text
            texts = ds.base.findings
        if texts is None:
            raise SystemExit("--length-grouped needs a text dataset")
        # one host-side tokenize pass; lengths key the windowed sort
        enc_lens = tokenizer.encode(
            list(texts), max_length=max_len, padding="longest"
        )["attention_mask"].sum(1)
        train_loader.set_lengths(enc_lens)
        logging.info(
            "length-grouped batching: %d samples, token length p50=%d "
            "p90=%d max=%d",
            len(enc_lens), int(np.percentile(enc_lens, 50)),
            int(np.percentile(enc_lens, 90)), int(enc_lens.max()),
        )

    def tokenize_batch(batch):
        texts = batch.get("text") or batch.get("findings")
        if args.bucket_text:
            # length bucketing: identical outputs (masked attention), but
            # short reports skip most of the 200/512-token pad compute
            enc = tokenizer.encode_bucketed(
                list(texts), max_length=max_len,
                buckets=(32, 64, 128),
            )
        else:
            enc = tokenizer.encode(list(texts), max_length=max_len)
        return {
            # multi-view → frontal only for pretrain
            "images": _step_images(batch, single_view=True),
            "input_ids": enc["input_ids"],
            "attention_mask": enc["attention_mask"],
        }

    loss_name = (
        cfg.train.loss
        if cfg.train.loss in ("clip_self_distill", "info_nce", "siglip")
        else "clip_self_distill"
    )
    if getattr(args, "loss", None):
        loss_name = args.loss
    ema_decay = float(getattr(args, "ema_decay", 0.0) or 0.0)
    prep = dict(image_size=cfg.model.image_size, mean=cfg.augment.mean, std=cfg.augment.std,
                compute_dtype=compute)
    accum = 1
    # --ep and --pp: the (data, expert) or (data, stage) layout; the steps
    # take the data group (the losses, BatchNorm, routing, the gradient
    # average) and the inner group (the clip's sum over the expert shards or
    # the stages' layers)
    mesh, pp = None, _pp(args)
    layout = _dp(group)
    if _ep(args) > 1 or pp > 1:
        from ..parallel import ep as expert
        from ..parallel import pp as pipeline
        from ..parallel.tp import step_groups

        if pp > 1:
            mesh = pipeline.create_dp_pp_mesh(pp, num_devices=_dp_devices(args))
            logging.info("pipeline-parallel over %s (%d microbatches)", mesh.shape,
                         args.pp_microbatches)
        else:
            mesh = expert.create_dp_ep_mesh(_ep(args), num_devices=_dp_devices(args))
            logging.info("expert-parallel over %s", mesh.shape)
        layout = step_groups(mesh)
    data_group = layout.get("group")
    if args.lora:
        # parameter-efficient fine-tuning: the frozen towers and rank-r
        # deltas on the attention and MLP projections (models/lora.py); the
        # state and its checkpoints hold only the factors and their moments
        from ..models.lora import (
            init_lora,
            lora_param_count,
            make_lora_eval_step,
            make_lora_pretrain_step,
        )

        lora = init_lora(torch.Generator().manual_seed(cfg.data.seed), model, rank=args.lora)
        n = lora_param_count(lora)
        logging.info("LoRA rank %d: %d trainable params (%.2f%% of the model)", args.lora, n,
                     100 * n / sum(p.numel() for p in model.parameters()))
        optimizer = make_optimizer(lora, label_fn, **adamw)
        lora_kw = dict(loss_name=loss_name, temperature=cfg.model.temperature,
                       alpha=args.lora_alpha, **prep)
        step = make_lora_pretrain_step(model, lora, optimizer,
                                       max_grad_norm=cfg.train.max_grad_norm, **lora_kw)
        # validation scores the objective the LoRA step trains
        eval_step = make_lora_eval_step(model, lora, **lora_kw)
        template = TrainState(lora, optimizer)
    else:
        optimizer = make_optimizer(model, label_fn, **adamw)
        accum = int(args.accum_steps or 1)
        if pp > 1:
            step = pipeline.make_pp_clip_pretrain_step(
                model, optimizer, label_fn, mesh, args.pp_microbatches, loss_name,
                cfg.model.temperature, max_grad_norm=cfg.train.max_grad_norm, **prep)
        elif accum > 1:
            # GradCache: the towers in microbatches, the contrastive loss and
            # its negatives over the full batch
            step = make_accum_clip_pretrain_step(model, optimizer, label_fn, accum, loss_name,
                                                 cfg.model.temperature,
                                                 max_grad_norm=cfg.train.max_grad_norm,
                                                 ema_decay=ema_decay, **_dp(group), **prep)
        else:
            local = {"local_loss": True} if args.local_loss else {}
            step = make_clip_pretrain_step(model, optimizer, label_fn, loss_name,
                                           cfg.model.temperature,
                                           max_grad_norm=cfg.train.max_grad_norm,
                                           ema_decay=ema_decay, **layout, **local, **prep)
        # with an EMA, validation scores the smoothed weights: they drive the
        # plateau schedule, early stopping and the best checkpoint
        eval_step = make_clip_eval_step(model, loss_name, cfg.model.temperature,
                                        use_ema=bool(ema_decay), **_dp(data_group), **prep)
        template = TrainState.create(model, optimizer, ema=bool(ema_decay))
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, cfg.train.max_checkpoints_to_keep)
    state, start_epoch = resume_or_init(ckpt, template, loader=train_loader)
    state = _replicated(state)
    # restored whole, then sharded; saved whole (the checkpoint layout is
    # unchanged, so that any --pp or --ep, or none, resumes it)
    if pp > 1:
        state = pipeline.shard_state_pp(state, mesh)
        step, eval_step = _pp_eval_pass(step, eval_step, model, mesh)
    elif mesh is not None:
        state = expert.shard_state_ep(state, mesh)
    if mesh is not None and ckpt is not None:
        ckpt = expert.WholeCheckpoints(ckpt, mesh,
                                       (pipeline if pp > 1 else expert).whole_state)
    writer = MetricWriter(args.log_dir, "pretrain") if _primary() else None

    with PreemptionGuard() as guard:
        state, history = fit(
            state, step, eval_step,
            train_loader_fn=lambda: _feed(args, map(tokenize_batch, train_loader), accum,
                                          data_group),
            val_loader_fn=lambda: _feed(args, map(tokenize_batch, val_loader), group=data_group),
            base_lrs=groups,
            num_epochs=args.epochs or cfg.train.num_epochs,
            rng_stream=_rng_stream(args, cfg, mesh),
            scheduler=cfg.train.scheduler,
            eta_min=cfg.train.eta_min,
            plateau_patience=cfg.train.plateau_patience,
            plateau_factor=cfg.train.plateau_factor,
            early_stop_patience=cfg.train.early_stop_patience,
            checkpointer=ckpt,
            start_epoch=start_epoch,
            log_every=cfg.train.log_every,
            preemption_guard=guard,
            metric_writer=writer,
            stateful_loader=train_loader,
            warmup_steps=int(getattr(args, "warmup_steps", 0) or 0),
        )
    if writer is not None:
        writer.close()
    if _primary():
        history.save_csv(os.path.join(args.log_dir, "training_history.csv"))
    if args.lora and args.checkpoint_dir and _primary():
        # the LoRA checkpoint holds only the factors (for resume); also fold
        # them into the frozen base and save a full-model checkpoint that
        # zeroshot/serve/eval --checkpoint load directly
        from ..models.lora import fold_lora
        from ..train.checkpoint import load_model, model_state

        load_model(model, fold_lora(model_state(model), lora, args.lora_alpha))
        folded_dir = os.path.join(args.checkpoint_dir, "folded")
        fm = CheckpointManager(folded_dir, max_to_keep=1)
        fm.save(0, TrainState(model, None))
        fm.wait()
        fm.close()
        print(f"folded LoRA model saved to {folded_dir} "
              f"(servable: --checkpoint {folded_dir})")
    if pp > 1 and args.checkpoint_dir:
        # the in-run checkpoints are whole already; the JAX CLI's canonical
        # copy, which zeroshot, serve and eval --checkpoint read
        canon_dir = os.path.join(args.checkpoint_dir, "unstacked")
        with pipeline.whole_state(TrainState(model, None), mesh) as whole:
            fm = CheckpointManager(canon_dir, max_to_keep=1)
            fm.save(0, whole)
            fm.wait()
            fm.close()
        if _primary():
            print(f"canonical model checkpoint saved to {canon_dir} "
                  f"(servable: --checkpoint {canon_dir})")
    if _primary():
        print(f"pretrain done: {len(history.rows)} epochs")
    return 0


def _pp_eval_pass(step, eval_step, model, mesh):
    """The pipelined step and the ordinary eval step over ``mesh``: each
    eval pass runs on the whole text tower, gathered from the stage group
    once a pass (keyed on the step, as the JAX CLI unstacks it), and the
    next train step frees the other stages' layers again."""
    from ..parallel import pp

    gathered = {}

    def train_step(state, batch, *rest):
        if gathered:
            pp.shard_stage_(model.text_tower, mesh.model_index, mesh.model_size)
            gathered.clear()
        return step(state, batch, *rest)

    def eval_pass_step(state, batch):
        if gathered.get("step") != state.step:
            pp.gather_tower_(model.text_tower, mesh)
            gathered["step"] = state.step
        return eval_step(state, batch)

    return train_step, eval_pass_step


def cmd_train(args) -> int:
    """The scripts' training path (0426/train.py): multi-view exams against
    the prompt bank encoded once an epoch with the current text tower,
    multilabel contrastive loss (or, with the ``multimodal_attention``
    preset, the cross-modal attention and the asymmetric loss), the
    preset's augmentation on the card, a cosine schedule."""
    import torch

    from ..core.config import DISEASE_LABELS
    from ..evals import MetricWriter
    from ..train import (
        CheckpointManager,
        PreemptionGuard,
        TrainState,
        fit,
        make_label_fn,
        make_multiview_eval_step,
        make_multiview_train_step,
        make_optimizer,
        resume_or_init,
    )
    from ..zeroshot import prompts_for_family
    from ..zeroshot.engine import encode_prompt_bank

    cfg = _preset(args)
    group = _group()
    _setup_logging(args.log_dir, "train")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args, train=True)
    use_enhance = cfg.model.use_multimodal_attention

    # one group at the preset's rate, clipped and decayed as the preset says
    label_fn = make_label_fn([])
    optimizer = make_optimizer(model, label_fn, weight_decay=cfg.train.weight_decay)
    prep = dict(image_size=cfg.model.image_size, mean=cfg.augment.mean, std=cfg.augment.std,
                compute_dtype=_compute_dtype(args), use_enhance=use_enhance)
    aug = cfg.augment
    # the scripts' train transform stack, on the card (0425/prepare_data.py:39-55);
    # validation stays un-augmented
    step = make_multiview_train_step(
        model, optimizer, label_fn, cfg.model.temperature, augment=aug.enabled,
        flip_prob=aug.horizontal_flip_prob, rotation_degrees=aug.rotation_degrees,
        translate_frac=aug.translate_frac, max_grad_norm=cfg.train.max_grad_norm,
        **_dp(group), **prep)
    eval_step = make_multiview_eval_step(model, cfg.model.temperature, **_dp(group), **prep)
    train_loader, val_loader = _loaders(cfg, args, multi_view=True)
    prompts = prompts_for_family("prediction", DISEASE_LABELS)

    @torch.no_grad()
    def encode(ids, mask):
        return model.encode_text(torch.from_numpy(ids).to(args.device),
                                 torch.from_numpy(mask).to(args.device), normalize=True)

    def epoch_text_features(state):
        # once an epoch with the current text tower (the 0426 hoisting), in
        # eval mode; the step puts the model back in train mode
        model.eval()
        feats = encode_prompt_bank(prompts, DISEASE_LABELS, encode, tokenizer,
                                   cfg.model.max_text_length)
        model.train()
        return (feats.to(args.device),)

    def to_batch(batch):
        return {"images": _step_images(batch), "labels": np.asarray(batch["labels"])}

    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, cfg.train.max_checkpoints_to_keep)
    state, start_epoch = resume_or_init(ckpt, TrainState(model, optimizer), loader=train_loader)
    state = _replicated(state)
    writer = MetricWriter(args.log_dir, "train") if _primary() else None
    with PreemptionGuard() as guard:
        state, history = fit(
            state, step, eval_step,
            train_loader_fn=lambda: _feed(args, map(to_batch, train_loader)),
            val_loader_fn=lambda: _feed(args, map(to_batch, val_loader)),
            base_lrs={"default": cfg.train.lr},
            num_epochs=args.epochs or cfg.train.num_epochs,
            rng_stream=_rng_stream(args, cfg),
            scheduler=cfg.train.scheduler,
            eta_min=cfg.train.eta_min,
            early_stop_patience=cfg.train.early_stop_patience,
            epoch_args_fn=epoch_text_features,
            checkpointer=ckpt,
            start_epoch=start_epoch,
            log_every=cfg.train.log_every,
            preemption_guard=guard,
            metric_writer=writer,
            stateful_loader=train_loader,
            warmup_steps=int(getattr(args, "warmup_steps", 0) or 0),
        )
    if writer is not None:
        writer.close()
    if _primary():
        history.save_csv(os.path.join(args.log_dir, "training_history.csv"))
        print(f"train done: {len(history.rows)} epochs")
    return 0


def cmd_shared_adapter(args) -> int:
    """The 03 notebook's shared-embedding adapter: a Linear over
    concat(image features, the report's text features), towers frozen."""
    from ..core.config import DISEASE_LABELS
    from ..evals.metrics import multilabel_metrics
    from ..train import (
        CheckpointManager,
        TrainState,
        fit,
        make_label_fn,
        make_optimizer,
        make_shared_adapter_eval_step,
        make_shared_adapter_train_step,
        resume_or_init,
        run_eval,
    )
    from ..utils.visualization import save_predictions_csv

    cfg = _preset(args, "adapter")
    group = _group()
    _setup_logging(args.log_dir, "shared_adapter")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args, train=True)

    # Adam without clipping or decay on the shared adapter alone (the JAX
    # CLI's base_transform(None, 0.0) and freeze_mask)
    label_fn = make_label_fn(["shared_adapter"])
    optimizer = make_optimizer(model, label_fn, weight_decay=0.0)
    prep = dict(image_size=cfg.model.image_size, mean=cfg.augment.mean, std=cfg.augment.std,
                compute_dtype=_compute_dtype(args))
    step = make_shared_adapter_train_step(model, optimizer, label_fn, **_dp(group), **prep)
    eval_step = make_shared_adapter_eval_step(model, **_dp(group), **prep)
    train_loader, val_loader = _loaders(cfg, args, multi_view=True)
    max_len = cfg.model.max_text_length

    def to_batch(batch):
        texts = list(batch.get("findings") or batch.get("text"))
        if args.bucket_text:
            enc = tokenizer.encode_bucketed(texts, max_length=max_len, buckets=(32, 64, 128))
        else:
            enc = tokenizer.encode(texts, max_length=max_len)
        return {"images": _step_images(batch, single_view=True),
                "input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"],
                "labels": np.asarray(batch["labels"])}

    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, cfg.train.max_checkpoints_to_keep)
    state, start_epoch = resume_or_init(ckpt, TrainState(model, optimizer))
    state = _replicated(state)
    state, history = fit(
        state, step, eval_step,
        train_loader_fn=lambda: _feed(args, map(to_batch, train_loader)),
        val_loader_fn=lambda: _feed(args, map(to_batch, val_loader)),
        base_lrs={"shared_adapter": cfg.train.lr, "default": 0.0},
        num_epochs=args.epochs or cfg.train.num_epochs,
        rng_stream=_rng_stream(args, cfg),
        scheduler="none",
        early_stop_patience=None,
        checkpointer=ckpt,
        start_epoch=start_epoch,
        log_every=cfg.train.log_every,
    )
    # the 03 notebook's metric family (cell 30) from the shared adapter's
    # logits; it needs the report at inference, which is why the reference
    # left it
    val = run_eval(eval_step, state, _feed(args, map(to_batch, val_loader)))
    if not _primary():
        return 0
    history.save_csv(os.path.join(args.log_dir, "shared_adapter_history.csv"))
    metrics = multilabel_metrics(val["probs"], val["labels"], class_names=DISEASE_LABELS)
    save_predictions_csv(val["probs"], val["labels"], DISEASE_LABELS,
                         os.path.join(args.log_dir, "shared_adapter_predictions.csv"))
    with open(os.path.join(args.log_dir, "shared_adapter_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps({k: v for k, v in metrics.items() if not k.startswith("auroc/")},
                     indent=2))
    print(f"shared-adapter done: {len(history.rows)} epochs")
    return 0


def cmd_adapter(args) -> int:
    from ..core.config import DISEASE_LABELS
    from ..evals.metrics import multilabel_metrics
    from ..train import (
        CheckpointManager,
        TrainState,
        fit,
        make_adapter_eval_step,
        make_adapter_train_step,
        make_label_fn,
        make_optimizer,
        resume_or_init,
        run_eval,
    )
    from ..utils.visualization import save_predictions_csv

    cfg = _preset(args, "adapter")
    group = _group()
    _setup_logging(args.log_dir, "adapter")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args, train=True)

    # Adam without clipping or decay on the adapter alone (the JAX CLI's
    # base_transform(None, 0.0) and freeze_mask): the step gives no other
    # parameter a gradient, so the towers stay as they are
    label_fn = make_label_fn(["adapter"])
    optimizer = make_optimizer(model, label_fn, weight_decay=0.0)
    prep = dict(image_size=cfg.model.image_size, mean=cfg.augment.mean, std=cfg.augment.std,
                compute_dtype=_compute_dtype(args))
    step = make_adapter_train_step(model, optimizer, label_fn, **_dp(group), **prep)
    eval_step = make_adapter_eval_step(model, **_dp(group), **prep)
    train_loader, val_loader = _loaders(cfg, args, multi_view=True)

    def to_single_view(batch):
        return {"images": _step_images(batch, single_view=True),
                "labels": np.asarray(batch["labels"]),
                "mask": batch.get("mask")}

    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, cfg.train.max_checkpoints_to_keep)
    state, start_epoch = resume_or_init(ckpt, TrainState(model, optimizer))
    state = _replicated(state)
    state, history = fit(
        state, step, eval_step,
        train_loader_fn=lambda: _feed(args, map(to_single_view, train_loader)),
        val_loader_fn=lambda: _feed(args, map(to_single_view, val_loader)),
        base_lrs={"adapter": cfg.train.lr, "default": 0.0},
        num_epochs=args.epochs or cfg.train.num_epochs,
        rng_stream=_rng_stream(args, cfg),
        scheduler="none",
        early_stop_patience=cfg.train.early_stop_patience,
        checkpointer=ckpt,
        start_epoch=start_epoch,
        log_every=cfg.train.log_every,
    )
    # final test-set suite from the ADAPTER logits — the metric family the
    # reference publishes for phase B (02 nb cell 30: Jaccard / Hamming /
    # F1 / mAP / LRAP; BASELINE.md "C-Adapter" rows) plus per-class AUROC
    val = run_eval(eval_step, state, _feed(args, map(to_single_view, val_loader)))
    if not _primary():
        return 0
    history.save_csv(os.path.join(args.log_dir, "adapter_history.csv"))
    metrics = multilabel_metrics(val["probs"], val["labels"], class_names=DISEASE_LABELS)
    save_predictions_csv(val["probs"], val["labels"], DISEASE_LABELS,
                         os.path.join(args.log_dir, "adapter_predictions.csv"))
    with open(os.path.join(args.log_dir, "adapter_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps({k: v for k, v in metrics.items() if not k.startswith("auroc/")},
                     indent=2))
    print(f"adapter done: {len(history.rows)} epochs")
    return 0


def cmd_zeroshot(args) -> int:
    from ..core.config import DISEASE_LABELS
    from ..zeroshot import (
        ZeroShotEngine,
        prompts_for_family,
        run_dynamic_threshold_eval,
        run_zero_shot_eval,
    )

    cfg = _preset(args)
    _setup_logging(args.log_dir, "zero_shot")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args)
    # with a group, each rank scores its slice of every batch (under --tp its
    # data slice, with its shard of the towers) and holds the batch's logits
    # in rank order; the primary writes the results
    engine = ZeroShotEngine(
        model, tokenizer, DISEASE_LABELS, cfg.zeroshot,
        cfg.augment.mean, cfg.augment.std, cfg.model.image_size,
        cfg.model.max_text_length, _compute_dtype(args),
        use_enhance=cfg.model.use_multimodal_attention, **_engine_layout(args, cfg),
    )
    engine.build_text_features(prompts_for_family(args.prompts, DISEASE_LABELS))
    _, val_loader = _loaders(cfg, args, multi_view=True, shard=False)
    csv = os.path.join(args.log_dir, "zero_shot_results.csv") if _primary() else None
    if args.dynamic or cfg.zeroshot.dynamic_thresholds:
        out = run_dynamic_threshold_eval(
            engine, lambda: iter(val_loader),
            cfg.zeroshot.threshold_calib_frac,
            cfg.zeroshot.threshold_grid_points,
            cfg.zeroshot.frontal_weight, cfg.zeroshot.lateral_weight,
            csv_path=csv,
        )
        if not _primary():
            return 0
        print(json.dumps({"thresholds": out["thresholds"]}, indent=2))
        # persist the calibration so `serve --thresholds` / later evals can
        # reuse it without re-running the two-pass pipeline
        tpath = os.path.join(args.log_dir, "thresholds.json")
        with open(tpath, "w") as f:
            json.dump(out["thresholds"], f, indent=2)
        logging.info("calibrated thresholds → %s", tpath)
    else:
        out = run_zero_shot_eval(engine, val_loader, cfg.zeroshot.top_k, csv)
        if not _primary():
            return 0
    print(json.dumps(
        {k: v for k, v in out["metrics"].items() if not k.startswith("auroc/")},
        indent=2,
    ))
    return 0


def _sample_views(val_loader, index: int):
    """The ``index``-th exam of the multi-view val loader: (its views
    [2, H, W, C] uint8, on the host or, from ``--device-cache``, on the
    device; its labels [C])."""
    idx = index
    for batch in val_loader:
        if idx < len(batch["labels"]):
            break
        idx -= len(batch["labels"])
    return _step_images(batch)[idx], np.asarray(batch["labels"])[idx]


def _overlay_views(args, cfg, views, maps, out_dir: str, name: str, title: str) -> list:
    """Each view's saliency map [2, h, w] upsampled to the image size and
    drawn in JET over the view, saved as ``<out_dir>/<name>_<view>.png``."""
    import torch

    from ..interpret import overlay_cam, upsample_cam
    from ..utils.visualization import save_or_show_image

    size = cfg.model.image_size
    views = torch.as_tensor(views, device=args.device)
    written = []
    for v, view_name in enumerate(("frontal", "lateral")):
        cam = upsample_cam(maps[v : v + 1], size, size)[0]
        overlay = overlay_cam(views[v].float() / 255.0, cam)
        path = os.path.join(out_dir, f"{name}_{view_name}.png")
        save_or_show_image(overlay.cpu().numpy(), path, f"{title} ({view_name})")
        written.append(path)
    return written


def _prep_fp32(args, cfg, views):
    """A sample's views through the image prep (kernel B2) to fp32, as the
    JAX commands prepare them."""
    import torch

    from ..ops.image_prep import preprocess_images

    size = cfg.model.image_size
    return preprocess_images(torch.as_tensor(views, device=args.device), size, size,
                             cfg.augment.mean, cfg.augment.std, torch.float32)


def cmd_gradcam(args) -> int:
    """Grad-CAM over the ResNet tower for one sample, each positive label's
    (or class 0's) map over both views, against the "prediction" bank. In a
    group the primary computes it and writes the PNGs (``--sample_index``
    names an exam of the whole validation set on every process)."""
    return _on_primary(lambda: _gradcam(args))


def _gradcam(args) -> int:
    import torch

    from ..core.config import DISEASE_LABELS
    from ..interpret import gradcam
    from ..zeroshot import prompts_for_family
    from ..zeroshot.engine import encode_prompt_bank

    cfg = _preset(args)
    _setup_logging(args.log_dir, "gradcam")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args)
    _, val_loader = _loaders(cfg, args, multi_view=True, shard=False)
    views, labels = _sample_views(val_loader, args.sample_index)

    @torch.no_grad()
    def encode(ids, mask):
        return model.encode_text(torch.from_numpy(ids).to(args.device),
                                 torch.from_numpy(mask).to(args.device), normalize=True)

    text_features = encode_prompt_bank(
        prompts_for_family("prediction", DISEASE_LABELS), DISEASE_LABELS, encode, tokenizer,
        cfg.model.max_text_length)
    cams, _ = gradcam(model, _prep_fp32(args, cfg, views), text_features.to(args.device))
    positive = [i for i, v in enumerate(labels) if v > 0] or [0]
    out_dir = os.path.join(args.log_dir, "gradcam")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for c in positive:
        disease = DISEASE_LABELS[c]
        written += _overlay_views(args, cfg, views, cams[c],
                                  out_dir, f"sample{args.sample_index}_{disease.replace(' ', '_')}",
                                  disease)
    print(f"wrote {len(written)} Grad-CAM overlays to {out_dir}")
    return 0


def cmd_rollout(args) -> int:
    """ViT attention-rollout saliency for one sample (vit nb cell 34), from
    the ``vit`` preset whatever ``--preset`` says, as in the JAX CLI; in a
    group on the primary, as :func:`cmd_gradcam`."""
    return _on_primary(lambda: _rollout(args))


def _rollout(args) -> int:
    import torch

    from ..interpret import attention_rollout

    cfg = _preset(args, "vit")
    _setup_logging(args.log_dir, "rollout")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args)
    _, val_loader = _loaders(cfg, args, multi_view=True, shard=False)
    views, _ = _sample_views(val_loader, args.sample_index)
    with torch.no_grad():
        _, attns = model.encode_image_sowed(_prep_fp32(args, cfg, views))
    mask = attention_rollout(attns, args.head_fusion, args.discard_ratio)
    out_dir = os.path.join(args.log_dir, "rollout")
    os.makedirs(out_dir, exist_ok=True)
    written = _overlay_views(args, cfg, views, mask, out_dir, f"sample{args.sample_index}",
                             "attention rollout")
    print(f"wrote {len(written)} rollout overlays to {out_dir}")
    return 0


def cmd_eval(args) -> int:
    """The metric suite over the held-out split. In a group every rank loads
    the whole split and scores its slice of every batch; the primary, holding
    the batch's probabilities in rank order, computes the metrics and writes
    them."""
    from ..core.config import DISEASE_LABELS
    from ..evals.metrics import multilabel_metrics
    from ..inference import AdapterEngine, InferenceSession
    from ..utils.visualization import save_predictions_csv

    cfg = _preset(args)
    _setup_logging(args.log_dir, "eval")
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    model = _model(cfg, args)
    group = _dp(_group())
    if getattr(args, "head", "zeroshot") == "adapter":
        # score from the C-ADAPTER classifier (02 nb cell 30 semantics:
        # frontal view, frozen-tower encode, sigmoid(Linear(512,16))) —
        # point it at the checkpoint written by the `adapter` command;
        # a pretrain-only checkpoint restores an UNTRAINED adapter head
        # (structurally identical), so metrics near chance mean the wrong
        # checkpoint was given
        engine = AdapterEngine(model, cfg.augment.mean, cfg.augment.std,
                               cfg.model.image_size, _compute_dtype(args), **group)

        def score(images):
            return engine.probs(images[:, 0])  # the frontal view, the adapter's input
    else:
        session = InferenceSession(
            model, tokenizer, DISEASE_LABELS,
            cfg.augment.mean, cfg.augment.std, cfg.model.image_size,
            max_text_length=cfg.model.max_text_length, **group,
        )

        def score(images):
            _, probs = session(images)
            return probs

    _, val_loader = _loaders(cfg, args, multi_view=True, shard=False)
    probs_all, labels_all = [], []
    for batch in val_loader:
        # the batch goes to the scorer as it is: a batch gathered on the
        # device by --device-cache stays there
        probs = score(batch["images"])
        mask = np.asarray(batch.get("mask", np.ones(len(probs)))).astype(bool)
        probs_all.append(probs[mask])
        labels_all.append(np.asarray(batch["labels"])[mask])
    if not _primary():
        return 0
    probs_cat = np.concatenate(probs_all)
    labels_cat = np.concatenate(labels_all)
    metrics = multilabel_metrics(probs_cat, labels_cat, class_names=DISEASE_LABELS)
    save_predictions_csv(probs_cat, labels_cat, DISEASE_LABELS,
                         os.path.join(args.log_dir, "eval_predictions.csv"))
    if getattr(args, "bootstrap", 0):
        from ..evals.metrics import bootstrap_ci

        metrics = {
            "point": metrics,
            "bootstrap_ci_95": bootstrap_ci(
                probs_cat, labels_cat, n_boot=args.bootstrap,
                class_names=DISEASE_LABELS,
                point=metrics,  # already computed above — don't redo
            ),
        }
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_serve(args) -> int:
    """Dynamic-batching HTTP inference server over the zero-shot engine, or
    the trained C-Adapter with ``--head adapter``, or a program that
    ``tools/export_inference --stablehlo`` wrote with ``--exported DIR``."""
    from ..core.config import DISEASE_LABELS
    from ..serving import ZeroShotService, create_server

    if min(args.buckets) < 1:
        print("error: --buckets entries must be >= 1", file=sys.stderr)
        return 2
    # parse and check the calibration file before the (slow) engine build,
    # so that a bad file fails in milliseconds
    threshold = args.threshold
    if getattr(args, "thresholds", None):
        with open(args.thresholds) as f:
            raw = json.load(f)
        threshold = {}
        for k, v in raw.items():
            try:
                threshold[str(k)] = float(v)
            except (TypeError, ValueError):
                print(f"error: --thresholds[{k!r}] = {v!r} is not a number", file=sys.stderr)
                return 2
        unknown = set(threshold) - set(DISEASE_LABELS)
        if unknown:
            print(f"error: --thresholds has unknown diseases {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        bad = {k: v for k, v in threshold.items() if not 0.0 <= v <= 1.0}
        if bad:
            # a threshold outside [0, 1] pins its disease to always or never
            print("error: --thresholds values must be probabilities in "
                  f"[0, 1]; got {bad}", file=sys.stderr)
            return 2
    cfg = _preset(args)
    _setup_logging(args.log_dir, "serve")
    if args.exported:
        # the program is the model: no checkpoint, no tokenizer, no prompt
        # encoding (the bank and the temperature were baked in at export)
        for flag, why in (("checkpoint", "the artifact carries its own weights"),
                          ("use_ema", "EMA was resolved at export time")):
            if getattr(args, flag, None):
                raise SystemExit(f"--{flag.replace('_', '-')} does not compose with "
                                 f"--exported ({why})")
        if _tp(args) > 1:
            raise SystemExit("--tp does not compose with --exported (the serialized "
                             "module is a single-device program)")
        from ..export import ADAPTER_FILE, SINGLEVIEW_FILE, ExportedEngine

        engine = ExportedEngine(
            args.exported, device=args.device,
            module=ADAPTER_FILE if args.head == "adapter" else SINGLEVIEW_FILE)
        size, labels, checkpoint_info = engine.image_size, engine.disease_list, args.exported
    else:
        if args.head == "adapter" and _tp(args) > 1:
            raise SystemExit("--tp does not compose with --head adapter")
        tokenizer = _tokenizer(args)
        cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
        engine = _live_engine(cfg, args, tokenizer)
        size, labels = cfg.model.image_size, DISEASE_LABELS
        checkpoint_info = args.checkpoint or "fresh"
    if _serve_single(args) and _dp_devices(args) > 1:
        logging.warning("--num-devices %d has no effect with %s: serving on one device",
                        _dp_devices(args), "--exported" if args.exported else "--head adapter")
    group = _group() if _in_group(args) else None
    if group is not None:
        from ..serving import GroupEngine, follow

        if not _primary():
            _follow_quietly(follow, engine, group)
            return 0
        engine = GroupEngine(engine, group, on_failure=_interrupt_main)
    try:
        code = _serve(args, engine, labels, threshold, size, checkpoint_info)
    finally:
        if group is not None:
            engine.stop()
    return 1 if group is not None and engine.failed is not None else code


def _interrupt_main() -> None:
    """A group engine's failure off the main thread: a KeyboardInterrupt
    there, as on Ctrl-C, so that the server shuts down (on the main thread
    the failure raises by itself)."""
    import _thread
    import threading

    if threading.current_thread() is not threading.main_thread():
        _thread.interrupt_main()


def _follow_quietly(follow, engine, group) -> None:
    """A rank other than 0: follow rank 0's batches until its stop. SIGINT
    and SIGTERM are left to rank 0, which broadcasts the stop on either."""
    import signal

    from ..parallel import multihost

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda signum, frame: logging.info(
            "signal %d: waiting for rank 0's stop", signum))
    n = follow(engine, group)
    logging.info("rank %d ran %d batches; stopped by rank 0", multihost.process_index(), n)


def _serve(args, engine, labels, threshold, size: int, checkpoint_info: str) -> int:
    """Warm the buckets, bind, serve until SIGINT or SIGTERM."""
    import signal
    import threading

    from ..serving import ZeroShotService, create_server

    service = ZeroShotService(
        engine, labels, threshold=threshold, buckets=tuple(sorted(args.buckets)),
        max_wait_ms=args.max_wait_ms, image_size=size, max_pending=args.max_pending or None,
    )
    # every bucket runs once before the socket binds, so that no request
    # pays a first launch
    for b in sorted(set(args.buckets)):
        engine.probs(np.zeros((b, size, size, 3), np.uint8))
        logging.info("warmed batch bucket %d", b)
    try:
        server = create_server(service, args.host, args.port, model_info={
            "image_size": size, "checkpoint": checkpoint_info,
            "buckets": sorted(set(args.buckets))})
    except OSError as exc:
        print(f"error: cannot bind {args.host}:{args.port}: {exc}", file=sys.stderr)
        service.close()
        return 2
    host, port = server.server_address[:2]
    logging.info("serving on http://%s:%d (POST /predict, GET /healthz, GET /stats)",
                 host, port)
    previous = {}
    if threading.current_thread() is threading.main_thread():
        def interrupt(signum, frame):
            raise KeyboardInterrupt

        # SIGTERM stops the server as Ctrl-C does (a group's ranks then stop
        # too); SIGINT whatever disposition the process started with (Python
        # leaves it ignored in a background job of a non-interactive shell)
        previous = {sig: signal.signal(sig, interrupt)
                    for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logging.info("shutting down")
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        server.server_close()
        service.close()
    return 0


def _live_engine(cfg, args, tokenizer):
    """The serve command's engine over the model: the zero-shot engine with
    its prompt bank built, or the C-Adapter (``--head adapter``)."""
    from ..core.config import DISEASE_LABELS
    from ..inference import AdapterEngine
    from ..zeroshot import ZeroShotEngine, prompts_for_family

    model = _model(cfg, args)
    size = cfg.model.image_size
    if args.head == "adapter":
        # sigmoid(classifier logits) of a trained C-Adapter checkpoint (the
        # adapter command's --checkpoint-dir): no prompt bank, no text tower
        return AdapterEngine(model, cfg.augment.mean, cfg.augment.std, size,
                             _compute_dtype(args))
    # over a group: each rank's share of every batch (the bank on every rank)
    engine = ZeroShotEngine(
        model, tokenizer, DISEASE_LABELS, cfg.zeroshot, cfg.augment.mean,
        cfg.augment.std, size, cfg.model.max_text_length, _compute_dtype(args),
        use_enhance=cfg.model.use_multimodal_attention, **_engine_layout(args, cfg),
    )
    engine.build_text_features(prompts_for_family(args.prompts, DISEASE_LABELS))
    return engine


def cmd_convert(args) -> int:
    """Checkpoint interop: checkpoint directory / reference .pth / flat
    .safetensors → reference-layout .pth or .safetensors (the reference's
    {epoch, models:{name: state_dict}} contract, 0425/train.py:505-541); in
    a group on the primary alone."""
    return _on_primary(lambda: _convert(args))


def _convert(args) -> int:
    import torch

    from ..inference import load_trained_model
    from ..models.safetensors_io import save_reference_checkpoint_safetensors
    from ..train.checkpoint import (
        CheckpointManager,
        import_reference_checkpoint,
        model_state,
        save_reference_checkpoint,
    )

    if not args.checkpoint:
        print("error: convert requires --checkpoint (checkpoint dir, .pth or "
              ".safetensors)", file=sys.stderr)
        return 2
    if not args.out.endswith((".safetensors", ".pth", ".pt")):
        print("error: --out must end in .safetensors, .pth or .pt", file=sys.stderr)
        return 2
    cfg = _preset(args)
    tokenizer = _tokenizer(args)
    cfg = _apply_tiny(cfg, args, len(tokenizer.vocab))
    if cfg.model.text_moe_experts:
        # the JAX convert raises here too: its export_bert reads a dense
        # MLP in every layer (KeyError 'intermediate'; ROADMAP, reference
        # behaviour copied)
        raise SystemExit("convert --moe-experts: the reference layout (HF BertModel names) "
                         "has no place for a MoE layer's router and experts")
    # fp32 restore: the converted artifact carries full-precision weights
    # whatever the serving compute dtype
    model = load_trained_model(
        args.checkpoint, cfg, torch.float32,
        allow_partial=getattr(args, "allow_partial_restore", False),
        use_ema=getattr(args, "use_ema", False),
        device=args.device,
    )
    epoch = args.epoch
    if epoch is None:
        # the epoch the source checkpoint carries (stamping 0 over a
        # trained checkpoint's epoch loses provenance)
        if args.checkpoint.endswith((".pth", ".pt", ".safetensors")):
            epoch = import_reference_checkpoint(args.checkpoint)["epoch"]
        else:
            epoch = CheckpointManager(args.checkpoint).best_epoch() or 0
    state = model_state(model)
    if args.out.endswith(".safetensors"):
        save_reference_checkpoint_safetensors(state, args.out, epoch=epoch)
    else:
        save_reference_checkpoint(state, args.out, epoch=epoch)
    print(f"wrote {args.out}")
    return 0


def _tower_init_args(sp) -> None:
    sp.add_argument(
        "--init-image-tower", default=None, metavar="FILE",
        help="initialize the image tower from a torchvision "
             "resnet50/vit_b_16 state_dict (.safetensors/.pth/.bin) — "
             "the reference's pretrained=True construction; a restored "
             "checkpoint still wins",
    )
    sp.add_argument(
        "--init-text-tower", default=None, metavar="FILE_OR_DIR",
        help="initialize the text tower from an HF BertModel weight file "
             "or snapshot dir (Bio_ClinicalBERT: model.safetensors / "
             "pytorch_model.bin; 'bert.'-prefixed keys accepted)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clip_for_dl_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--preset", default="zero_shot")
        sp.add_argument("--checkpoint", default=None,
                        help="checkpoint dir, reference .pth or .safetensors")
        sp.add_argument("--checkpoint-dir", default=None)
        sp.add_argument("--vocab", default=None, help="BERT vocab.txt")
        sp.add_argument("--log-dir", default="logs")
        sp.add_argument("--epochs", type=int, default=None)
        sp.add_argument("--fp32", action="store_true")
        sp.add_argument("--synthetic", action="store_true")
        sp.add_argument("--synthetic-samples", type=int, default=64)
        sp.add_argument("--tiny", action="store_true",
                        help="shrink towers for smoke runs")
        sp.add_argument("--reports-csv", default=None,
                        help="labeled reports CSV (overrides preset)")
        sp.add_argument("--projections-csv", default=None)
        sp.add_argument("--image-dir", default=None)
        sp.add_argument("--image-cache", default=None, metavar="DIR",
                        help="preprocessed-image cache directory (built by "
                             "`cache-images`): epochs read decoded uint8 "
                             "rows from a memmap instead of decoding every "
                             "image every epoch")
        sp.add_argument("--device-cache", action="store_true",
                        help="with --image-cache: copy the WHOLE cache to "
                             "device memory once and gather batches on the "
                             "device by index — per batch only the index "
                             "vector crosses from the host (the Indiana set "
                             "is ~225 MB grey-packed). Streams with a "
                             "warning if the set exceeds half the device's "
                             "memory (CLIP_FOR_DL_TPU_HBM_BYTES overrides)")
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--num-devices", type=int, default=None,
                        help="run data-parallel over N devices: N ranks of a "
                             "process group, one a card, each on its slice of "
                             "every global batch (pretrain, train, adapter, "
                             "shared-adapter, zeroshot); under torchrun, the "
                             "group torchrun made; default single-device")
        sp.add_argument("--virtual-devices", type=int, default=None,
                        metavar="N",
                        help="debug: emulate N devices as gloo ranks on the "
                             "CPU, so that --num-devices runs without cards")
        sp.add_argument("--bucket-text", action="store_true",
                        help="length-bucket text batches (identical math, "
                             "faster text tower on short reports)")
        sp.add_argument("--length-grouped", action="store_true",
                        help="with --bucket-text: group each shuffled "
                             "epoch's batches by report length (windowed "
                             "sort, window contents stay random) so short "
                             "batches actually land in the small buckets")
        sp.add_argument("--fast-gelu", action="store_true",
                        help="tanh-approximate GELU in the ViT tower "
                             "(~1e-3 departure from the torchvision-exact "
                             "erf — not for parity runs)")
        sp.add_argument("--fused-mlp", action="store_true",
                        help="the fused MLP block kernel in the ViT layers "
                             "(inference)")
        sp.add_argument("--flash-attention", action="store_true",
                        help="the fused attention kernels in both towers: "
                             "forward and backward, dropout inside the "
                             "kernel, no [B,H,L,L] residual")
        sp.add_argument("--bert-fused-mlp", action="store_true",
                        help="the fused Dense-GELU-Dense training kernels "
                             "in the BERT MLPs: forward and backward, the "
                             "[B,L,3072] intermediate never reaches memory")
        sp.add_argument("--vit-fused-mlp-train", action="store_true",
                        help="the same fused training MLP kernels in the "
                             "ViT tower (dropout-free MLPs only; the "
                             "inference --fused-mlp kernel still wins "
                             "at serving)")
        sp.add_argument("--bf16-attention-probs", action="store_true",
                        help="store attention probabilities in bf16 "
                             "(halves the backward-saved [B,H,L,L] "
                             "softmax residual + its layout copies; "
                             "forward unchanged to bf16 rounding)")
        sp.add_argument("--remat", action="store_true",
                        help="rematerialize the encoder layers (memory ↔ "
                             "recompute; lets B scale ~8x on HBM)")
        sp.add_argument("--remat-policy", default="full",
                        choices=("full", "dots", "dots_no_batch"),
                        help="with --remat: what jax.checkpoint SAVES — "
                             "'dots' keeps MXU results and recomputes only "
                             "elementwise chains (cheapest recompute), "
                             "'full' saves nothing (most memory saved)")
        sp.add_argument("--moe-experts", type=int, default=0, metavar="E",
                        help="Switch-MoE text tower: every other block's "
                             "MLP routes over E experts (0 = dense parity "
                             "path). Pass the SAME value to every command "
                             "that loads a MoE checkpoint — the geometry "
                             "is not stored in the checkpoint")
        sp.add_argument("--allow-partial-restore", action="store_true",
                        help="accept a checkpoint missing some of the "
                             "model's arrays (those stay random-init). "
                             "Default is a hard error — a geometry "
                             "mismatch would otherwise score with "
                             "untrained weights")
        sp.add_argument("--use-ema", action="store_true",
                        help="load the EMA weight slot (written by "
                             "pretrain --ema-decay) instead of the live "
                             "params — errors if the checkpoint has none")
        sp.add_argument("--coordinator", default="localhost:12321",
                        metavar="HOST:PORT",
                        help="multi-host: rank 0's address (tcp://HOST:PORT)")
        sp.add_argument("--num-processes", type=int, default=1,
                        help="multi-host: the number of processes, one a "
                             "card; >1 joins the process group and loads "
                             "each process's strided shard of the data")
        sp.add_argument("--process-id", type=int, default=0,
                        help="with --num-processes")

    sp = sub.add_parser("prep", help="label extraction")
    sp.add_argument("--reports", required=True)
    sp.add_argument("--out", default="indiana_reports_labeled.csv")
    sp.add_argument("--unlabeled-out", default="unlabeled_samples.csv")
    sp.set_defaults(fn=cmd_prep)

    sp = sub.add_parser(
        "cache-images",
        help="decode+resize the image set once into a memmap cache "
             "(pass --image-cache to training/eval commands to use it)",
    )
    sp.add_argument("--image-dir", required=True)
    sp.add_argument("--out", required=True, help="cache directory to write")
    sp.add_argument("--projections-csv", default=None,
                    help="cache exactly this CSV's filename column "
                         "(default: recursive glob of --image-dir)")
    sp.add_argument("--image-size", type=int, default=224)
    sp.add_argument("--workers", type=int, default=8)
    sp.add_argument("--channels", choices=["auto", "rgb"], default="auto",
                    help="auto (default): pack to one uint8 channel when "
                         "every image is grayscale (3x smaller cache and "
                         "host-to-device copy; the same model input — the "
                         "prep kernel broadcasts grey to RGB). rgb: force "
                         "3-channel rows")
    sp.set_defaults(fn=cmd_cache_images)

    sp = sub.add_parser("pretrain", help="CLIP contrastive pretraining")
    common(sp)
    sp.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="parameter-efficient fine-tuning: freeze the "
                         "towers, train rank-RANK LoRA deltas on the "
                         "attention/MLP kernels")
    sp.add_argument("--lora-alpha", type=float, default=16.0, help="with --lora")
    sp.add_argument("--ep", type=int, default=1,
                    help="with --num-devices and --moe-experts: expert-"
                         "parallel degree (N/ep × ep mesh, expert weights "
                         "sharded)")
    sp.add_argument("--pp", type=int, default=0, metavar="S",
                    help="with --num-devices: pipeline-parallel stages for "
                         "the text tower (GPipe microbatch schedule; text "
                         "dropout off inside the pipeline)")
    sp.add_argument("--pp-microbatches", type=int, default=2)
    sp.add_argument("--loss",
                    choices=["clip_self_distill", "info_nce", "siglip"],
                    default=None,
                    help="override the preset's contrastive loss; siglip "
                         "is the pairwise sigmoid loss (Zhai et al. 2023)")
    sp.add_argument("--local-loss", action="store_true",
                    help="with --num-devices: the contrastive loss in "
                         "open-CLIP local-loss block form ([b, B_global] "
                         "a rank, not B_global**2; the same loss and "
                         "gradients); with --loss siglip the ring, [b, b] "
                         "a rank")
    sp.add_argument("--accum-steps", type=int, default=1, metavar="A",
                    help="GradCache gradient accumulation: the towers in A "
                         "microbatches, the contrastive loss and its "
                         "negatives over the full batch")
    sp.add_argument("--bf16-moments", action="store_true",
                    help="store the first Adam moment in bf16 (halves "
                         "that optimizer-state slice; second moment "
                         "stays fp32 for sqrt(nu) dynamic range)")
    sp.add_argument("--warmup-steps", type=int, default=0, metavar="N",
                    help="linear LR warmup over the first N global steps "
                         "(0 = off, the reference's behavior); composes "
                         "with the epoch scheduler and survives resume")
    sp.add_argument("--learnable-temperature", action="store_true",
                    help="train the contrastive temperature (real-CLIP/"
                         "SigLIP semantics): scalar logit_scale "
                         "(clamped s<=100) and, for siglip, logit_bias "
                         "join the params; scalars are excluded from "
                         "weight decay. Resuming such a run needs the "
                         "flag again; inference commands ignore the "
                         "extra scalars")
    sp.add_argument("--ema-decay", type=float, default=0.0, metavar="D",
                    help="keep an exponential moving average of the "
                         "params (decay D, e.g. 0.999; warmup-capped) "
                         "updated after every step; validation "
                         "and the saved checkpoints carry both the live "
                         "and the smoothed weights")
    _tower_init_args(sp)
    sp.set_defaults(fn=cmd_pretrain, preset="pretrain_clip")

    sp = sub.add_parser("train", help="scripts-path multi-view training")
    common(sp)
    sp.add_argument("--warmup-steps", type=int, default=0, metavar="N")
    _tower_init_args(sp)
    sp.set_defaults(fn=cmd_train, preset="scripts_train")

    sp = sub.add_parser("adapter", help="frozen-CLIP C-Adapter training")
    common(sp)
    sp.set_defaults(fn=cmd_adapter, preset="adapter")

    sp = sub.add_parser("shared-adapter", help="shared-embedding adapter")
    common(sp)
    sp.set_defaults(fn=cmd_shared_adapter, preset="adapter")

    sp = sub.add_parser("zeroshot", help="zero-shot evaluation")
    common(sp)
    sp.add_argument("--prompts", default="prediction",
                    choices=["prediction", "basic", "showing", "rich", "findings"],
                    help="'rich' and 'findings' are built from the reports "
                         "table, which this command does not pass: they "
                         "raise, as in the JAX CLI")
    sp.add_argument("--dynamic", action="store_true",
                    help="two-pass dynamic-threshold pipeline")
    sp.add_argument("--tp", type=int, default=1,
                    help="with --num-devices: tensor-parallel degree for "
                         "the transformer towers (N/tp × tp mesh)")
    sp.set_defaults(fn=cmd_zeroshot)

    sp = sub.add_parser("gradcam", help="Grad-CAM saliency maps")
    common(sp)
    sp.add_argument("--sample_index", type=int, default=0)
    sp.set_defaults(fn=cmd_gradcam)

    sp = sub.add_parser("rollout", help="ViT attention-rollout saliency")
    common(sp)
    sp.add_argument("--sample_index", type=int, default=0)
    sp.add_argument("--head-fusion", default="mean", choices=["mean", "max", "min"])
    sp.add_argument("--discard-ratio", type=float, default=0.0,
                    help="zero this share of each row's smallest attention "
                         "entries (never the CLS column) before folding")
    sp.set_defaults(fn=cmd_rollout, preset="vit")

    sp = sub.add_parser("eval", help="metric suite over a checkpoint")
    common(sp)
    sp.add_argument("--bootstrap", type=int, default=0, metavar="B",
                    help="append percentile-bootstrap 95%% confidence "
                         "intervals over B sample resamples to every "
                         "metric (0 = point estimates only)")
    sp.add_argument("--head", default="zeroshot",
                    choices=["zeroshot", "adapter"],
                    help="scoring head: 'zeroshot' = sigmoid(sim*4) vs the "
                         "prompt bank (load_model.py contract); 'adapter' "
                         "= the trained C-Adapter classifier (02 nb cell "
                         "30 contract — use the `adapter` command's "
                         "--checkpoint-dir output)")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("serve", help="dynamic-batching HTTP inference server")
    common(sp)
    sp.add_argument("--prompts", default="prediction",
                    choices=["prediction", "basic", "showing", "rich", "findings"])
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8008)
    sp.add_argument("--threshold", type=float, default=0.5)
    sp.add_argument("--thresholds", default=None, metavar="FILE",
                    help="per-disease threshold JSON (written by "
                         "`zeroshot --dynamic` as thresholds.json); "
                         "overrides --threshold per disease, 0.5 for "
                         "diseases absent from the file")
    sp.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16, 64],
                    help="batch sizes for the micro-batcher, each run once "
                         "before the server binds")
    sp.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="max coalescing wait for a lone request")
    sp.add_argument("--max-pending", type=int, default=256,
                    help="admission bound on the batcher backlog: past "
                         "this many queued requests, new ones get 429 "
                         "(load shedding) instead of unbounded queueing; "
                         "0 = unbounded")
    sp.add_argument("--tp", type=int, default=1,
                    help="with --num-devices: tensor-parallel degree for "
                         "the transformer towers (N/tp × tp mesh)")
    sp.add_argument("--exported", default=None, metavar="DIR",
                    help="serve a deployment artifact (python -m clip_for_dl_tpu_torch.tools."
                         "export_inference --stablehlo) instead of rebuilding the model: "
                         "weights, prompt bank and temperature are baked into the program")
    sp.add_argument("--head", default="zeroshot", choices=["zeroshot", "adapter"],
                    help="'zeroshot' scores against the prompt bank; "
                         "'adapter' deploys a trained C-Adapter checkpoint "
                         "(sigmoid classifier logits, no text tower) — "
                         "with --exported it selects score_adapter.pt2")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "convert",
        help="checkpoint interop: checkpoint dir / .pth / .safetensors → "
             "reference-layout .pth or .safetensors",
    )
    common(sp)
    sp.add_argument("--out", required=True,
                    help="output file (.safetensors, .pth or .pt)")
    sp.add_argument("--epoch", type=int, default=None,
                    help="epoch stamp for the artifact header (default: "
                         "the epoch carried by the source checkpoint, "
                         "0 for fresh-init sources)")
    sp.set_defaults(fn=cmd_convert)
    return p


def _spawn(argv, world: int) -> int:
    """``--num-devices N`` in one launch: the same command line as N ranks
    of a group under ``torchrun``; its exit status. SIGTERM reaching this
    process is passed on, so that a preemption reaches every rank (SIGINT,
    which a terminal sends to every process of its group, is only noted).
    ``torchrun``'s agent exits 1 on either signal; when every rank then
    exits 0 (each notes it under ``ENV_RANK_EXITS``) the status is 0."""
    import signal
    import subprocess
    import tempfile
    import threading

    from ..parallel.multihost import torchrun_command

    with tempfile.TemporaryDirectory() as exits:
        proc = subprocess.Popen(torchrun_command(world, "clip_for_dl_tpu_torch", argv),
                                env=dict(os.environ, **{ENV_RANK_EXITS: exits}))
        signalled = []

        def on_signal(signum, frame):
            signalled.append(signum)
            if signum == signal.SIGTERM:
                proc.send_signal(signum)

        previous = {}
        if threading.current_thread() is threading.main_thread():
            previous = {sig: signal.signal(sig, on_signal)
                        for sig in (signal.SIGTERM, signal.SIGINT)}
        try:
            code = proc.wait()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        if code and signalled and len(os.listdir(exits)) == world:
            logging.info("every rank stopped cleanly on signal %d", signalled[0])
            return 0
        return code


def _note_rank_exit(code) -> None:
    """A rank that ``_spawn`` started, exiting 0: its note for the spawner."""
    exits = os.environ.get(ENV_RANK_EXITS)
    if exits and not code:
        open(os.path.join(exits, os.environ.get("RANK", "0")), "w").close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    code = _lora_refused(args)
    if code is not None:
        return code
    refused = _unported(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    _dp_refused(args)
    from ..parallel import multihost

    joins = (_in_group(args) and not multihost.is_distributed()
             and (multihost.launched() or _strided(args)))
    if (_meshed(args) and _dp_devices(args) > 1 and not joins
            and not multihost.is_distributed()):
        return _spawn(argv, _dp_devices(args))
    try:
        if joins:
            multihost.init_process_group(getattr(args, "coordinator", None), _processes(args),
                                         getattr(args, "process_id", 0),
                                         device="cpu" if _on_cpu(args) else "cuda")
            if _on_cpu(args):
                # the CPU ranks of one host share its cores
                import torch

                torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                          // int(os.environ.get("LOCAL_WORLD_SIZE", 1))))
        args.device = _device(args)
    except RuntimeError as exc:
        print(f"error: {exc} (set {ENV_FORCE_CPU}=1 to run on the CPU)", file=sys.stderr)
        return 1
    try:
        code = args.fn(args)
    finally:
        if joins:
            multihost.destroy()
    _note_rank_exit(code)
    return code


if __name__ == "__main__":
    sys.exit(main())
