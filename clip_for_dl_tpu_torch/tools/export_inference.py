"""Export a serving weight set, and with ``--stablehlo`` the four serving
programs (the port's counterpart of ``tools/export_inference.py``).

Takes a checkpoint (a ``CheckpointManager`` directory, a reference ``.pth``
or its ``.safetensors`` mirror, or ``fresh``), folds BatchNorm into the
ResNet convolutions (``models/convert.fold_clip_image_tower``), casts the
matmul, conv and embedding weights to the serving dtype (norms stay fp32,
as ``core.device.cast_matmul_weights`` keeps them) and writes
``weights.safetensors`` and ``manifest.json`` (config, ``fold_bn: true``,
disease labels, preprocessing statistics).
``inference.load_trained_model(OUT, cfg, fold_bn=True)`` loads the weights
back into a ``CXRClip(cfg.model, fold_bn=True)``; :func:`load_folded_model`
does so from the manifest alone.

``--stablehlo`` (the JAX tool's flag; here it writes ``torch.export``
programs, ``clip_for_dl_tpu_torch/export.py``) also writes
``score_multiview.pt2``, ``score_image.pt2`` (the serve command's prompt
bank at the preset's temperature: ``serve --exported OUT`` runs it),
``score_adapter.pt2`` (``serve --exported OUT --head adapter``) and
``encode_text.pt2``, from the folded weights, and records the torch version
and the device they were traced on in the manifest. A program traced on
the CPU (``--cpu``) launches the kernels once it is loaded onto the card.

Usage:
  python -m clip_for_dl_tpu_torch.tools.export_inference --checkpoint ckpts --out serving/
  python -m clip_for_dl_tpu_torch.tools.export_inference --checkpoint ckpts --out serving/ \\
      --stablehlo --dtype bfloat16 --source-size 512 --cpu

It runs on the card unless ``--cpu`` (or ``CLIP_FOR_DL_TPU_FORCE_CPU``)
asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

MANIFEST_FILE = "manifest.json"


def model_config(manifest: dict):
    """The ``ModelConfig`` a manifest records (JSON lists back to tuples)."""
    from ..core.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in manifest["model"].items()})


def load_folded_model(out: str, device=None):
    """The folded model an export directory holds, from its manifest and
    weights, in the manifest's dtype, on ``device`` (the card when None)."""
    import torch

    from ..core.config import get_preset
    from ..inference import load_trained_model

    with open(os.path.join(out, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    cfg = get_preset("zero_shot").replace(model=model_config(manifest))
    dtype = torch.float32 if manifest["dtype"] == "float32" else torch.bfloat16
    return load_trained_model(out, cfg, dtype, device=device, fold_bn=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--preset", default="zero_shot")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--stablehlo", action="store_true",
                   help="also write the four serving programs as torch.export .pt2 files "
                        "(the JAX tool's flag name): weights and prompt features baked in, "
                        "symbolic batch, traced with the kernels as operators that run on "
                        "the CPU and the card")
    p.add_argument("--source-size", type=int, default=0,
                   help="input view height/width baked into the exported scorers' resize "
                        "(default: the model image size, i.e. pre-resized input)")
    p.add_argument("--vocab", default=None,
                   help="BERT vocab.txt for the prompt bank (synthetic dev vocabulary when "
                        "absent)")
    p.add_argument("--prompts", default="prediction",
                   choices=["prediction", "basic", "showing"],
                   help="prompt family baked into the single-view serving scorer (matches "
                        "serve's default)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the programs hold the kernels as operators, so no "
                        "card is needed to produce the artifact)")
    args = p.parse_args(argv)

    import torch

    from ..cli.main import ENV_FORCE_CPU, _tokenizer
    from ..core.config import DISEASE_LABELS, get_preset
    from ..core.device import cast_matmul_weights, require_cuda
    from ..inference import FOLDED_WEIGHTS_FILE, load_trained_model
    from ..models import CXRClip, fold_clip_image_tower
    from ..models.safetensors_io import save_safetensors

    dev = (torch.device("cpu") if args.cpu or os.environ.get(ENV_FORCE_CPU)
           else require_cuda())
    # the tokenizer the CLI builds (vocab file, or its synthetic dev
    # vocabulary): CLI-trained checkpoints hold an embedding table sized to
    # it, and the exported banks must tokenize the same
    tokenizer = _tokenizer(args)
    cfg = get_preset(args.preset)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, vocab_size=len(tokenizer.vocab)))
    if args.tiny:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, image_size=64, max_text_length=32, text_embedding_dim=64,
            text_layers=2, text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
            resnet_stages=(1, 1, 1, 1), resnet_width=16, vit_layers=2, vit_hidden=64,
            vit_heads=2, vit_mlp_dim=128,
        ))

    model = load_trained_model(None if args.checkpoint == "fresh" else args.checkpoint, cfg,
                               torch.float32, device=dev)
    compute = torch.float32 if args.dtype == "float32" else torch.bfloat16
    with torch.device(dev):
        folded = CXRClip(cfg.model, fold_bn=True)
    folded.load_state_dict(fold_clip_image_tower(model.state_dict()))
    del model
    cast_matmul_weights(folded, compute).eval()

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    save_safetensors(folded.state_dict(), os.path.join(out, FOLDED_WEIGHTS_FILE))
    manifest = {
        "model": dataclasses.asdict(cfg.model),
        "fold_bn": True,
        "dtype": args.dtype,
        "disease_labels": list(DISEASE_LABELS),
        "preprocess": {
            "image_size": cfg.model.image_size,
            "mean": list(cfg.augment.mean),
            "std": list(cfg.augment.std),
        },
        "zeroshot": dataclasses.asdict(cfg.zeroshot),
    }
    mpath = os.path.join(out, MANIFEST_FILE)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    n_params = sum(t.numel() for t in folded.parameters())
    print(f"exported {n_params / 1e6:.1f}M params → {out}")

    if args.stablehlo:
        from ..export import (
            ADAPTER_FILE,
            SCORER_FILE,
            SINGLEVIEW_FILE,
            TEXT_ENCODER_FILE,
            export_adapter_scorer,
            export_multiview_scorer,
            export_singleview_scorer,
            export_text_encoder,
            write_artifact,
        )
        from ..zeroshot.engine import encode_prompt_bank
        from ..zeroshot.prompts import create_basic_prompts, prompts_for_family

        size, length = cfg.model.image_size, cfg.model.max_text_length

        @torch.inference_mode()
        def encode(ids, mask):
            return folded.encode_text(torch.as_tensor(ids, device=dev),
                                      torch.as_tensor(mask, device=dev), normalize=True)

        # the programs run the folded tower in the serving dtype: the weights
        # written above
        enc = tokenizer.encode(create_basic_prompts(DISEASE_LABELS), max_length=length)
        text_features = encode(enc["input_ids"], enc["attention_mask"])
        src = args.source_size or size
        mean, std = cfg.augment.mean, cfg.augment.std
        scorer_bytes = export_multiview_scorer(folded, text_features, size, mean, std,
                                               source_hw=(src, src))
        # the serve command's prompt bank (mean-pooled per disease, family
        # --prompts) at the preset's zero-shot temperature
        bank = encode_prompt_bank(prompts_for_family(args.prompts, DISEASE_LABELS),
                                  DISEASE_LABELS, encode, tokenizer, length)
        single_bytes = export_singleview_scorer(
            folded, bank, size, mean, std, temperature=cfg.zeroshot.temperature,
            source_hw=(src, src), compute_dtype=compute)
        # the C-Adapter scorer (meaningful when --checkpoint is an adapter
        # run's output; the head exists either way)
        adapter_bytes = export_adapter_scorer(folded, size, mean, std, source_hw=(src, src),
                                              compute_dtype=compute)
        text_bytes = export_text_encoder(folded, length)
        write_artifact(out, scorer_bytes, text_bytes, singleview_bytes=single_bytes,
                       adapter_bytes=adapter_bytes)
        manifest["stablehlo"] = {
            "torch_version": torch.__version__,
            "traced_on": dev.type,
            "source_hw": [src, src],
            "prompts": args.prompts,
            "temperature": cfg.zeroshot.temperature,
            "files": {"multiview": SCORER_FILE, "singleview": SINGLEVIEW_FILE,
                      "adapter": ADAPTER_FILE, "text_encoder": TEXT_ENCODER_FILE},
        }
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=2)
        print(f"programs: {SCORER_FILE} ({len(scorer_bytes) / 1e6:.1f} MB, input "
              f"[b,2,{src},{src},3] u8), {SINGLEVIEW_FILE} ({len(single_bytes) / 1e6:.1f} MB, "
              f"input [b,{src},{src},3] u8, T={cfg.zeroshot.temperature}, "
              f"prompts={args.prompts}), {ADAPTER_FILE} ({len(adapter_bytes) / 1e6:.1f} MB), "
              f"{TEXT_ENCODER_FILE} ({len(text_bytes) / 1e6:.1f} MB, L={length}); traced on "
              f"{dev.type} with torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
