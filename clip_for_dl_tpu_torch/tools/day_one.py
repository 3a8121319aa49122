"""The day-one chain of the port, rehearsed on stand-ins (the port's
counterpart of ``tools/day_one.py``). Each stage runs through the port's
command line, ``clip_for_dl_tpu_torch.cli.main.main(argv)``:

    prep                 label extraction
    cache-images         one-time uint8 memmap (grey-packed for CXR sources)
    pretrain             --vocab + --init-image-tower + --init-text-tower
                         (the reference's pretrained=True, 0425/train.py:761-776)
    adapter              frozen-CLIP C-Adapter (phase B)
    zeroshot [--dynamic] union-max and two-pass threshold drivers
    eval [--head adapter]  the metric suite over both heads
    convert              checkpoint → reference .pth and .safetensors

Assets (all optional; each one absent gets a stand-in):

    real_assets/                       (or $CLIP_FOR_DL_REAL_ASSETS)
      indiana_reports.csv + indiana_projections.csv + images/images_normalized/
      vocab.txt                        Bio_ClinicalBERT tokenizer vocab
      resnet50.{safetensors,pth}       torchvision resnet50 weights
      bio_clinicalbert/ or bert.{safetensors,bin}  HF BertModel weights

The stand-ins: a Kaggle layout from ``testing/kaggle.py``; a vocab built
from the layout's reports and the prompts with ``build_tiny_vocab`` (padded to
Bio_ClinicalBERT's 28996 entries at full width, the preset's
``vocab_size``); tower files written from seeded port modules, whose state
dicts carry torchvision's and HF's names.

Usage:
    python -m clip_for_dl_tpu_torch.tools.day_one                   # full width on the card
    python -m clip_for_dl_tpu_torch.tools.day_one --cpu-rehearsal   # --tiny --fp32 on the CPU

The chain runs on the card; ``--cpu-rehearsal`` asks for the CPU (it sets
``CLIP_FOR_DL_TPU_FORCE_CPU``) and runs it at tiny width in fp32. The JAX
tool's last leg (``parity_harness`` against the torch reference) stays
JAX-only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
from typing import Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = os.environ.get("CLIP_FOR_DL_REAL_ASSETS", os.path.join(REPO, "real_assets"))
BIO_CLINICALBERT_VOCAB = 28996  # entries of Bio_ClinicalBERT's vocab.txt


def _find(names: Sequence[str]) -> Optional[str]:
    for name in names:
        p = os.path.join(ASSETS, name)
        if os.path.exists(p):
            return p
    return None


def _check(ok: bool, msg: str) -> None:
    """Acceptance gate that survives ``python -O``."""
    if not ok:
        raise SystemExit(f"day-one gate failed: {msg}")


def _template_texts() -> list:
    """Every template of the report-built prompt families ("rich" in its
    three frequency and three primacy branches, "findings"), filled with
    placeholders."""
    from ..data.frame import Frame
    from ..zeroshot.prompts import create_enhanced_prompts_with_findings, create_rich_prompts

    stats = {f"d{i}": {"frequency": f, "percentage_as_first": q}
             for i, (f, q) in enumerate(((11, 90.0), (6, 60.0), (1, 10.0)))}
    texts = [p for ps in create_rich_prompts(stats).values() for p in ps]
    frame = Frame(["Problems", "Findings"], [{"Problems": "d", "Findings": "f"}])
    return texts + create_enhanced_prompts_with_findings(frame)["d"]


def standin_vocab(reports_csv: str, path: str, size: Optional[int] = None) -> str:
    """vocab.txt of the words of the reports' findings and impressions and
    of the prompts (their templates and the disease names, which the real
    vocab holds and a small corpus may not: a word whose first letter is
    missing tokenizes to [UNK], and prompts alike in all but such a word
    encode alike), the report-built families' templates last, so that the
    other words keep their ids. ``build_tiny_vocab``: the specials, each
    word and its characters as pieces; padded with ``[unused{i}]`` entries
    to ``size`` when given."""
    from ..core.config import DISEASE_LABELS
    from ..data import read_csv
    from ..text import build_tiny_vocab
    from ..text.tokenizer import dev_words

    reports = read_csv(reports_csv)
    words = [w for col in ("findings", "impression") for t in reports.column(col) if t
             for w in t.split()]
    vocab = build_tiny_vocab(words + dev_words(DISEASE_LABELS) + _template_texts())
    tokens = sorted(vocab, key=vocab.get)
    if size is not None:
        _check(len(tokens) <= size, f"{len(tokens)} corpus tokens exceed the vocab's {size}")
        tokens += [f"[unused{i}]" for i in range(size - len(tokens))]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return path


def standin_towers(work: str, model_config, seed: int = 7, device="cpu") -> tuple:
    """Weight files in the layouts ``--init-image-tower`` and
    ``--init-text-tower`` read, at ``model_config``'s geometry: a
    torchvision ResNet state dict (with the ``fc`` head the importer drops)
    and an HF BertModel state dict, from a port ``CXRClip`` seeded with
    ``seed``."""
    import torch

    from ..models import CXRClip, init_weights
    from ..models.safetensors_io import save_safetensors

    with torch.device(device):
        model = CXRClip(model_config)
    init_weights(model, torch.Generator(device).manual_seed(seed))
    image = {k: v.cpu() for k, v in model.image_tower.state_dict().items()}
    if model_config.image_tower == "resnet50":
        image["fc.weight"] = torch.zeros(1000, model.image_tower.out_dim)
        image["fc.bias"] = torch.zeros(1000)
    paths = (os.path.join(work, "image_tower.safetensors"), os.path.join(work, "bert.safetensors"))
    save_safetensors(image, paths[0])
    save_safetensors({k: v.cpu() for k, v in model.text_tower.state_dict().items()}, paths[1])
    return paths


def run_cli(argv) -> None:
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    print(f"$ python -m clip_for_dl_tpu_torch {' '.join(argv)}", flush=True)
    rc = cli.main(list(argv))
    _check(rc == 0, f"{argv[0]} exited with {rc}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="--tiny --fp32 on the CPU (sets CLIP_FOR_DL_TPU_FORCE_CPU); "
                        "default: full width on the card")
    p.add_argument("--work", default=None, help="working dir (default: a temp dir, removed)")
    p.add_argument("--keep", action="store_true")
    p.add_argument("--uids", type=int, default=None,
                   help="exams of the stand-in layout (default 128; 40 with --cpu-rehearsal)")
    args = p.parse_args(argv)
    full = not args.cpu_rehearsal

    if full:
        from ..core.device import require_cuda

        require_cuda()  # before any file is written; the switch does not apply here
    else:
        os.environ["CLIP_FOR_DL_TPU_FORCE_CPU"] = "1"
    from ..core.config import get_preset
    from ..text import load_vocab

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    work = args.work or tempfile.mkdtemp(prefix="day_one_")
    os.makedirs(work, exist_ok=True)
    sizing = [] if full else ["--tiny", "--fp32"]
    image_size = "224" if full else "64"
    report: Dict = {"work": work, "mode": "full" if full else "rehearsal",
                    "assets_dir": ASSETS, "real": {}, "standin": {}}

    # ---- assets ------------------------------------------------------------------
    real_images = os.path.join(ASSETS, "images", "images_normalized")
    projections, reports = _find(["indiana_projections.csv"]), _find(["indiana_reports.csv"])
    if os.path.isdir(real_images) and projections and reports:
        paths = {"reports": reports, "projections": projections, "image_dir": real_images}
        report["real"]["images"] = real_images
    else:
        from ..testing.kaggle import write_kaggle_layout

        n = args.uids or (128 if full else 40)
        sizes = ((512, 512), (600, 512)) if full else ((64, 64), (72, 60))
        paths = write_kaggle_layout(os.path.join(work, "data"), n, sizes=sizes,
                                    empty_findings_every=9, single_view_uids=(5,))
        report["standin"]["images"] = paths["image_dir"]
    vocab = _find(["vocab.txt"])
    if vocab:
        report["real"]["vocab"] = vocab
    else:
        vocab = standin_vocab(paths["reports"], os.path.join(work, "vocab.txt"),
                              BIO_CLINICALBERT_VOCAB if full else None)
        report["standin"]["vocab"] = vocab
    image_w = _find(["resnet50.safetensors", "resnet50.pth", "resnet50.bin"])
    bert_w = _find(["bio_clinicalbert", "bert.safetensors", "bert.bin"])
    if image_w and bert_w and full:
        _check("vocab" in report["real"],
               "real tower weights found but no real vocab.txt — the BERT embedding is "
               "sized for the real 28,996-entry vocab; drop Bio_ClinicalBERT's vocab.txt "
               f"under {ASSETS} first")
        report["real"]["towers"] = [image_w, bert_w]
    else:
        cfg = cli._apply_tiny(get_preset("pretrain_clip"), argparse.Namespace(tiny=not full),
                              len(load_vocab(vocab)))
        image_w, bert_w = standin_towers(work, cfg.model,
                                         device="cuda" if full else "cpu")
        report["standin"]["towers"] = [image_w, bert_w]

    # ---- the chain ---------------------------------------------------------------------
    labeled = os.path.join(work, "indiana_reports_labeled.csv")
    run_cli(["prep", "--reports", paths["reports"], "--out", labeled,
             "--unlabeled-out", os.path.join(work, "unlabeled.csv")])
    cache_dir = os.path.join(work, "image_cache")
    run_cli(["cache-images", "--image-dir", paths["image_dir"], "--out", cache_dir,
             "--projections-csv", paths["projections"], "--image-size", image_size])
    with open(os.path.join(cache_dir, "cache_meta.json")) as f:
        report["cache_channels"] = json.load(f)["channels"]
    _check(report["cache_channels"] == 1, "CXR sources must grey-pack (a colour file in the "
                                          "image dir?)")
    data = ["--reports-csv", labeled, "--projections-csv", paths["projections"],
            "--image-dir", paths["image_dir"], "--image-cache", cache_dir, "--vocab", vocab,
            *sizing]
    kernels = ["--flash-attention", "--bert-fused-mlp"] if full else []
    logs, ckpt, adapter = (os.path.join(work, d) for d in ("logs", "ckpts", "adapter_ckpt"))
    run_cli(["pretrain", *data, *kernels, "--epochs", "1", "--init-image-tower", image_w,
             "--init-text-tower", bert_w, "--checkpoint-dir", ckpt, "--log-dir", logs])
    run_cli(["adapter", *data, *kernels, "--epochs", "1", "--checkpoint", ckpt,
             "--checkpoint-dir", adapter, "--log-dir", logs])
    run_cli(["zeroshot", *data, *kernels, "--checkpoint", ckpt, "--log-dir", logs])
    run_cli(["zeroshot", *data, *kernels, "--checkpoint", ckpt, "--dynamic",
             "--log-dir", logs])
    run_cli(["eval", *data, *kernels, "--checkpoint", adapter, "--log-dir", logs])
    run_cli(["eval", *data, *kernels, "--checkpoint", adapter, "--head", "adapter",
             "--log-dir", logs])
    converted = [os.path.join(work, f"model_day_one.{ext}") for ext in ("pth", "safetensors")]
    for out in converted:
        run_cli(["convert", *sizing, "--vocab", vocab, "--checkpoint", adapter, "--out", out])
    for name in ("training_history.csv", "adapter_history.csv", "adapter_predictions.csv",
                 "zero_shot_results.csv", "thresholds.json", "eval_predictions.csv"):
        _check(os.path.exists(os.path.join(logs, name)), f"the chain wrote no {name}")
    _check(all(os.path.getsize(p) > 0 for p in converted), "convert wrote an empty file")
    report["converted"] = converted

    print(json.dumps(report))
    if not (args.keep or args.work):
        shutil.rmtree(work, ignore_errors=True)
    print("day-one chain OK" + ("" if report["real"] else " (all stand-ins — rehearsal)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
