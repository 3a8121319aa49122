"""Cross-modal attention-weight visualization.

Counterpart of ``clip_for_dl_tpu.interpret.attention_viz`` and of
save_attention_visualization
(multimodal_attention/train.py:1112-1163): per-sample bar heatmaps of the
additive attention weights over the 16 diseases, saved as PNG + raw .npy.
Matplotlib is imported lazily so headless/compute-only environments never
pay for it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def save_attention_weights(
    attn_weights: np.ndarray,
    disease_list: Sequence[str],
    out_dir: str,
    prefix: str = "attention",
    batch_idx: int = 0,
    epoch: int = 0,
    images: Optional[np.ndarray] = None,
    max_samples: int = 4,
) -> list[str]:
    """attn_weights [B, C] (numpy, or a tensor on any device, e.g. the
    second output of ``CXRClip.enhance``) → one PNG per sample + a combined
    .npy dump. Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(attn_weights, torch.Tensor):
        attn_weights = attn_weights.detach().float().cpu().numpy()
    attn = np.asarray(attn_weights)
    paths: list[str] = []

    npy_path = os.path.join(
        out_dir, f"{prefix}_e{epoch}_b{batch_idx}.npy"
    )
    np.save(npy_path, attn)
    paths.append(npy_path)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return paths

    for i in range(min(len(attn), max_samples)):
        ncols = 2 if images is not None else 1
        fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 4))
        axes = np.atleast_1d(axes)
        if images is not None:
            axes[0].imshow(np.asarray(images[i]).squeeze(), cmap="gray")
            axes[0].set_title(f"sample {i}")
            axes[0].axis("off")
        ax = axes[-1]
        ax.bar(range(len(disease_list)), attn[i])
        ax.set_xticks(range(len(disease_list)))
        ax.set_xticklabels(disease_list, rotation=75, fontsize=7)
        ax.set_ylabel("attention weight")
        ax.set_title(f"cross-modal attention (epoch {epoch})")
        fig.tight_layout()
        png = os.path.join(
            out_dir, f"{prefix}_e{epoch}_b{batch_idx}_s{i}.png"
        )
        fig.savefig(png, dpi=110)
        plt.close(fig)
        paths.append(png)
    return paths
