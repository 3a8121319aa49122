"""Frozen dataclass configuration tree (copy of ``clip_for_dl_tpu.core.config``).

The port cannot import the JAX package: any ``clip_for_dl_tpu.*`` import runs
its package ``__init__``, which imports jax. So the framework-neutral config
is copied here field for field, default for default;
``tests/test_torch_zeroshot.py`` holds the two copies equal.

Only the presets of the ported slices exist here: ``pretrain_clip`` (the
notebook phase-A constants), ``adapter`` (phase B), ``zero_shot`` (phase C,
which inherits them) and ``vit`` (the ViT-B/16 vision variant).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# The 16 label columns (15 diseases + Normal) of the reference's labeling pass.
DISEASE_LABELS: Tuple[str, ...] = (
    "Cardiomegaly",
    "Pulmonary Atelectasis",
    "Pleural Effusion",
    "Nodule",
    "Infiltrate",
    "Emphysema",
    "Thickening",
    "Hernia",
    "Pulmonary Edema",
    "Pneumonia",
    "Consolidation",
    "Pneumothorax",
    "Fibrosis",
    "Mass",
    "Granuloma",
    "Normal",
)

# OpenAI-CLIP statistics (notebooks) and ImageNet statistics (scripts).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class ModelConfig:
    """Tower + head hyper-parameters. Fields the port does not run yet (the
    ViT training MLP, MoE, remat, learnable temperature) are kept so that a
    config moves between the two packages unchanged."""

    image_tower: str = "resnet50"  # "resnet50" | "vit_b16"
    image_embedding_dim: int = 2048
    text_embedding_dim: int = 768
    shared_embedding_dim: int = 512
    num_classes: int = 16
    image_size: int = 224
    max_text_length: int = 512  # scripts; notebook preset overrides to 200
    temperature: float = 0.07  # scripts; notebook preset overrides to 2.0
    dropout: float = 0.1
    num_attention_heads: int = 8
    vocab_size: int = 28996
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate_dim: int = 3072
    text_max_position: int = 512
    resnet_stages: Tuple[int, ...] = (3, 4, 6, 3)
    resnet_width: int = 64
    space_to_depth: bool = False
    vit_patch: int = 16
    vit_layers: int = 12
    vit_heads: int = 12
    vit_hidden: int = 768
    vit_mlp_dim: int = 3072
    vit_gelu_approximate: bool = False
    vit_fused_mlp: bool = False
    bf16_attention_probs: bool = False
    # BERT and ViT self-attention through the fused attention kernel
    # (ops/flash_attention.py)
    flash_attention: bool = False
    # BERT MLP through the fused Dense→GELU→Dense kernel (ops/mlp_train.py);
    # engages only for bf16 compute with 128-aligned widths
    bert_fused_mlp: bool = False
    vit_fused_mlp_train: bool = False
    learnable_temperature: bool = False
    logit_scale_init: Optional[float] = None
    logit_bias_init: float = -10.0
    use_multimodal_attention: bool = False
    remat: bool = False
    remat_conv: bool = False
    remat_policy: str = "full"
    text_moe_experts: int = 0
    text_moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def with_vit(self) -> "ModelConfig":
        return dataclasses.replace(
            self, image_tower="vit_b16", image_embedding_dim=768
        )


@dataclass(frozen=True)
class AugmentConfig:
    horizontal_flip_prob: float = 0.5
    rotation_degrees: float = 10.0
    translate_frac: float = 0.1
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    enabled: bool = True


@dataclass(frozen=True)
class DataConfig:
    reports_csv: str = "data/indiana_reports_labeled.csv"
    projections_csv: str = "data/indiana_projections.csv"
    image_dir: str = "data/images"
    batch_size: int = 32
    num_workers: int = 4
    split_policy: str = "uid_grouped"  # "uid_grouped" | "report"
    test_size: float = 0.2
    seed: int = 42
    multi_view: bool = True


@dataclass(frozen=True)
class OptimGroup:
    name: str
    lr: float


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 100
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    early_stop_patience: int = 5
    scheduler: str = "cosine"  # "cosine" | "plateau" | "none"
    plateau_patience: int = 1
    plateau_factor: float = 0.8
    eta_min: float = 1e-6
    loss: str = "multilabel_contrastive"
    groups: Tuple[OptimGroup, ...] = ()
    checkpoint_dir: str = "checkpoints"
    max_checkpoints_to_keep: int = 3
    save_every_epoch: bool = True
    log_every: int = 10
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = False
    donate_state: bool = True


@dataclass(frozen=True)
class ZeroShotConfig:
    threshold: float = 0.5
    top_k: int = 3
    temperature: float = 0.5  # zero-shot similarity temperature
    inference_logit_scale: float = 4.0
    prompt_family: str = "rich"  # "rich" | "basic" | "findings"
    predictor: str = "sigmoid"  # "sigmoid" | "softmax_topk"
    dynamic_thresholds: bool = False
    threshold_calib_frac: float = 0.25
    threshold_grid_points: int = 20
    frontal_weight: float = 1.0
    lateral_weight: float = 0.8


@dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    num_devices: Optional[int] = None


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    zeroshot: ZeroShotConfig = field(default_factory=ZeroShotConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def preset_pretrain_clip() -> ExperimentConfig:
    """Notebook phase-A CLIP pretrain: batch 16, max_len 200, temperature 2,
    CLIP channel statistics, no augmentation, per-module lrs, plateau."""
    return ExperimentConfig(
        name="pretrain_clip",
        model=ModelConfig(max_text_length=200, temperature=2.0),
        data=DataConfig(batch_size=16, multi_view=False),
        augment=AugmentConfig(enabled=False, mean=CLIP_MEAN, std=CLIP_STD),
        train=TrainConfig(
            num_epochs=10,
            scheduler="plateau",
            weight_decay=1e-3,
            loss="clip_self_distill",
            groups=(
                OptimGroup("image_tower", 1e-4),
                OptimGroup("text_tower", 1e-5),
                OptimGroup("image_projector", 1e-3),
                OptimGroup("text_projector", 1e-3),
            ),
        ),
    )


def preset_adapter() -> ExperimentConfig:
    """Notebook phase-B C-Adapter (02 nb cells 28-29): frozen CLIP + Linear
    classifier, BCE, Adam lr 1e-3, 15 epochs."""
    base = preset_pretrain_clip()
    return base.replace(
        name="adapter",
        train=dataclasses.replace(
            base.train,
            num_epochs=15,
            lr=1e-3,
            weight_decay=0.0,
            scheduler="none",
            loss="bce",
            groups=(OptimGroup("adapter", 1e-3),),
        ),
    )


def preset_zero_shot() -> ExperimentConfig:
    """Zero-shot evaluation with the phase-A model constants."""
    return preset_pretrain_clip().replace(name="zero_shot")


def preset_vit() -> ExperimentConfig:
    """ViT-B/16 vision variant (vit_vision notebook cells 24-25): contrastive
    lr 1e-5 for the vision tower."""
    base = preset_pretrain_clip()
    return base.replace(
        name="vit",
        model=base.model.with_vit(),
        train=dataclasses.replace(
            base.train,
            groups=(
                OptimGroup("image_tower", 1e-5),
                OptimGroup("text_tower", 1e-5),
                OptimGroup("image_projector", 1e-3),
                OptimGroup("text_projector", 1e-3),
            ),
        ),
    )


PRESETS = {
    "pretrain_clip": preset_pretrain_clip,
    "adapter": preset_adapter,
    "zero_shot": preset_zero_shot,
    "vit": preset_vit,
}


def get_preset(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
