"""Constants, paths and typed configs of the port, copied from
geoguessr_ai_tpu/config.py (the port imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

#: Earth radius of the model-side haversine (m), WGS84 semi-major axis.
EARTH_RADIUS_MODEL_M = 6378137.0
#: Earth radius of the benchmark's scoring haversine (m), the mean radius.
EARTH_RADIUS_BENCH_M = 6371000.0
#: WGS84 flattening factor.
WGS84_FLATTENING = 1.0 / 298.257223563

#: Haversine label-smoothing constant (km).
LABEL_SMOOTHING_CONSTANT_KM = 65.0

#: GeoGuessr score decay constant (km): score = 5000*exp(-d/DECAY).
GEOGUESSR_DECAY_CONSTANT_KM = 1492.7

TINYVIT_EMBED_DIM = 576
TINYVIT_IMAGE_SIZE = 512
TINYVIT_NORM_MEAN = (0.485, 0.456, 0.406)  # ImageNet stats (timm data cfg)
TINYVIT_NORM_STD = (0.229, 0.224, 0.225)

#: CLIP ViT-L/14-336, the reference's own embedder (its HF id is
#: "openai/clip-vit-large-patch14-336"; no weights ship with the repo).
CLIP_EMBED_DIM = 1024
CLIP_IMAGE_SIZE = 336
CLIP_NORM_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_NORM_STD = (0.26862954, 0.26130258, 0.27577711)

#: Panorama views per location (4 headings).
NUM_PANORAMA_VIEWS = 4

#: Default top-k geocell candidates handed to the refiner.
NUM_CANDIDATES = 5

#: Heads of the hierarchical view fusion's self-attention.
NUM_ATTENTION_HEADS = 16

#: Geocell generation bounds: cells under GENERATOR_MIN_POINTS points are
#: combined into a neighbour, cells over GENERATOR_MAX_POINTS are split.
GENERATOR_MIN_POINTS = 10
GENERATOR_MAX_POINTS = 67

#: Paths, with the JAX package's environment overrides.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.environ.get("GEO_TPU_DATA_DIR", os.path.join(REPO_ROOT, "data"))
GEOCELL_DIR = os.environ.get(
    "GEO_TPU_GEOCELL_DIR", os.path.join(DATA_DIR, "geocells")
)
#: Pre-built centroid table artifact: (num_cells, 2) float32 (lng, lat).
CENTROID_TABLE_PATH = os.environ.get(
    "GEO_TPU_CENTROIDS", os.path.join(GEOCELL_DIR, "centroid_table.npz")
)
#: Where ``train.coordinator.main`` keeps its checkpoints.
CHECKPOINT_DIR = os.environ.get(
    "GEO_TPU_CKPT_DIR", os.path.join(REPO_ROOT, "checkpoints")
)
#: The object store's bucket (``data.s3.ObjectStore`` opens
#: ``s3://{S3_BUCKET}`` unless ``GEO_TPU_STORE_URL`` names another store).
S3_BUCKET = os.environ.get("GEO_TPU_S3_BUCKET", "cogito-geoguessr")


def resolve_device(device=None):
    """``None`` means the GPU.  Raises when CUDA is asked for and absent:
    the port never carries on on the CPU unless the caller asks for it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Typed configs: the JAX package's MeshConfig, BackboneConfig, ModelConfig,
# OptimizerConfig, TrainConfig, PretrainConfig and EmbedBuildConfig with the
# same fields and defaults.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout: a (data, model) mesh over the ranks of the process
    group, one rank a card (``parallel.mesh.create_mesh``).  dp * mp must
    equal the number of ranks (ValueError otherwise); one process is the
    1 x 1 mesh."""

    data_axis: str = "data"
    model_axis: str = "model"
    #: -1 = all devices on the data axis.
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Which vision tower feeds SuperGuessr: "tinyvit", "clip" (ViT-L/14-336)
    or "clip_b32" (ViT-B/32-224), each served and trained, or "none"
    (train the head on precomputed embeddings)."""

    name: str = "tinyvit"  # "tinyvit" | "clip" | "none" (raw embeddings)
    image_size: int = TINYVIT_IMAGE_SIZE
    embed_dim: int = TINYVIT_EMBED_DIM
    freeze_base: bool = False
    #: Freeze all but the last stage (the reference TinyViT finetune recipe).
    freeze_all_but_last_stage: bool = True
    dtype: str = "bfloat16"  # compute dtype
    #: QAT int8 activation storage in the train step: TinyViT's
    #: TRAIN_QUANT_SITES through fake_quant_static_ste, calibrated once at
    #: start-up.
    qat_storage: bool = False

    @staticmethod
    def tinyvit() -> "BackboneConfig":
        return BackboneConfig(name="tinyvit", image_size=TINYVIT_IMAGE_SIZE,
                              embed_dim=TINYVIT_EMBED_DIM)

    @staticmethod
    def clip() -> "BackboneConfig":
        return BackboneConfig(name="clip", image_size=CLIP_IMAGE_SIZE,
                              embed_dim=CLIP_EMBED_DIM)

    @staticmethod
    def clip_b32() -> "BackboneConfig":
        """CLIP ViT-B/32 at 224 px (batch embedding extraction)."""
        return BackboneConfig(name="clip_b32", image_size=224, embed_dim=768)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SuperGuessr head configuration."""

    backbone: BackboneConfig = BackboneConfig()
    panorama: bool = True
    hierarchical: bool = False
    should_smooth_labels: bool = True
    num_candidates: int = NUM_CANDIDATES
    embed_dim: int = TINYVIT_EMBED_DIM
    num_cells: int = 12623  # overridden by the centroid table at build time


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + cosine warm restarts."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    #: Global-norm clipping threshold; None clips nothing (the country
    #: finetune's bare adamw).
    max_grad_norm: Optional[float] = 1.0
    #: CosineAnnealingWarmRestarts T_0 (in epochs).
    cosine_t0: int = 1
    cosine_t_mult: int = 2
    warmup_steps: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop settings."""

    seed: int = 330
    batch_size: int = 24  # panoramas per step
    num_epochs: int = 1000
    eval_every_steps: int = 1000
    log_every_steps: int = 10
    #: Checkpoint retention: keep last + best + top-K epoch checkpoints.
    keep_last_n: int = 3
    #: Write checkpoints on a background thread after a synchronous copy
    #: to the host (train.checkpoints).
    async_checkpoints: bool = False
    early_stop_patience: int = 10
    monitored_metric: str = "val_loss"
    monitored_mode: str = "min"
    #: A checkpoint directory to resume from (e.g. <run>/last).
    resume_path: Optional[str] = None
    val_fraction: float = 0.1
    optimizer: OptimizerConfig = OptimizerConfig()
    mesh: MeshConfig = MeshConfig()
    model: ModelConfig = ModelConfig()
    #: Split each step into this many microbatches, accumulating the
    #: gradients in bf16 (``train.steps.train_step``).
    grad_accum_steps: int = 1
    #: Host pipeline
    prefetch_depth: int = 2
    decode_threads: int = 8


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """CLIP contrastive pretraining (``train.pretrain_clip.pretrain``)."""

    seed: int = 42
    batch_size: int = 960
    grad_accum_steps: int = 8
    learning_rate: float = 1e-6
    weight_decay: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    num_epochs: int = 20
    warmup_ratio: float = 0.2
    lr_schedule: str = "linear"
    eval_every_steps: int = 50
    save_every_steps: int = 50
    mesh: MeshConfig = MeshConfig()


@dataclasses.dataclass(frozen=True)
class EmbedBuildConfig:
    """The embedding-dataset builder (``data.embed_builder``)."""

    #: images per device batch; the last batch is padded up to it.
    batch_size: int = 512
    fetch_threads: int = 64
    backbone: BackboneConfig = BackboneConfig()
    #: "none" (the backbone's own dtype) or "static" (static-calibrated int8
    #: MLP GEMMs and int8 storage sites, TinyViT only).
    quant_mode: str = "static"
    #: 0 or 1: one device.  More (or -1, all ranks) embeds on a data axis
    #: over the process group: each rank its share of the rows, one SQLite
    #: written by rank 0 (``data.embed_builder``).
    data_parallel: int = 0
