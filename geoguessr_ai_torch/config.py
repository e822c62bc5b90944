"""Constants, paths and typed configs of the port, copied from
geoguessr_ai_tpu/config.py (the port imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

#: Earth radius of the model-side haversine (m), WGS84 semi-major axis.
EARTH_RADIUS_MODEL_M = 6378137.0

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
# OptimizerConfig, TrainConfig and EmbedBuildConfig with the same fields and
# defaults.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout.  The port trains on one device: data_parallel and
    model_parallel must resolve to 1 (``train.coordinator.train``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    #: -1 = all devices on the data axis.
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Which vision tower feeds SuperGuessr: "tinyvit" (serve and train),
    "clip" or "clip_b32" (serve only)."""

    name: str = "tinyvit"  # "tinyvit" | "clip" | "none" (raw embeddings)
    image_size: int = TINYVIT_IMAGE_SIZE
    embed_dim: int = TINYVIT_EMBED_DIM
    freeze_base: bool = False
    #: Freeze all but the last stage (the reference TinyViT finetune recipe).
    freeze_all_but_last_stage: bool = True
    dtype: str = "bfloat16"  # compute dtype
    #: QAT int8 activation storage in the train step (not ported).
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
    max_grad_norm: float = 1.0
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
    early_stop_patience: int = 10
    monitored_metric: str = "val_loss"
    monitored_mode: str = "min"
    #: Checkpoints are not ported yet: train() raises when this is set.
    resume_path: Optional[str] = None
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
class EmbedBuildConfig:
    """The embedding-dataset builder (``data.embed_builder``)."""

    #: images per device batch; the last batch is padded up to it.
    batch_size: int = 512
    fetch_threads: int = 64
    backbone: BackboneConfig = BackboneConfig()
    #: "none" (the backbone's own dtype) or "static" (static-calibrated int8
    #: MLP GEMMs and int8 storage sites, TinyViT only).
    quant_mode: str = "static"
    #: 0 or 1: one device.  More (or -1, all devices) shards each batch over
    #: a data-parallel mesh: not ported yet, the builder raises.
    data_parallel: int = 0
