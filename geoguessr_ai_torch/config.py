"""Constants and paths of the port, copied from geoguessr_ai_tpu/config.py
(the port imports nothing of the JAX package)."""

from __future__ import annotations

import os

#: Earth radius of the model-side haversine (m), WGS84 semi-major axis.
EARTH_RADIUS_MODEL_M = 6378137.0

TINYVIT_NORM_MEAN = (0.485, 0.456, 0.406)  # ImageNet stats (timm data cfg)
TINYVIT_NORM_STD = (0.229, 0.224, 0.225)

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
