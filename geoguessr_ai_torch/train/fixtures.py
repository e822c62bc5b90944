"""Train inputs made from the fixture panorama (tests/fixtures): records
for ``train()`` and a ready TrainState with one device batch, for smoke
runs, profiling and examples that need no dataset."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import BackboneConfig, ModelConfig, TrainConfig
from geoguessr_ai_torch.data.pipeline import PanoramaBatchIterator
from geoguessr_ai_torch.geocells.manager import CentroidTable
from geoguessr_ai_torch.inference import fixture_panorama
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.train.coordinator import create_state


def fixture_records(n: int, seed: int = 0):
    """``n`` panorama records of the fixture views with seeded random
    (lat, lon), in the form ``train()`` reads."""
    blobs = []
    for p in fixture_panorama():
        with open(p, "rb") as f:
            blobs.append(f.read())
    rng = np.random.default_rng(seed)
    return [{"location_id": f"fixture{i}", "lat": float(rng.uniform(-60, 70)),
             "lon": float(rng.uniform(-180, 180)), "images": blobs}
            for i in range(n)]


def fixture_train_setup(batch_size: int = 16, device=None, seed: int = 0,
                        dtype: str = "bfloat16", model_config=None,
                        backbone: str = "tinyvit", mesh=None):
    """A full-width TrainState (default TrainConfig: f32 master weights,
    freeze_all_but_last_stage, AdamW) over ``backbone`` ("tinyvit",
    "clip" or "clip_b32"; ``model_config``, a TinyViTConfig or a
    CLIPVisionConfig, replaces its preset) and one device batch of
    ``batch_size`` fixture panoramas.  The pixels are normalised in f32 on
    the host, so a bf16 and an f32 model see the same input.  ``mesh``: the
    model is sharded on it (``create_state``); the batch stays whole.
    Returns (state, batch, centroids)."""
    bb = dataclasses.replace(getattr(BackboneConfig, backbone)(),
                             dtype=dtype)
    cfg = TrainConfig(batch_size=batch_size, seed=seed,
                      model=ModelConfig(backbone=bb))
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    dev = C.resolve_device(device)
    state, mean, std, size = create_state(cfg, table.num_cells, 1, dev,
                                          model_config, mesh)
    host = next(iter(PanoramaBatchIterator(fixture_records(batch_size, seed),
                                           batch_size, size)))
    pixels = fused_preprocess(torch.from_numpy(host["pixel_values"]), mean,
                              std, size, dtype=torch.float32)
    batch = {"pixel_values": pixels.to(dev),
             "view_mask": torch.from_numpy(host["view_mask"]).to(dev),
             "coords": torch.from_numpy(host["coords"]).to(dev)}
    return state, batch, torch.as_tensor(table.centroids, device=dev)
