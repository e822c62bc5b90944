"""The reference's train/eval loop entry points (counterpart of
geoguessr_ai_tpu/train/train_eval_loop.py): ``generate_profiler``,
``train_model`` and ``evaluate_model`` with the JAX package's signatures,
as adapters onto the coordinator's ``train`` and ``eval_step``.

Datasets are the port's panorama records (``data.sqlite_dataset``
Panoramas, dicts or namedtuples; no pandas).  One device: ``mesh_cfg`` of
more than one raises (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from geoguessr_ai_torch.config import MeshConfig, TrainConfig
from geoguessr_ai_torch.utils.profiling import ProfileSchedule, StepProfiler


def generate_profiler(log_dir: str = "runs/profile") -> StepProfiler:
    """A step()-able profiler with schedule(wait=2, warmup=2, active=10,
    repeat=2)."""
    return StepProfiler(
        log_dir, ProfileSchedule(wait=2, warmup=2, active=10, repeat=2))


def train_model(
    model_cfg: Optional[TrainConfig] = None,
    train_dataset=None,
    val_dataset=None,
    centroid_table=None,
    num_epochs: Optional[int] = None,
    batch_size: Optional[int] = None,
    learning_rate: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    refiner=None,
    max_steps: Optional[int] = None,
    device=None,
) -> Dict:
    """Trains SuperGuessr (``train.coordinator.train``) and returns its
    summary.  The scalar overrides replace ``model_cfg``'s fields; without
    a train dataset the newest SQLite dataset is split by
    ``val_fraction``; the centroid table defaults to the repo's.
    ``refiner`` is accepted for the reference's signature and unused, as
    in the JAX package.  ``device`` None means the GPU."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.data.sqlite_dataset import (
        load_sqlite_panorama_dataset,
        split_train_val,
    )
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.train.coordinator import discover_sqlite, train

    cfg = model_cfg or TrainConfig()
    updates: Dict[str, Any] = {}
    if num_epochs is not None:
        updates["num_epochs"] = num_epochs
    if batch_size is not None:
        updates["batch_size"] = batch_size
    if learning_rate is not None:
        updates["optimizer"] = dataclasses.replace(
            cfg.optimizer, learning_rate=learning_rate)
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    if centroid_table is None:
        centroid_table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    if train_dataset is None:
        pano = load_sqlite_panorama_dataset(discover_sqlite())
        train_dataset, val_dataset = split_train_val(pano, cfg.val_fraction)
    return train(cfg, train_dataset,
                 val_dataset if val_dataset is not None else [],
                 centroid_table, checkpoint_dir=checkpoint_dir,
                 max_steps=max_steps, device=device)


def evaluate_model(
    state=None,
    eval_dataset=None,
    centroid_table=None,
    batch_size: int = 16,
    refiner=None,
    model=None,
    mesh_cfg: Optional[MeshConfig] = None,
) -> Dict:
    """Evaluates a TrainState's model (or ``model``) on panorama records
    on the model's device: the mean over full batches of eval_step's
    metrics (loss, geocell top-1/top-5, mean km, score) and the median km
    over every sample; ``"refined": True`` when a refiner is given (its
    refinement is applied per batch by callers, as in the JAX package)."""
    import torch

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.data.pipeline import (
        PanoramaBatchIterator,
        prefetch_to_device,
    )
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.models.clip_vit import CLIPEmbed
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess
    from geoguessr_ai_torch.train.steps import eval_step

    if state is None or eval_dataset is None:
        raise ValueError("evaluate_model needs a state and an eval_dataset")
    mesh_cfg = mesh_cfg or MeshConfig()
    if mesh_cfg.model_parallel != 1 or mesh_cfg.data_parallel not in (-1, 1):
        raise NotImplementedError(
            "the port evaluates on one device; a mesh of more than one waits "
            "for torch.distributed (ROADMAP Queue 1 item 11)")
    model = model or state.model
    if model.backbone is None:
        raise ValueError("evaluate_model reads panorama images: the model "
                         "has no backbone")
    dev = next(model.parameters()).device
    table = centroid_table or CentroidTable.load(C.CENTROID_TABLE_PATH)
    centroids = torch.as_tensor(table.centroids, device=dev)
    image_size = model.backbone.config.image_size
    # normalization follows the backbone: CLIP's statistics differ
    if isinstance(model.backbone, CLIPEmbed):
        mean, std = C.CLIP_NORM_MEAN, C.CLIP_NORM_STD
    else:
        mean, std = C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD
    evaluated = dataclasses.replace(state, model=model)
    agg = []
    it = PanoramaBatchIterator(eval_dataset, batch_size, image_size,
                               drop_remainder=True)
    for batch in prefetch_to_device(it, dev, depth=2):
        px = fused_preprocess(batch["pixel_values"], mean, std, image_size)
        agg.append(eval_step(evaluated, {"pixel_values": px,
                                         "coords": batch["coords"],
                                         "view_mask": batch["view_mask"]},
                             centroids))
    if not agg:
        return {}
    dists = [m.pop("dist_km").cpu().numpy() for m in agg]
    out = {k: float(np.mean([float(m[k]) for m in agg])) for k in agg[0]}
    # the median over every sample, not a mean of batch medians
    out["median_km"] = float(np.median(np.concatenate(dists)))
    if refiner is not None:
        out["refined"] = True
    return out
