"""Training coordinator (counterpart of geoguessr_ai_tpu/train/coordinator.py
``train``): SuperGuessr over TinyViT-21M-512 trained on in-memory panorama
records on one device, with periodic validation, early stopping and a
returned summary.

``build_backbone`` also builds the CLIP towers ("clip": ViT-L/14-336,
"clip_b32": ViT-B/32-224) that the serving engine runs.

Not ported yet, and raising ``NotImplementedError`` when asked for:
checkpoints (``checkpoint_dir``, ``resume_path``: orbax directories become
torch files later, ROADMAP Queue 1 item 8), QAT activation storage
(``qat_storage``, item 8), training a CLIP backbone (its freeze rule keeps
``layer{max}`` and ``post_layernorm`` trainable; item 9), the
embedding-only backbone, hierarchical view fusion and a mesh of more than
one device (item 11).
The SQLite and object-store entry points (``main``, ``main_streaming``)
wait for the port of the data modules they read.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import BackboneConfig, TrainConfig
from geoguessr_ai_torch.data.pipeline import (
    PanoramaBatchIterator,
    prefetch_to_device,
)
from geoguessr_ai_torch.geocells.manager import CentroidTable
from geoguessr_ai_torch.models.clip_vit import CLIPEmbed, CLIPVisionConfig
from geoguessr_ai_torch.models.super_guessr import SuperGuessr, init_parameters_
from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.train.state import (
    backbone_freeze_mask,
    create_train_state,
)
from geoguessr_ai_torch.train.steps import eval_step, train_step
from geoguessr_ai_torch.utils.logging import MetricsLogger, StepTimer, logger


def build_backbone(cfg: BackboneConfig, model_config=None):
    """Returns (module, norm_mean, norm_std, image_size).  ``model_config``
    (a TinyViTConfig, or a CLIPVisionConfig for "clip" / "clip_b32")
    replaces the named preset."""
    dtype = getattr(torch, cfg.dtype) if isinstance(cfg.dtype, str) \
        else cfg.dtype
    if cfg.name == "tinyvit":
        if cfg.qat_storage:
            raise NotImplementedError(
                "qat_storage (fake_quant_static_ste storage sites) is not "
                "ported yet (ROADMAP Queue 1 item 8)")
        tv = model_config or TinyViTConfig.tiny_vit_21m_512(dtype=dtype)
        return TinyViT(tv), C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD, \
            tv.image_size
    if cfg.name in ("clip", "clip_b32"):
        preset = (CLIPVisionConfig.vit_l_14_336 if cfg.name == "clip"
                  else CLIPVisionConfig.vit_b_32_224)
        cv = model_config or preset(dtype=dtype)
        return CLIPEmbed(cv), C.CLIP_NORM_MEAN, C.CLIP_NORM_STD, cv.image_size
    if cfg.name == "none":
        raise NotImplementedError(
            "the embedding-only backbone 'none' is not ported yet (ROADMAP "
            "Queue 1 item 9)")
    raise ValueError(f"unknown backbone {cfg.name!r}")


def build_model(cfg: TrainConfig, num_cells: int, model_config=None):
    """Returns (SuperGuessr, norm_mean, norm_std, image_size);
    ``model_config`` as for ``build_backbone``."""
    if not cfg.model.panorama:
        raise NotImplementedError(
            "single-image (panorama=False) SuperGuessr is not ported yet")
    backbone, mean, std, image_size = build_backbone(cfg.model.backbone,
                                                     model_config)
    model = SuperGuessr(num_cells, backbone,
                        embed_dim=cfg.model.backbone.embed_dim,
                        hierarchical=cfg.model.hierarchical)
    return model, mean, std, image_size


def create_state(cfg: TrainConfig, num_cells: int, steps_per_epoch: int,
                 device=None, model_config=None):
    """The model of ``cfg`` (its TinyViT replaced by ``model_config`` when
    given) with seeded random weights (``cfg.seed``) on ``device``, under
    the freeze policy of ``cfg.model.backbone``, in a fresh TrainState.
    Returns (state, norm_mean, norm_std, image_size)."""
    if cfg.model.backbone.name != "tinyvit":
        raise NotImplementedError(
            f"training the {cfg.model.backbone.name!r} backbone is not ported "
            "yet: its freeze rule (layer{max} + post_layernorm trainable) and "
            "the CLIP train slice come later (ROADMAP Queue 1 item 9)")
    model, mean, std, image_size = build_model(cfg, num_cells, model_config)
    init_parameters_(model, cfg.seed)
    model.to(C.resolve_device(device))
    bb = cfg.model.backbone
    mask = None
    if bb.freeze_base or bb.freeze_all_but_last_stage:
        mask = backbone_freeze_mask(
            [n for n, _ in model.named_parameters()],
            freeze_base=bb.freeze_base,
            freeze_all_but_last_stage=bb.freeze_all_but_last_stage)
    state = create_train_state(model, cfg.optimizer, steps_per_epoch,
                               seed=cfg.seed, trainable_mask=mask)
    return state, mean, std, image_size


def _check_single_device(cfg: TrainConfig) -> None:
    mesh = cfg.mesh
    if mesh.model_parallel != 1 or mesh.data_parallel not in (-1, 1):
        raise NotImplementedError(
            "the port trains on one device; a mesh of more than one (data "
            f"{mesh.data_parallel}, model {mesh.model_parallel}) waits for "
            "torch.distributed (ROADMAP Queue 1 item 11)")


def train(
    cfg: TrainConfig,
    pano_train,
    pano_val,
    centroid_table: CentroidTable,
    checkpoint_dir: Optional[str] = None,
    metrics_logger: Optional[MetricsLogger] = None,
    max_steps: Optional[int] = None,
    fetch_fn=None,
    device=None,
) -> Dict:
    """The train loop over panorama records (see
    ``data.pipeline.PanoramaBatchIterator``): seeded random weights
    (``cfg.seed``), the freeze policy of ``cfg.model.backbone``, one
    ``train_step`` per batch, validation every ``eval_every_steps`` and at
    each epoch's end, early stopping on ``cfg.monitored_metric``.

    ``device``: None means the GPU (raises without one); "cpu" runs the
    plain PyTorch path.  Returns a summary dict with the last epoch's and
    the best metrics.
    """
    if checkpoint_dir or cfg.resume_path:
        raise NotImplementedError(
            "checkpoints (orbax directories -> torch files) are not ported "
            "yet (ROADMAP Queue 1 item 8)")
    _check_single_device(cfg)
    dev = C.resolve_device(device)
    steps_per_epoch = max(1, len(pano_train) // cfg.batch_size)
    state, mean, std, image_size = create_state(
        cfg, centroid_table.num_cells, steps_per_epoch, dev)
    centroids = torch.as_tensor(centroid_table.centroids, device=dev)
    mlog = metrics_logger or MetricsLogger()
    timer = StepTimer()

    def preprocess(batch):
        out = {"coords": batch["coords"], "view_mask": batch["view_mask"]}
        out["pixel_values"] = fused_preprocess(batch["pixel_values"], mean,
                                               std, image_size)
        return out

    def make_iter(records, shuffle=False, seed=0):
        return PanoramaBatchIterator(
            records, cfg.batch_size, image_size, shuffle=shuffle, seed=seed,
            decode_threads=cfg.decode_threads, drop_remainder=True,
            fetch_fn=fetch_fn)

    def run_validation(step):
        agg, dists = [], []
        for batch in prefetch_to_device(make_iter(pano_val), dev,
                                        depth=cfg.prefetch_depth):
            m = eval_step(state, preprocess(batch), centroids)
            dists.append(m.pop("dist_km").cpu().numpy())
            agg.append({k: float(v) for k, v in m.items()})
        if not agg:
            return {}
        out = {f"val_{k}": float(np.mean([m[k] for m in agg]))
               for k in agg[0]}
        # the median over every validation sample, not a mean of medians
        out["val_median_km"] = float(np.median(np.concatenate(dists)))
        mlog.log(out, step)
        return out

    global_step = 0
    stale_epochs = 0
    best_value: Optional[float] = None
    summary: Dict = {"epoch": -1, "global_step": 0, "best_value": None,
                     "monitored_value": float("nan")}
    for epoch in range(cfg.num_epochs):
        it = make_iter(pano_train, shuffle=True, seed=cfg.seed + epoch)
        epoch_metrics = []
        t_epoch = time.perf_counter()
        for batch in prefetch_to_device(it, dev, depth=cfg.prefetch_depth):
            state, metrics = train_step(
                state, preprocess(batch), centroids,
                should_smooth_labels=cfg.model.should_smooth_labels,
                grad_accum_steps=cfg.grad_accum_steps)
            timer.tick()
            global_step += 1
            epoch_metrics.append(metrics)
            if global_step % cfg.log_every_steps == 0:
                mlog.log({
                    "train/loss": metrics["loss"],
                    "train/top1": metrics["top1"],
                    "train/top5": metrics["top5"],
                    "train/grad_norm": metrics["grad_norm"],
                    "train/param_norm": metrics["param_norm"],
                    "train/steps_per_sec": timer.steps_per_sec,
                }, global_step)
            if (cfg.eval_every_steps
                    and global_step % cfg.eval_every_steps == 0
                    and len(pano_val) >= cfg.batch_size):
                run_validation(global_step)
            if max_steps is not None and global_step >= max_steps:
                break

        ep = {f"epoch/{k}": float(np.mean([float(m[k]) for m in epoch_metrics]))
              for k in epoch_metrics[0]} if epoch_metrics else {}
        ep["epoch/time_s"] = time.perf_counter() - t_epoch
        mlog.log(ep, global_step)
        val = (run_validation(global_step)
               if len(pano_val) >= cfg.batch_size else {})
        monitored = val.get(cfg.monitored_metric,
                            val.get("val_loss", ep.get("epoch/loss", 0.0)))
        improved = not np.isnan(monitored) and (
            best_value is None
            or (monitored > best_value if cfg.monitored_mode == "max"
                else monitored < best_value))
        if improved:
            best_value = monitored
        stale_epochs = 0 if improved else stale_epochs + 1
        summary = {"epoch": epoch, "global_step": global_step,
                   "monitored_value": monitored, "best_value": best_value,
                   **ep, **val}
        if stale_epochs >= cfg.early_stop_patience:
            logger.info(f"early stop at epoch {epoch}")
            break
        if max_steps is not None and global_step >= max_steps:
            break

    mlog.summary("best_value", best_value)
    return summary
