"""Training coordinator (counterpart of geoguessr_ai_tpu/train/coordinator.py
``train`` and ``main``): SuperGuessr over TinyViT-21M-512 or a CLIP tower
("clip": ViT-L/14-336, "clip_b32": ViT-B/32-224), or the head alone on
precomputed embeddings (backbone "none"), trained on panorama records on
one device, with periodic validation, last/best/top-K checkpoints and
resume (``train.checkpoints``), early stopping and a returned summary.
``freeze_all_but_last_stage`` keeps TinyViT's last stage, or a CLIP
tower's last layer and ``post_layernorm``, trainable
(``train.state.backbone_freeze_mask``).  ``main`` is the production
entry: the newest SQLite dataset, split by ``val_fraction``, checkpoints
under ``CHECKPOINT_DIR``.  A CLIP run's checkpoint directories serve
through ``ServingEngine(backbone="clip", checkpoint=<run>/best)``.

``discover_sqlite`` finds the newest SQLite dataset.

Not ported, and raising ``NotImplementedError`` when asked for: a mesh of
more than one device (ROADMAP Queue 1 item 11).  ``main_streaming``
(training off the object store) waits for the port of ``data/s3.py`` and
``data/streaming.py`` (item 8).  A single-image model (``panorama=False``)
is refused with a ValueError, as the JAX ``train()`` fails on it: its
batch iterators always yield a view axis.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import BackboneConfig, TrainConfig
from geoguessr_ai_torch.data.pipeline import (
    EmbeddingBatchIterator,
    PanoramaBatchIterator,
    prefetch_to_device,
)
from geoguessr_ai_torch.data.sqlite_dataset import (
    load_sqlite_panorama_dataset,
    split_train_val,
)
from geoguessr_ai_torch.geocells.manager import CentroidTable
from geoguessr_ai_torch.models.clip_vit import CLIPEmbed, CLIPVisionConfig
from geoguessr_ai_torch.models.super_guessr import SuperGuessr, init_parameters_
from geoguessr_ai_torch.models.tinyvit import (
    TRAIN_QUANT_SITES,
    TinyViT,
    TinyViTConfig,
)
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.ops.quant import calibrate_act_stats
from geoguessr_ai_torch.train.checkpoints import (
    CheckpointConfig,
    CheckpointStore,
)
from geoguessr_ai_torch.train.state import (
    backbone_freeze_mask,
    create_train_state,
)
from geoguessr_ai_torch.train.steps import eval_step, train_step
from geoguessr_ai_torch.utils.logging import MetricsLogger, StepTimer, logger


def default_sqlite_dirs() -> List[str]:
    """Where ``discover_sqlite`` looks when it is given no directories."""
    return [C.REPO_ROOT, C.DATA_DIR]


def discover_sqlite(search_dirs: Optional[Iterable[str]] = None) -> str:
    """The newest ``dataset_sqlite*.sqlite`` in ``search_dirs``, by default
    the repo's root and its data directory; ``DATASET_SQLITE_PATH``
    overrides the search.  Unlike the JAX package's search, the default
    does not look in the directory around the repo: a file there belongs
    to no checkout of this one."""
    env = os.environ.get("DATASET_SQLITE_PATH")
    if env:
        return env
    if search_dirs is None:
        search_dirs = default_sqlite_dirs()
    candidates = []
    for d in search_dirs:
        candidates.extend(glob.glob(os.path.join(d, "dataset_sqlite*.sqlite")))
    if not candidates:
        raise FileNotFoundError(
            f"no dataset_sqlite*.sqlite found in {list(search_dirs)}")
    return max(candidates, key=os.path.getmtime)


def build_backbone(cfg: BackboneConfig, model_config=None):
    """Returns (module, norm_mean, norm_std, image_size), all None for
    "none" (embedding-only training).  ``model_config`` (a TinyViTConfig,
    or a CLIPVisionConfig for "clip" / "clip_b32") replaces the named
    preset.  ``qat_storage`` turns TinyViT's storage sites
    (``TRAIN_QUANT_SITES``) to static int8 with a straight-through
    gradient."""
    dtype = getattr(torch, cfg.dtype) if isinstance(cfg.dtype, str) \
        else cfg.dtype
    if cfg.name == "tinyvit":
        tv = model_config or TinyViTConfig.tiny_vit_21m_512(dtype=dtype)
        if cfg.qat_storage:
            tv = dataclasses.replace(tv, quant_mode="static",
                                     quant_sites=TRAIN_QUANT_SITES)
        return TinyViT(tv), C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD, \
            tv.image_size
    if cfg.name in ("clip", "clip_b32"):
        preset = (CLIPVisionConfig.vit_l_14_336 if cfg.name == "clip"
                  else CLIPVisionConfig.vit_b_32_224)
        cv = model_config or preset(dtype=dtype)
        return CLIPEmbed(cv), C.CLIP_NORM_MEAN, C.CLIP_NORM_STD, cv.image_size
    if cfg.name == "none":
        return None, None, None, None
    raise ValueError(f"unknown backbone {cfg.name!r}")


def build_model(cfg: TrainConfig, num_cells: int, model_config=None):
    """Returns (SuperGuessr, norm_mean, norm_std, image_size);
    ``model_config`` as for ``build_backbone``.  The view fusion's
    attention computes in bf16 whatever the backbone's dtype, as the JAX
    package builds it."""
    backbone, mean, std, image_size = build_backbone(cfg.model.backbone,
                                                     model_config)
    model = SuperGuessr(num_cells, backbone,
                        embed_dim=cfg.model.backbone.embed_dim,
                        hierarchical=cfg.model.hierarchical,
                        panorama=cfg.model.panorama)
    return model, mean, std, image_size


def calibrate_qat_(model: SuperGuessr, seed: int, image_size: int) -> None:
    """Sets a static-quant TinyViT backbone's ``act_scales`` from one f32
    calibrate forward on the CPU over a seeded N(0, 1) batch of one
    panorama (or one image), at the model's current weights.  As in the
    JAX package the scales are taken once, at start-up, from the initial
    weights; the straight-through estimator clips activations that later
    run hotter."""
    views = (C.NUM_PANORAMA_VIEWS,) if model.panorama else ()
    shape = (1,) + views + (image_size, image_size, 3)
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape)
                         .astype(np.float32))
    cal = TinyViT(dataclasses.replace(model.backbone.config,
                                      quant_mode="calibrate",
                                      dtype=torch.float32))
    weights = {k: v.detach().cpu() for k, v in
               model.backbone.state_dict().items()
               if not k.startswith(TinyViT._ACT_COLLECTIONS)}
    cal.load_state_dict(weights, strict=True)
    cal.eval()

    def apply_calibrate(variables, xx):
        cal.act_stats = variables.get("act_stats", {})
        with torch.inference_mode():
            out = cal(xx.reshape((-1,) + xx.shape[-3:]))
        return out, {"act_stats": dict(cal.act_stats)}

    stats = calibrate_act_stats(apply_calibrate, {}, [x])
    model.backbone.act_scales = stats


def create_state(cfg: TrainConfig, num_cells: int, steps_per_epoch: int,
                 device=None, model_config=None):
    """The model of ``cfg`` (its backbone's preset replaced by
    ``model_config`` when given) with seeded random weights (``cfg.seed``),
    its QAT scales calibrated when ``qat_storage``, on ``device``, under the
    freeze policy of ``cfg.model.backbone``, in a fresh TrainState.
    Returns (state, norm_mean, norm_std, image_size); image_size falls back
    to the backbone config's for embedding-only training."""
    model, mean, std, image_size = build_model(cfg, num_cells, model_config)
    if image_size is None:
        image_size = cfg.model.backbone.image_size
    init_parameters_(model, cfg.seed)
    if (cfg.model.backbone.qat_storage
            and isinstance(model.backbone, TinyViT)
            and model.backbone.config.quant_mode == "static"):
        calibrate_qat_(model, cfg.seed, image_size)
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


def _check_single_device(cfg) -> None:
    """Refuses a ``cfg.mesh`` (a TrainConfig's or PretrainConfig's) of more
    than one device."""
    mesh = cfg.mesh
    if mesh.model_parallel != 1 or mesh.data_parallel not in (-1, 1):
        raise NotImplementedError(
            "the port trains on one device; a mesh of more than one (data "
            f"{mesh.data_parallel}, model {mesh.model_parallel}) waits for "
            "torch.distributed (ROADMAP Queue 1 item 11)")


def _check_panorama(cfg: TrainConfig) -> None:
    if not cfg.model.panorama:
        raise ValueError(
            "train() with panorama=False: the batch iterators always yield "
            "a view axis ((B, V, H, W, C) pixels, (B, V, D) embeddings), "
            "which a single-image model reads as its batch; the JAX "
            "train() fails on the same mismatch.  Call train_step on "
            "(B, H, W, C) batches instead")


def _resume(store: CheckpointStore, state, name: str, label: str):
    """Restores ``name`` of ``store`` into ``state``; returns (start_epoch,
    best_value, global_step)."""
    _, meta = store.restore(state, name)
    start_epoch = int(meta["epoch"]) + 1
    best_value = float(meta["best_value"])
    step = int(meta["global_step"])
    logger.info(f"resumed from {label} (epoch {start_epoch - 1}, step {step}, "
                f"best={best_value:.6f})")
    return start_epoch, best_value, step


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
    model_config=None,
) -> Dict:
    """The train loop over panorama records (see
    ``data.pipeline.PanoramaBatchIterator``; with backbone "none", records
    of embedding blobs read by ``EmbeddingBatchIterator``): seeded random
    weights (``cfg.seed``), the freeze policy of ``cfg.model.backbone``,
    one ``train_step`` per batch, validation every ``eval_every_steps`` and
    at each epoch's end, early stopping on ``cfg.monitored_metric``.

    ``checkpoint_dir``: a CheckpointStore there (``keep_last_n`` epoch
    checkpoints, ``async_checkpoints``) saves every epoch; the run resumes
    from ``cfg.resume_path`` when set, else from the store's ``last`` when
    it has one (epoch, best value and global step too).

    ``device``: None means the GPU (raises without one); "cpu" runs the
    plain PyTorch path.  ``model_config`` replaces the backbone's preset
    (``build_backbone``), e.g. a CLIPVisionConfig with
    ``pallas_fuse_proj``.  Returns a summary dict with the last epoch's and
    the best metrics.
    """
    _check_single_device(cfg)
    _check_panorama(cfg)
    embedding_mode = cfg.model.backbone.name == "none"
    dev = C.resolve_device(device)
    steps_per_epoch = max(1, len(pano_train) // cfg.batch_size)
    state, mean, std, image_size = create_state(
        cfg, centroid_table.num_cells, steps_per_epoch, dev, model_config)
    centroids = torch.as_tensor(centroid_table.centroids, device=dev)

    store = None
    best_value: Optional[float] = None
    start_epoch = 0
    resume_step = 0
    if checkpoint_dir:
        store = CheckpointStore(CheckpointConfig(
            directory=checkpoint_dir, keep_top_k=cfg.keep_last_n,
            monitored_mode=cfg.monitored_mode,
            async_save=cfg.async_checkpoints))
        if cfg.resume_path:
            # an explicit checkpoint directory, e.g. <run>/last or <run>/best
            resume_store = CheckpointStore(CheckpointConfig(
                directory=os.path.dirname(os.path.abspath(cfg.resume_path)),
                keep_top_k=cfg.keep_last_n,
                monitored_mode=cfg.monitored_mode))
            start_epoch, best_value, resume_step = _resume(
                resume_store, state,
                os.path.basename(os.path.normpath(cfg.resume_path)),
                cfg.resume_path)
        elif store.has("last"):
            start_epoch, best_value, resume_step = _resume(
                store, state, "last", os.path.join(checkpoint_dir, "last"))

    mlog = metrics_logger or MetricsLogger(run_config=dataclasses.asdict(cfg))
    timer = StepTimer()

    def preprocess(batch):
        out = {"coords": batch["coords"], "view_mask": batch["view_mask"]}
        if embedding_mode:
            out["embedding"] = batch["embedding"]
        else:
            out["pixel_values"] = fused_preprocess(batch["pixel_values"],
                                                   mean, std, image_size)
        return out

    def make_iter(records, shuffle=False, seed=0):
        if embedding_mode:
            return EmbeddingBatchIterator(
                records, cfg.batch_size, cfg.model.backbone.embed_dim,
                shuffle=shuffle, seed=seed, drop_remainder=True)
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

    # The loop's step counter resumes too, so the logged steps and the
    # eval_every_steps cadence survive a restart.
    global_step = resume_step
    stale_epochs = 0
    # When the resumed epochs cover them all the loop never runs: report
    # the resumed position.
    summary: Dict = {"epoch": start_epoch - 1, "global_step": resume_step,
                     "best_value": best_value,
                     "monitored_value": (best_value if best_value is not None
                                         else float("nan"))}
    for epoch in range(start_epoch, cfg.num_epochs):
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
        if store is not None:
            prev_best = best_value
            best_value = store.save_epoch(
                state, epoch, monitored, best_value,
                extra={"global_step": global_step})
            improved = not np.isnan(best_value) and (
                prev_best is None or best_value != prev_best)
        else:
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

    if store is not None:
        store.wait_until_finished()  # commit an in-flight async save
    mlog.summary("best_value", best_value)
    mlog.finish()
    return summary


def main(cfg: Optional[TrainConfig] = None, device=None) -> Dict:
    """The production entry: ``train()`` on the newest SQLite dataset
    (``discover_sqlite``; ``DATASET_SQLITE_PATH`` overrides it) split by
    ``cfg.val_fraction``, over the repo's centroid table, with
    checkpoints in ``CHECKPOINT_DIR`` (``GEO_TPU_CKPT_DIR``)."""
    cfg = cfg or TrainConfig()
    sqlite_path = discover_sqlite()
    logger.info(f"dataset: {sqlite_path}")
    pano = load_sqlite_panorama_dataset(sqlite_path)
    pano_train, pano_val = split_train_val(pano, cfg.val_fraction)
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    return train(cfg, pano_train, pano_val, table,
                 checkpoint_dir=C.CHECKPOINT_DIR, device=device)


if __name__ == "__main__":
    main()
