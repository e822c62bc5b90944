"""TinyViT country-classification finetune (counterpart of
geoguessr_ai_tpu/train/finetune_tinyvit.py).

Label street-view rows by country through the geocell manager's point
index, split them stratified, finetune a TinyViT with a linear head (bf16
compute, f32 master weights, AdamW under a warm-up cosine, horizontal
flips), evaluate top-1 / top-k, keep the best checkpoint with the class
map, extract backbone embeddings and export MMPretrain annotations.

Rows are mappings (``image`` JPEG bytes, ``lat``, ``lon``, optionally
``location_id``) where the JAX package takes DataFrames; the functions
return row dicts and keep pandas' orders: ``prepare_country_dataset``
splits each label's group in sorted label order, as ``groupby`` does.

The JAX step, mirrored: log-softmax cross-entropy; ``optax.adamw`` (no
clipping, decay on every parameter, BatchNorm's and the attention biases
too) over ``warmup_cosine_decay_schedule(0, lr, warmup, warmup + total)``,
read at the update count before its increment, so with ``warmup > 0`` the
first update runs at rate 0.  On the card TinyViT-5M-224's ten attention
blocks (every window ragged: 7x7 at stages 1 and 3, one 14x14 at stage 2)
run the plain forward and K4's backward, ten launches a train step and
none in an eval forward.

A best checkpoint is ``<checkpoint_dir>/best/state.pt``: ``{"params",
"batch_stats"}``, each a flat name -> tensor dict of the ``Classifier``
(``read_finetune_checkpoint``; tensors only, loaded with
``weights_only=True``), beside ``<checkpoint_dir>/class_map.json``.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import dataclasses
import json
import os
import shutil
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import OptimizerConfig
from geoguessr_ai_torch.data import pipeline
from geoguessr_ai_torch.models.super_guessr import init_parameters_
from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.train.checkpoints import STATE_FILE
from geoguessr_ai_torch.train.state import AdamW, warmup_cosine_decay
from geoguessr_ai_torch.utils.logging import MetricsLogger, logger

#: Host threads decoding a batch's JPEGs.
DECODE_THREADS = 8


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    seed: int = 0
    batch_size: int = 64
    num_epochs: int = 5
    learning_rate: float = 5e-4
    weight_decay: float = 0.05
    warmup_steps: int = 100
    #: Unread, as in the JAX package: images are decoded at the TinyViT
    #: config's image_size.
    image_size: int = 64
    val_fraction: float = 0.1
    min_country_count: int = 2
    hflip_prob: float = 0.5


def prepare_country_dataset(
    rows: Iterable[Mapping], geocell_manager, min_count: int = 2,
    val_fraction: float = 0.1, seed: int = 0,
) -> Tuple[List[Dict], List[Dict], Dict[str, int]]:
    """Label rows by country and split them stratified.

    Rows whose point is in no cell drop, then countries with fewer than
    ``min_count`` rows; the class map is the sorted countries.  For each
    label in sorted order, ``max(1, round(n * val_fraction))`` of its row
    positions go to validation (``default_rng(seed).choice``, one draw per
    label).  Returns (train rows, val rows, class_map), each row a dict
    with ``country`` and ``label`` added, in the input order."""
    labelled = []
    for r in rows:
        _, country, _ = geocell_manager.get_geocell_id(
            {"latitude": r["lat"], "longitude": r["lon"]})
        if country is not None:
            labelled.append({**r, "country": country})
    counts: Dict[str, int] = {}
    for r in labelled:
        counts[r["country"]] = counts.get(r["country"], 0) + 1
    labelled = [r for r in labelled if counts[r["country"]] >= min_count]

    class_map = {c: i for i, c in
                 enumerate(sorted({r["country"] for r in labelled}))}
    groups: Dict[int, List[int]] = {}
    for i, r in enumerate(labelled):
        r["label"] = class_map[r["country"]]
        groups.setdefault(r["label"], []).append(i)

    rng = np.random.default_rng(seed)
    val_idx = set()
    for label in sorted(groups):
        positions = np.asarray(groups[label])
        k = max(1, int(round(len(positions) * val_fraction)))
        val_idx.update(int(i) for i in rng.choice(positions, size=k,
                                                  replace=False))
    train = [r for i, r in enumerate(labelled) if i not in val_idx]
    val = [r for i, r in enumerate(labelled) if i in val_idx]
    return train, val, class_map


class Classifier(nn.Module):
    """TinyViT ``backbone`` and an f32 ``head`` Linear on its embedding
    (the JAX ``Classifier``'s module names, so ``convert.
    from_jax_variables`` maps its flax tree here)."""

    def __init__(self, config: TinyViTConfig, num_classes: int):
        super().__init__()
        self.backbone = TinyViT(config)
        self.head = nn.Linear(config.embed_dim, num_classes)

    def forward(self, pixel_values, train: bool = False, generator=None):
        emb = self.backbone(pixel_values, train=train, generator=generator)
        return F.linear(emb.float(), self.head.weight, self.head.bias)


def split_state(state: Mapping[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A state dict as the JAX variables' two collections: (params, the
    BatchNorm running statistics)."""
    stats = {k: v for k, v in state.items()
             if k.endswith(("running_mean", "running_var"))}
    return {k: v for k, v in state.items() if k not in stats}, stats


def finetune_loss(model: Classifier, images, labels, generator=None):
    """(mean log-softmax cross-entropy, logits) of a train-mode forward."""
    logits = model(images, train=True, generator=generator)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean(), logits


def finetune_train_step(model: Classifier, optimizer: AdamW, images, labels,
                        generator=None):
    """One update: the loss, every parameter's gradient, AdamW.  Returns
    (loss, logits), detached device tensors."""
    params = dict(model.named_parameters())
    loss, logits = finetune_loss(model, images, labels, generator)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.step(params, dict(zip(params, grads)))
    return loss.detach(), logits.detach()


@torch.no_grad()
def finetune_eval_step(model: Classifier, images, labels, num_classes: int):
    """(top-1, top-k) accuracy of an eval forward, k = min(5, classes), as
    device scalars."""
    logits = model(images)
    top1 = (logits.argmax(-1) == labels).float().mean()
    topk = logits.topk(min(5, num_classes), dim=-1).indices
    return top1, (topk == labels[:, None]).any(-1).float().mean()


def _decode(rows, size: int) -> np.ndarray:
    with cf.ThreadPoolExecutor(DECODE_THREADS) as pool:
        return np.stack(list(pool.map(
            lambda r: pipeline.decode_jpeg(r["image"], size), rows)))


def _batches(rows, cfg: FinetuneConfig, size: int, shuffle: bool,
             epoch: int):
    """Host batches (uint8 (B, size, size, 3), int64 (B,) labels) in the
    JAX order: a ``default_rng(seed + epoch)`` shuffle, full batches only,
    each train batch's flips drawn from ``default_rng(seed + epoch +
    start)``."""
    order = np.arange(len(rows))
    if shuffle:
        np.random.default_rng(cfg.seed + epoch).shuffle(order)
    bs = cfg.batch_size
    for s in range(0, len(order) - bs + 1, bs):
        idx = order[s:s + bs]
        imgs = _decode([rows[i] for i in idx], size)
        if shuffle:  # train-time augmentation: horizontal flip
            flip = np.random.default_rng(cfg.seed + epoch + s).random(
                len(idx)) < cfg.hflip_prob
            imgs[flip] = imgs[flip, :, ::-1]
        yield imgs, np.array([rows[i]["label"] for i in idx], np.int64)


def pixels(imgs: np.ndarray, config: TinyViTConfig, dev) -> torch.Tensor:
    """uint8 (B, H, W, 3) host images as the backbone's input on ``dev``:
    resized to ``config.image_size``, ImageNet-normalised, in
    ``config.dtype``."""
    return fused_preprocess(torch.from_numpy(imgs).to(dev),
                            C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD,
                            config.image_size, dtype=config.dtype)


def _to_device(imgs, labels, config: TinyViTConfig, dev):
    return pixels(imgs, config, dev), torch.from_numpy(labels).to(dev)


def read_finetune_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A finetune checkpoint directory's ``{"params", "batch_stats"}`` on
    the CPU (tensors and plain containers only)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def _save_best(path: str, model: Classifier) -> None:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    params, stats = split_state({k: v.detach().cpu() for k, v in
                                 model.state_dict().items()})
    torch.save({"params": params, "batch_stats": stats},
               os.path.join(path, STATE_FILE))


def finetune(
    train_rows: List[Mapping],
    val_rows: List[Mapping],
    num_classes: int,
    cfg: FinetuneConfig = FinetuneConfig(),
    tinyvit_config: Optional[TinyViTConfig] = None,
    checkpoint_dir: Optional[str] = None,
    class_map: Optional[Dict[str, int]] = None,
    max_steps: Optional[int] = None,
    init_state: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
) -> Dict:
    """Train TinyViT (``tiny_vit_5m_224`` by default) and a linear head on
    country labels; evaluate on ``val_rows`` after each epoch.

    ``init_state``: a ``Classifier`` state dict (``convert.
    from_jax_variables`` of the JAX ``Classifier``'s variables), else
    seeded weights (``cfg.seed``).  ``device``: None means the GPU
    (raises without one); "cpu" runs the plain path.  With no full
    validation batch top-1 and top-5 are NaN and nothing is saved.
    Returns ``{"epoch", "top1", "top5", "step", "best_checkpoint",
    "params", "batch_stats"}``: the last epoch's metrics, the best
    directory (or None) and the final state as ``split_state`` gives it."""
    dev = C.resolve_device(device)
    tv_cfg = tinyvit_config or TinyViTConfig.tiny_vit_5m_224()
    model = Classifier(tv_cfg, num_classes)
    if init_state is None:
        init_parameters_(model, cfg.seed)
    else:
        model.load_state_dict(dict(init_state), strict=True)
    model.to(dev)

    steps_per_epoch = max(1, len(train_rows) // cfg.batch_size)
    total_steps = max(1, steps_per_epoch * cfg.num_epochs)
    warmup = min(cfg.warmup_steps, max(0, total_steps - 1))
    params = dict(model.named_parameters())
    optimizer = AdamW(
        params,
        OptimizerConfig(learning_rate=cfg.learning_rate,
                        weight_decay=cfg.weight_decay, max_grad_norm=None),
        warmup_cosine_decay(cfg.learning_rate, warmup, warmup + total_steps))
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    mlog = MetricsLogger(project="geoguessr-tpu-finetune")
    best_top1 = -1.0
    best_path = None
    step = 0
    summary: Dict = {}
    for epoch in range(cfg.num_epochs):
        for imgs, labels in _batches(train_rows, cfg, tv_cfg.image_size,
                                     True, epoch):
            images, labels = _to_device(imgs, labels, tv_cfg, dev)
            loss, _ = finetune_train_step(model, optimizer, images, labels,
                                          generator)
            step += 1
            if step % 10 == 0 or step == 1:
                mlog.log({"finetune/loss": float(loss)}, step)
            if max_steps and step >= max_steps:
                break
        evals = [finetune_eval_step(model,
                                    *_to_device(imgs, labels, tv_cfg, dev),
                                    num_classes)
                 for imgs, labels in _batches(val_rows, cfg,
                                              tv_cfg.image_size, False, 0)]
        if evals:
            top1 = float(np.mean([float(a) for a, _ in evals]))
            top5 = float(np.mean([float(b) for _, b in evals]))
        else:
            top1 = top5 = float("nan")
        mlog.log({"finetune/top1": top1, "finetune/top5": top5}, step)
        summary = {"epoch": epoch, "top1": top1, "top5": top5, "step": step}
        improved = not np.isnan(top1) and top1 > best_top1
        if checkpoint_dir and improved:
            best_top1 = top1
            best_path = os.path.join(os.path.abspath(checkpoint_dir), "best")
            _save_best(best_path, model)
            if class_map is not None:
                with open(os.path.join(checkpoint_dir, "class_map.json"),
                          "w") as f:
                    json.dump(class_map, f)
        if max_steps and step >= max_steps:
            break
    mlog.finish()
    summary["best_checkpoint"] = best_path
    summary["params"], summary["batch_stats"] = split_state(
        {k: v.detach() for k, v in model.state_dict().items()})
    return summary


def _backbone_state(params, batch_stats) -> Dict[str, torch.Tensor]:
    """A TinyViT state dict from bare TinyViT collections or a
    ``Classifier``'s (whose ``backbone.`` part is taken)."""
    state = dict(params)
    if any(k.startswith("backbone.") for k in state):
        state = {k[len("backbone."):]: v for k, v in state.items()
                 if k.startswith("backbone.")}
        batch_stats = {k[len("backbone."):]: v
                       for k, v in (batch_stats or {}).items()
                       if k.startswith("backbone.")}
    state.update(batch_stats or {})
    return state


def extract_embeddings(
    rows: List[Mapping],
    tinyvit_config: Optional[TinyViTConfig] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    batch_stats: Optional[Mapping[str, torch.Tensor]] = None,
    batch_size: int = 64,
    device=None,
) -> np.ndarray:
    """(len(rows), embed_dim) float32 backbone embeddings of the rows'
    images, in batches of ``batch_size`` (the last one short).
    ``params`` / ``batch_stats``: a TinyViT's or a ``Classifier``'s (the
    finetune summary's, or ``read_finetune_checkpoint``'s); without
    ``params`` the weights are seeded (seed 0).  ``device`` as
    ``finetune``'s."""
    dev = C.resolve_device(device)
    tv_cfg = tinyvit_config or TinyViTConfig.tiny_vit_5m_224()
    model = TinyViT(tv_cfg)
    if params is None:
        init_parameters_(model, 0)
    else:
        model.load_state_dict(_backbone_state(params, batch_stats),
                              strict=True)
    model.to(dev).eval()
    out = []
    with torch.no_grad():
        for s in range(0, len(rows), batch_size):
            imgs = _decode(rows[s:s + batch_size], tv_cfg.image_size)
            out.append(model(pixels(imgs, tv_cfg, dev)).float().cpu().numpy())
    if not out:
        return np.zeros((0, tv_cfg.embed_dim), np.float32)
    return np.concatenate(out)


def extract_embeddings_parquet(
    rows: List[Mapping],
    out_path: str,
    tinyvit_config: Optional[TinyViTConfig] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    batch_stats: Optional[Mapping[str, torch.Tensor]] = None,
    batch_size: int = 64,
    device=None,
) -> int:
    """``extract_embeddings`` written to Parquet (columns location_id,
    lat, lon, embedding as a list of floats); returns the row count.
    Needs pandas with a Parquet engine (raises ImportError first where
    pandas is absent)."""
    import pandas as pd

    embs = extract_embeddings(rows, tinyvit_config, params, batch_stats,
                              batch_size, device)
    out = pd.DataFrame([
        {"location_id": r.get("location_id"), "lat": r["lat"],
         "lon": r["lon"], "embedding": e.tolist()}
        for r, e in zip(rows, embs)])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    out.to_parquet(out_path, index=False)
    logger.info(f"wrote {len(out)} embeddings -> {out_path}")
    return len(out)


#: The strings pandas' ``read_csv`` reads as NaN by default (its
#: ``astype(str)`` then gives "nan").
_CSV_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def mmpretrain_export(
    train_csv: str,
    val_csv: str,
    out_dir: str,
    label_map: Optional[Dict[str, int]] = None,
) -> Dict[str, int]:
    """CSV manifests (``filepath``, ``country`` columns) -> MMPretrain
    annotations: train.json / val.json of ``{"img_path": absolute path,
    "gt_label": id}`` and label_map.json (the sorted train countries
    unless ``label_map`` is given).  A country pandas reads as missing
    ("NA", "null", ...) is the class "nan", as in the JAX export."""
    os.makedirs(out_dir, exist_ok=True)

    def _export(csv_path, out_json, lmap):
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        countries = ["nan" if r["country"] in _CSV_NA else r["country"]
                     for r in rows]
        if lmap is None:
            lmap = {c: i for i, c in enumerate(sorted(set(countries)))}
        records = [
            {
                "img_path": os.path.abspath(r["filepath"]),
                "gt_label": int(lmap[c]),
            }
            for r, c in zip(rows, countries)
        ]
        with open(out_json, "w") as f:
            json.dump(records, f)
        return lmap

    label_map = _export(
        train_csv, os.path.join(out_dir, "train.json"), label_map
    )
    _export(val_csv, os.path.join(out_dir, "val.json"), label_map)
    with open(os.path.join(out_dir, "label_map.json"), "w") as f:
        json.dump(label_map, f, indent=2)
    return label_map
