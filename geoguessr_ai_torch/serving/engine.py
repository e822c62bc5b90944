"""Serving engine: build once, serve panorama batches through SuperGuessr
(counterpart of geoguessr_ai_tpu/serving/engine.py)."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import BackboneConfig
from geoguessr_ai_torch.data.pipeline import decode_jpeg
from geoguessr_ai_torch.geocells.manager import CentroidTable
from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
from geoguessr_ai_torch.models.convert import from_jax_variables
from geoguessr_ai_torch.models.super_guessr import (
    SuperGuessr,
    decode_predictions,
    init_parameters_,
)
from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
from geoguessr_ai_torch.models.torch_convert import (
    clip_vision_from_hf,
    super_guessr_head_from_reference,
    tinyvit_from_timm,
)
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.train.checkpoints import (
    STATE_FILE,
    load_torch_checkpoint,
    read_checkpoint,
)
from geoguessr_ai_torch.train.coordinator import build_backbone
from geoguessr_ai_torch.utils.logging import logger


@dataclasses.dataclass
class InferenceResult:
    lat: float
    lon: float
    top_ids: List[int]
    top_probs: List[float]
    top_countries: List[str]
    top_admin1: List[str]
    embedding: np.ndarray


class ServingEngine:
    """Holds the model and the centroid table; serves panorama batches.

    Args:
      backbone: "tinyvit" (TinyViT-21M-512) or "clip" (CLIP ViT-L/14-336,
        the mean-token embedding).
      centroid_table: defaults to the repo's table (12647 cells).
      device: None means "cuda"; raises when no GPU is present.
      checkpoint: a checkpoint directory of the port's CheckpointStore
        (e.g. ``<run>/best``), or a reference or timm ``.pt`` file,
        loaded over the seeded weights (``load_checkpoint``); an orbax
        directory raises.
      state_dict: SuperGuessr weights (e.g. from models.convert); seeded
        random weights when None.
      backbone_config: replaces the backbone's preset: a TinyViTConfig, or
        a CLIPVisionConfig for "clip" (bf16 by default).
      seed: seed of the random weights.
    """

    def __init__(
        self,
        backbone: str = "tinyvit",
        centroid_table: Optional[CentroidTable] = None,
        num_candidates: int = C.NUM_CANDIDATES,
        hierarchical: bool = False,
        device=None,
        checkpoint: Optional[str] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        backbone_config: Optional[Union[TinyViTConfig,
                                        CLIPVisionConfig]] = None,
        seed: int = 0,
    ):
        presets = {"tinyvit": (BackboneConfig.tinyvit(), TinyViTConfig),
                   "clip": (BackboneConfig.clip(), CLIPVisionConfig)}
        if backbone not in presets:
            raise ValueError(f"unknown backbone {backbone!r}; the engine "
                             f"serves {sorted(presets)}")
        bb_cfg, cfg_type = presets[backbone]
        if backbone_config is not None and not isinstance(backbone_config,
                                                          cfg_type):
            raise ValueError(f"backbone {backbone!r} takes a "
                             f"{cfg_type.__name__}, got "
                             f"{type(backbone_config).__name__}")
        self.device = C.resolve_device(device)
        self.table = centroid_table or CentroidTable.load(
            C.CENTROID_TABLE_PATH)
        bb, mean, std, self.image_size = build_backbone(bb_cfg,
                                                        backbone_config)
        self.config = bb.config
        self.norm = (mean, std)
        self.num_candidates = min(num_candidates, self.table.num_cells)
        self.backbone_name = backbone
        model = SuperGuessr(self.table.num_cells, bb,
                            embed_dim=self.config.embed_dim,
                            hierarchical=hierarchical,
                            dtype=self.config.dtype)
        if state_dict is None:
            init_parameters_(model, seed)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model
        #: what ``load_checkpoint`` took: head subtrees and the backbone
        self.loaded = {"head": 0, "backbone": False}
        if checkpoint:
            self.load_checkpoint(checkpoint)
        model.backbone.cast_weights_()
        if hierarchical:
            model.self_attn.cast_weights_()
        self.model = model.to(self.device).eval()
        self.centroids = torch.as_tensor(self.table.centroids,
                                         device=self.device)

    def load_checkpoint(self, path: str) -> None:
        """Loads a checkpoint over the current weights.

        A directory holding ``state.pt`` (written by the port's
        CheckpointStore) gives the whole model by name
        (``_load_store_checkpoint``).  Any other directory (an orbax one of
        the JAX package) raises NotImplementedError.  A file is a reference
        SuperGuessr ``.pt``: its head (``cell_layer`` when its cell count matches the table,
        ``self_attn`` of a hierarchical model) comes through
        ``super_guessr_head_from_reference``; backbone entries under
        ``base_model.`` (then ``backbone.``) through ``tinyvit_from_timm``
        or ``clip_vision_from_hf``.  A backbone whose conversion misses a
        key is skipped with a warning, as the JAX engine does, and so is
        one that does not fill every backbone entry in its shape (a
        checkpoint of another width): the model never serves a backbone
        that is part checkpoint, part seed.  The flax trees reach the
        model through ``convert.from_jax_variables``; head entries the
        model lacks or holds in another shape are skipped.
        ``self.loaded`` records the head subtrees and whether the backbone
        was loaded."""
        if os.path.isdir(path):
            if os.path.exists(os.path.join(path, STATE_FILE)):
                self._load_store_checkpoint(path)
                return
            raise NotImplementedError(
                f"{path} is a directory without {STATE_FILE}: orbax "
                "checkpoint directories (the JAX package's) are not read, "
                "since orbax is not installed where the port runs; pass a "
                "CheckpointStore directory or a .pt file")
        sd = load_torch_checkpoint(path)
        overlay = super_guessr_head_from_reference(
            sd, num_cells=self.table.num_cells,
            num_attention_heads=C.NUM_ATTENTION_HEADS)
        if not self.model.hierarchical:
            overlay.pop("self_attn", None)
        tree = {"params": dict(overlay)}
        bb_sd = {k.split("base_model.", 1)[1]: v for k, v in sd.items()
                 if k.startswith("base_model.")}
        backbone = False
        if bb_sd:
            try:
                if self.backbone_name == "tinyvit":
                    strip = {k.split("backbone.", 1)[-1]: v
                             for k, v in bb_sd.items()}
                    conv = tinyvit_from_timm(strip, self.config)
                    tree["params"]["backbone"] = conv["params"]
                    tree["batch_stats"] = {"backbone": conv["batch_stats"]}
                else:
                    tree["params"]["backbone"] = clip_vision_from_hf(
                        bb_sd, self.config)
                backbone = True
            except KeyError as e:
                logger.warning(f"backbone conversion skipped ({e})")
        own = self.model.state_dict()
        entries = {k: v for k, v in from_jax_variables(tree).items()
                   if k in own and own[k].shape == v.shape}
        if backbone:
            missing = [k for k in own if k.startswith("backbone.")
                       and ".act_" not in k and k not in entries]
            if missing:
                logger.warning(f"backbone of {path} lacks {len(missing)} "
                               f"entries or holds them in another shape "
                               f"(e.g. {missing[0]}); backbone skipped")
                backbone = False
        if not backbone:  # the whole converted backbone, or none of it
            entries = {k: v for k, v in entries.items()
                       if not k.startswith("backbone.")}
        self.model.load_state_dict(entries, strict=False)
        self.loaded = {"head": sum(
            any(k.startswith(f"{name}.") for k in entries)
            for name in overlay), "backbone": backbone}
        logger.info(f"loaded reference checkpoint {path} ({self.loaded})")

    def _load_store_checkpoint(self, path: str) -> None:
        """Loads the model of a CheckpointStore directory (``state.pt``'s
        ``state["model"]``) by name, every entry (strict).  A checkpoint of
        another model (cell count, width, fusion or backbone) raises
        ValueError naming the entries that differ, before any weight
        changes."""
        tree = read_checkpoint(path)
        sd = tree["state"]["model"]
        act = tuple(f"backbone.{c}." for c in ("act_scales", "act_stats"))
        own = {k: v for k, v in self.model.state_dict().items()
               if not k.startswith(act)}
        theirs = {k: v for k, v in sd.items() if not k.startswith(act)}
        diff = [f"{k} missing" for k in sorted(set(own) - set(theirs))]
        diff += [f"{k} unexpected" for k in sorted(set(theirs) - set(own))]
        diff += [f"{k}: checkpoint {tuple(theirs[k].shape)}, model "
                 f"{tuple(own[k].shape)}" for k in sorted(own)
                 if k in theirs and theirs[k].shape != own[k].shape]
        if diff:
            raise ValueError(
                f"{path} holds another model than this engine's "
                f"({self.table.num_cells} cells, {self.backbone_name} "
                f"width {self.config.embed_dim}, hierarchical="
                f"{self.model.hierarchical}): {len(diff)} entries differ, "
                f"e.g. {'; '.join(diff[:4])}")
        self.model.load_state_dict(sd, strict=True)
        self.loaded = {"head": len({k.split(".")[0] for k in own}
                                   - {"backbone"}),
                       "backbone": True}
        logger.info(f"loaded checkpoint {path} (meta {tree['meta']})")

    @torch.inference_mode()
    def predict_batch(
        self,
        panoramas_u8: np.ndarray,
        view_mask: Optional[np.ndarray] = None,
    ) -> List[InferenceResult]:
        """panoramas_u8: (B, V, H, W, 3) uint8, resized on the device
        when H x W is not image_size x image_size; view_mask: optional
        (B, V) 1/0 mask of real views."""
        dev = self.device
        pixels = fused_preprocess(
            torch.from_numpy(np.ascontiguousarray(panoramas_u8)).to(dev),
            *self.norm, self.image_size, dtype=self.config.dtype)
        mask = (None if view_mask is None
                else torch.as_tensor(view_mask, dtype=torch.float32,
                                     device=dev))
        emb, logits = self.model(pixels, view_mask=mask)
        _, _, lnglat, topk = decode_predictions(
            logits, self.centroids, self.num_candidates)
        lnglat = lnglat.cpu().numpy()
        top_vals = topk.values.cpu().numpy()
        top_idx = topk.indices.cpu().numpy()
        emb = emb.float().cpu().numpy()
        out = []
        for b in range(lnglat.shape[0]):
            ids = top_idx[b].tolist()
            out.append(InferenceResult(
                lat=float(lnglat[b, 1]),
                lon=float(lnglat[b, 0]),
                top_ids=ids,
                top_probs=top_vals[b].tolist(),
                top_countries=[str(self.table.country[i]) for i in ids],
                top_admin1=[str(self.table.admin1[i]) for i in ids],
                embedding=emb[b],
            ))
        return out

    def predict_images(self, image_paths: Sequence[str]) -> InferenceResult:
        """1 or 4 image files -> one panorama prediction."""
        if len(image_paths) not in (1, 4):
            raise ValueError("supply exactly 1 or 4 images")
        size = self.image_size
        views = np.zeros((1, C.NUM_PANORAMA_VIEWS, size, size, 3), np.uint8)
        for v, p in enumerate(image_paths):
            with open(p, "rb") as f:
                views[0, v] = decode_jpeg(f.read(), size)
        if len(image_paths) == 1:
            views[0, 1:] = views[0, 0]  # replicate one image across views
        return self.predict_batch(views)[0]


class MicroBatcher:
    """Coalesces concurrent single-panorama requests into one batch.

    Requests gather for a rolling window: each arrival extends the
    deadline by ``linger_ms``, bounded by ``max(max_wait_ms, 8 *
    linger_ms)`` from the first arrival, or until ``max_batch``.  The batch
    is padded up to a bucket size by repeating its last row."""

    def __init__(
        self,
        engine: ServingEngine,
        max_batch: int = 16,
        max_wait_ms: float = 8.0,
        buckets: Sequence[int] = (1, 4, 8, 16),
        predict_timeout_s: float = 1800.0,
        linger_ms: float = 25.0,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.linger_s = linger_ms / 1000.0
        self.max_linger_total_s = max(self.max_wait_s, 8 * self.linger_s)
        self.buckets = sorted(buckets)
        if self.max_batch > self.buckets[-1]:
            raise ValueError("max_batch exceeds the largest bucket")
        self.predict_timeout_s = predict_timeout_s
        #: bucket size -> batches dispatched at that size
        self.batch_sizes: Dict[int, int] = {}
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            batch = [self._q.get()]
            t0 = time.perf_counter()
            hard_deadline = t0 + self.max_linger_total_s
            deadline = t0 + max(self.max_wait_s, self.linger_s)
            while len(batch) < self.max_batch:
                remaining = min(deadline, hard_deadline) - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                    deadline = max(deadline,
                                   time.perf_counter() + self.linger_s)
                except queue.Empty:
                    break
            try:
                views = np.stack([b[1] for b in batch])
                masks = np.stack([b[2] for b in batch])
                bucket = next(s for s in self.buckets if s >= len(batch))
                if bucket > len(batch):  # pad by repeating the last row
                    reps = bucket - len(batch)
                    views = np.concatenate(
                        [views, np.repeat(views[-1:], reps, axis=0)])
                    masks = np.concatenate(
                        [masks, np.repeat(masks[-1:], reps, axis=0)])
                self.batch_sizes[bucket] = self.batch_sizes.get(bucket, 0) + 1
                results = self.engine.predict_batch(views, view_mask=masks)
                for (fut, _, _), r in zip(batch, results):
                    fut.set_result(r)
            except Exception as e:  # deliver the failure to every waiter
                for fut, _, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def warmup(self, num_views: int = C.NUM_PANORAMA_VIEWS) -> None:
        """Runs every bucket size once."""
        size = self.engine.image_size
        for b in self.buckets:
            views = np.zeros((b, num_views, size, size, 3), np.uint8)
            masks = np.ones((b, num_views), np.float32)
            self.engine.predict_batch(views, view_mask=masks)

    def predict(self, views_u8: np.ndarray,
                view_mask: Optional[np.ndarray] = None,
                timeout: Optional[float] = None) -> InferenceResult:
        """Blocking single-panorama predict: (V, H, W, 3) uint8 ->
        InferenceResult, batched with concurrent callers."""
        self._ensure_thread()
        if view_mask is None:
            view_mask = np.ones((views_u8.shape[0],), np.float32)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, views_u8, np.asarray(view_mask, np.float32)))
        return fut.result(
            timeout=self.predict_timeout_s if timeout is None else timeout)
