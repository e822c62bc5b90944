"""The embedding-dataset builder: batch inference that writes SQLite
(counterpart of geoguessr_ai_tpu/data/embed_builder.py).

A thread pool decodes JPEGs into a bounded queue while the device embeds
fixed-size batches; one writer inserts the float32 embedding rows.  This is
the bulk-embedding workload, whose metric is panoramas per second per card
(4 images a panorama) at ``EmbedBuildConfig.batch_size`` = 512.  The
configuration that turns on K9 and K10 is ``bulk_embed_config()``,
passed as ``Embedder(model_config=...)``.

Not ported yet, and raising ``NotImplementedError``: the static-int8
TinyViT (``quant_mode="static"``, the config's default; ROADMAP Queue 1
item 7) and a data-parallel mesh (``mesh``, ``data_parallel`` > 1; item 11).
The builder runs as one process: there is no per-host row sharding.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import sqlite3
import threading
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.config import BackboneConfig, EmbedBuildConfig
from geoguessr_ai_torch.data.pipeline import ThroughputMeter, decode_jpeg
from geoguessr_ai_torch.data.sqlite_dataset import (
    create_sqlite_from_records,
    load_sqlite_dataset,
)
from geoguessr_ai_torch.ops.preprocess import fused_preprocess
from geoguessr_ai_torch.utils.logging import logger


def bulk_embed_config(knobs: bool = True, **overrides):
    """TinyViT-21M-512 as the bulk-embedding path runs it: the fused block
    (K1) at stages 1 and 3 and no K3 stage, as the JAX package's embed
    measurements run it, and with ``knobs`` the fused MBConv (K10) and
    the 4D fused block (K9)."""
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig

    return TinyViTConfig.tiny_vit_21m_512(
        fused_block_stages=(1, 3), pallas_attention_stages=(),
        fused_mbconv=knobs, fused_block_4d=knobs, **overrides)


class Embedder:
    """Batch embedder over a vision backbone: uint8 (B, S, S, 3) images ->
    (B, embed_dim) float32 numpy.

    Args:
      backbone_cfg: which backbone (``BackboneConfig.name``).
      quant_mode: "none"; "static" raises for TinyViT (not ported yet) and
        is ignored for the other backbones, as in the JAX package.
      device: None means the GPU; raises without one.
      model_config: a TinyViTConfig (or CLIPVisionConfig) replacing the
        backbone's preset, e.g. the bulk-embedding configuration.
      state_dict: backbone weights (e.g. from ``models.convert``); seeded
        random weights when None.
      seed: seed of the random weights.
      mesh: data-parallel embedding is not ported yet; must be None.
    """

    def __init__(self, backbone_cfg: BackboneConfig, quant_mode: str = "none",
                 device=None, model_config=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, mesh=None):
        from geoguessr_ai_torch.models.super_guessr import init_parameters_
        from geoguessr_ai_torch.train.coordinator import build_backbone

        if mesh is not None:
            raise NotImplementedError(
                "a data-parallel embedding mesh is not ported yet (ROADMAP "
                "Queue 1 item 11)")
        self.quant_mode = quant_mode if backbone_cfg.name == "tinyvit" \
            else "none"
        if self.quant_mode == "static":
            raise NotImplementedError(
                "quant_mode='static' (static-int8 MLP GEMMs and their "
                "calibration, ops/quant.py) is not ported yet (ROADMAP Queue "
                "1 item 7); use quant_mode='none'")
        self.device = C.resolve_device(device)
        model, mean, std, self.image_size = build_backbone(backbone_cfg,
                                                           model_config)
        self.embed_dim = model.config.embed_dim
        self._norm = (mean, std)
        if state_dict is None:
            init_parameters_(model, seed)
        self.model = model
        self.load_params(state_dict)

    def load_params(self, state_dict: Optional[Dict[str, torch.Tensor]]
                    ) -> None:
        """Loads backbone weights (strict; None keeps the current ones) and
        moves the model to the device in its compute dtype."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.cast_weights_()
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        x = fused_preprocess(x, *self._norm, self.image_size,
                             dtype=self.model.config.dtype)
        return self.model(x).float().cpu().numpy()


def _done_keys(out_sqlite: str) -> set:
    conn = sqlite3.connect(f"file:{out_sqlite}?mode=ro", uri=True)
    try:
        return set(conn.execute("SELECT location_id, heading FROM samples"))
    finally:
        conn.close()


def build_embedding_sqlite(
    src_sqlite: str,
    out_sqlite: str,
    cfg: EmbedBuildConfig = EmbedBuildConfig(),
    embedder: Optional[Embedder] = None,
    limit: Optional[int] = None,
    log_fn=None,
    predecoded: bool = False,
    resume: bool = True,
) -> int:
    """Embeds every image row of a raw SQLite into an embedding SQLite and
    returns the rows written.  ``log_fn`` receives the ThroughputMeter
    records (mode, processed, total, throughput_img_per_s, phase).

    resume=True skips (location_id, heading) rows already present in an
    existing ``out_sqlite``, so a killed build restarts where it stopped;
    ``INSERT OR REPLACE`` keeps re-runs idempotent either way.

    predecoded=True decodes the whole source up front and then streams
    in-memory batches, so that the device-limited rate is measurable on a
    host with few cores.
    """
    rows = load_sqlite_dataset(src_sqlite)
    if limit:
        rows = rows[:limit]
    if resume and os.path.exists(out_sqlite):
        done = _done_keys(out_sqlite)
        if done:
            keep = [r for r in rows
                    if (r.location_id, int(r.heading)) not in done]
            if len(keep) < len(rows):
                logger.info(f"resume: skipping {len(rows) - len(keep)} "
                            "already-embedded rows")
            rows = keep
    total = len(rows)
    if embedder is None:
        if cfg.data_parallel not in (0, 1):
            raise NotImplementedError(
                f"data_parallel={cfg.data_parallel}: a data-parallel "
                "embedding mesh is not ported yet (ROADMAP Queue 1 item 11)")
        embedder = Embedder(cfg.backbone, quant_mode=cfg.quant_mode)
    meter = ThroughputMeter(mode=f"embed_{cfg.backbone.name}", total=total,
                            log_fn=log_fn)

    decoded_q: "queue.Queue" = queue.Queue(maxsize=4)
    B = cfg.batch_size
    size = embedder.image_size
    producer_error: list = []  # surfaced to the consumer after the sentinel

    def decode_all(pool, batch_rows):
        return np.stack(list(pool.map(lambda r: decode_jpeg(r.image, size),
                                      batch_rows)))

    def producer_predecoded():
        with cf.ThreadPoolExecutor(cfg.fetch_threads) as pool:
            all_imgs = (decode_all(pool, rows) if rows
                        else np.zeros((0, size, size, 3), np.uint8))
        meter.update(0, phase="predecode_done")
        for start in range(0, len(rows), B):
            decoded_q.put((rows[start:start + B], all_imgs[start:start + B]))

    def producer_streaming():
        with cf.ThreadPoolExecutor(cfg.fetch_threads) as pool:
            for start in range(0, len(rows), B):
                batch_rows = rows[start:start + B]
                decoded_q.put((batch_rows, decode_all(pool, batch_rows)))

    def producer():
        # The sentinel must reach the queue even when decode raises (a
        # corrupt blob), or the consumer would wait on the queue forever.
        try:
            (producer_predecoded if predecoded else producer_streaming)()
        except BaseException as e:
            producer_error.append(e)
        finally:
            decoded_q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def record_stream() -> Iterable[Dict]:
        while True:
            item = decoded_q.get()
            if item is None:
                if producer_error:
                    raise RuntimeError(
                        "embed-builder producer failed") from producer_error[0]
                break
            batch_rows, imgs = item
            n_real = len(batch_rows)
            if n_real < B:  # pad to the fixed batch shape
                imgs = np.concatenate(
                    [imgs, np.zeros((B - n_real,) + imgs.shape[1:],
                                    imgs.dtype)])
            embs = embedder(imgs)[:n_real]
            meter.update(n_real, phase="embed")
            for row, emb in zip(batch_rows, embs):
                yield {
                    "location_id": row.location_id,
                    "lat": float(row.lat),
                    "lon": float(row.lon),
                    "heading": int(row.heading),
                    "capture_date": getattr(row, "capture_date", None),
                    "pano_id": getattr(row, "pano_id", None),
                    "batch_date": getattr(row, "batch_date", None),
                    "embedding": np.asarray(emb, np.float32).tobytes(),
                    "embedding_dim": int(emb.shape[-1]),
                }

    written = create_sqlite_from_records(out_sqlite, record_stream(),
                                         embedding=True)
    t.join()
    logger.info(f"embedded {written}/{total} rows -> {out_sqlite} "
                f"({meter.update(0)['throughput_img_per_s']:.0f} img/s)")
    return written
