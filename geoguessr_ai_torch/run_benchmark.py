"""Score the guess path on a SQLite dataset's test split (counterpart of
the repo's root run_benchmark.py).

    python -m geoguessr_ai_torch.run_benchmark [--num-samples N]
        [--sqlite-path PATH] [--output-path PATH] [--backbone tinyvit|clip]
        [--checkpoint MODEL.pt | --clip-checkpoint-index N]
        [--centroid-table PATH] [--batch-size B] [--seed S]
        [--device cuda|cpu]

Samples N panoramas from the test split (the last 10 %, unshuffled) with
numpy's ``default_rng(seed)``, predicts them in batches through one
``ServingEngine``, records each sample's distance, GeoGuessr score and
top-5 cells (with country and admin1), appends a summary record and writes
the list as JSON.  The summary is printed as the last line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from geoguessr_ai_torch.data.pipeline import PanoramaBatchIterator
from geoguessr_ai_torch.data.sqlite_dataset import (
    load_sqlite_panorama_dataset,
    split_train_val,
)
from geoguessr_ai_torch.eval.metrics import (
    geoguessr_score_np,
    haversine_km_np,
    summarize_results,
)
from geoguessr_ai_torch.geocells.manager import CentroidTable
from geoguessr_ai_torch.inference import checkpoint_centroid_table
from geoguessr_ai_torch.serving import engine as serving
from geoguessr_ai_torch.utils.logging import logger

DEFAULT_OUTPUT = "data/out/inference_results.json"


def sample_panoramas(panoramas: Sequence, num_samples: int,
                     seed: int = 0) -> List:
    """``num_samples`` panoramas of the test split (``split_train_val``'s
    last 10 %), drawn without replacement by ``default_rng(seed)``, in
    split order."""
    _, test = split_train_val(panoramas, 0.1)
    rng = np.random.default_rng(seed)
    n = min(num_samples, len(test))
    idx = rng.choice(len(test), size=n, replace=False)
    return [test[i] for i in sorted(idx)]


def run_benchmark(
    num_samples: int = 100,
    clip_checkpoint_index: Optional[int] = None,
    sqlite_path: Optional[str] = None,
    output_path: Optional[str] = DEFAULT_OUTPUT,
    backbone: str = "tinyvit",
    checkpoint: Optional[str] = None,
    batch_size: int = 16,
    seed: int = 0,
    centroid_table: Optional[str] = None,
    device=None,
) -> dict:
    """Returns the summary record (also appended to the output JSON).

    ``sqlite_path`` None: ``train.coordinator.discover_sqlite``.
    ``checkpoint``: a ``.pt`` file or a checkpoint directory, served with
    the centroid table given, else its ``_centroids.npz`` sidecar.
    ``clip_checkpoint_index``: with no ``checkpoint``, the N-th newest
    checkpoint of the object store's registry (0 the newest;
    ``data.s3.download_nth_model_checkpoint``), downloaded and served.
    """
    if sqlite_path is None:
        from geoguessr_ai_torch.train.coordinator import discover_sqlite

        sqlite_path = discover_sqlite()
    if checkpoint is None and clip_checkpoint_index is not None:
        from geoguessr_ai_torch.data.s3 import download_nth_model_checkpoint

        checkpoint = download_nth_model_checkpoint(clip_checkpoint_index)
    sample = sample_panoramas(load_sqlite_panorama_dataset(sqlite_path),
                              num_samples, seed)
    centroid_table = checkpoint_centroid_table(checkpoint, centroid_table,
                                               "benchmarking")
    table = CentroidTable.load(centroid_table) if centroid_table else None
    engine = serving.ServingEngine(backbone=backbone, checkpoint=checkpoint,
                                   centroid_table=table, device=device)
    records = []
    for batch in PanoramaBatchIterator(sample, batch_size=batch_size,
                                       image_size=engine.image_size):
        results = engine.predict_batch(batch["pixel_values"],
                                       view_mask=batch["view_mask"])
        for b in range(batch["num_real"]):
            r = results[b]
            gt_lon, gt_lat = batch["coords"][b]
            d = float(haversine_km_np(gt_lat, gt_lon, r.lat, r.lon))
            records.append({
                "location_id": batch["location_id"][b],
                "gt_lat": float(gt_lat),
                "gt_lon": float(gt_lon),
                "pred_lat": r.lat,
                "pred_lon": r.lon,
                "distance_km": d,
                "score": float(geoguessr_score_np(d)),
                "top1_prob": r.top_probs[0],
                "top5": [{"geocell_index": i, "prob": p, "country": c,
                          "admin1": a}
                         for i, p, c, a in zip(r.top_ids, r.top_probs,
                                               r.top_countries,
                                               r.top_admin1)],
            })
    summary = summarize_results(records)
    logger.info(json.dumps(summary))
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(records + [summary], f, indent=1)
        logger.info(f"wrote {len(records)} records -> {output_path}")
    return summary


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-samples", type=int, default=100)
    ap.add_argument("--clip-checkpoint-index", type=int, default=None,
                    help="serve the N-th newest checkpoint of the object "
                    "store's registry (0 the newest)")
    ap.add_argument("--sqlite-path", default=None)
    ap.add_argument("--output-path", default=DEFAULT_OUTPUT)
    ap.add_argument("--backbone", default="tinyvit",
                    choices=("tinyvit", "clip"))
    ap.add_argument("--checkpoint", default=None,
                    help="a reference or timm .pt file")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--centroid-table", default=None,
                    help="centroid .npz matching the checkpoint's cell order")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    summary = run_benchmark(
        num_samples=args.num_samples,
        clip_checkpoint_index=args.clip_checkpoint_index,
        sqlite_path=args.sqlite_path, output_path=args.output_path,
        backbone=args.backbone, checkpoint=args.checkpoint,
        batch_size=args.batch_size, seed=args.seed,
        centroid_table=args.centroid_table, device=args.device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
