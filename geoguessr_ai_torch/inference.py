"""Guess the location of a street-view panorama with the PyTorch port.

    python -m geoguessr_ai_torch.inference [1 or 4 images] [--use-refiner]
        [--backbone tinyvit|clip] [--checkpoint MODEL.pt | RUN/best]
        [--centroid-table PATH] [--device cuda|cpu]

With no images it uses the bundled fixture panorama
(tests/fixtures/heading=*.jpg), and without that a random holdout
panorama of the object store (``data.s3.download_random_panorama``: the
store at ``GEO_TPU_STORE_URL``, else the S3 bucket).  Without
``--checkpoint`` the weights are seeded random; a checkpoint is a
reference ``.pt`` file or a directory of the port's CheckpointStore
(``train()`` writes ``RUN/best``, ``RUN/last``).
A checkpoint's cell order travels with its own centroid
table: ``MODEL.pt_centroids.npz`` beside it is used when
``--centroid-table`` is not given.
"""

from __future__ import annotations

import argparse
import functools
import glob
import logging
import os
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger("geoguessr_ai_torch")


def checkpoint_centroid_table(checkpoint: Optional[str],
                              centroid_table: Optional[str],
                              what: str = "serving") -> Optional[str]:
    """The centroid table to serve ``checkpoint`` with: the one given, else
    the ``<checkpoint>_centroids.npz`` sidecar when it exists, else None
    (the repo's table) with a warning that cells may be permuted."""
    if centroid_table is not None or not checkpoint:
        return centroid_table
    sidecar = checkpoint.rstrip("/") + "_centroids.npz"
    if os.path.exists(sidecar):
        return sidecar
    logger.warning(
        "%s checkpoint %s without a matching centroid table (no %s "
        "sidecar, no --centroid-table): falling back to the repo default "
        "table; if this checkpoint was imported from a reference .pt with "
        "its own proto_df ordering, decoded cells will be permuted",
        what, checkpoint, sidecar)
    return None


@functools.lru_cache(maxsize=None)
def _get_engine(backbone: str, device: Optional[str],
                centroid_table: Optional[str],
                checkpoint: Optional[str] = None):
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.serving.engine import ServingEngine

    centroid_table = checkpoint_centroid_table(checkpoint, centroid_table)
    table = CentroidTable.load(centroid_table) if centroid_table else None
    return ServingEngine(backbone=backbone, centroid_table=table,
                         device=device, checkpoint=checkpoint)


def run_inference(
    image_paths: Sequence[str],
    backbone: str = "tinyvit",
    use_refiner: bool = False,
    device: Optional[str] = None,
    centroid_table: Optional[str] = None,
    checkpoint: Optional[str] = None,
) -> Tuple[float, float, List[int], List[float]]:
    """Predict (lat, lon) for 1 or 4 street-view images.

    Returns (lat, lon, top_ids, top_probs).  ``device`` None means the GPU.
    """
    engine = _get_engine(backbone, device, centroid_table,
                         checkpoint=checkpoint)
    result = engine.predict_images(image_paths)
    lat, lon = result.lat, result.lon
    if use_refiner:
        from geoguessr_ai_torch.models.proto_refiner import try_refine

        refined = try_refine(result, device=device)
        if refined is not None:
            lat, lon = refined
    for rank, (i, p, country, adm1) in enumerate(zip(
            result.top_ids, result.top_probs, result.top_countries,
            result.top_admin1)):
        logger.info(f"top{rank + 1}: cell {i} p={p:.4f} {country} / {adm1}")
    logger.info(f"prediction: lat={lat:.6f} lon={lon:.6f}")
    return lat, lon, result.top_ids, result.top_probs


def fixture_panorama() -> List[str]:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return sorted(glob.glob(os.path.join(root, "tests", "fixtures",
                                         "heading=*.jpg")))[:4]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", nargs="*", help="1 or 4 image paths")
    ap.add_argument("--backbone", default="tinyvit",
                    choices=("tinyvit", "clip"))
    ap.add_argument("--checkpoint", default=None,
                    help="a reference or timm .pt file, or a checkpoint "
                    "directory written by train() (e.g. RUN/best)")
    ap.add_argument("--centroid-table", default=None,
                    help="centroid .npz matching the checkpoint's cell order "
                    "(default: the checkpoint's _centroids.npz sidecar)")
    ap.add_argument("--use-refiner", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    paths = args.images
    if not paths:
        paths = fixture_panorama()
        if len(paths) >= 4:
            logger.info("no images supplied; using the bundled fixture "
                        "panorama")
        else:
            from geoguessr_ai_torch.data.s3 import download_random_panorama

            logger.info("no images supplied and no fixture panorama; "
                        "fetching a random panorama from the object store")
            paths = download_random_panorama()
    lat, lon, _, _ = run_inference(
        paths, backbone=args.backbone, use_refiner=args.use_refiner,
        device=args.device, centroid_table=args.centroid_table,
        checkpoint=args.checkpoint)
    print(f"{lat:.6f} {lon:.6f}")


if __name__ == "__main__":
    main()
