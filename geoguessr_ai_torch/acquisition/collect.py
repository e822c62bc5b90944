"""The bulk Street View collection loop (counterpart of
geoguessr_ai_tpu/acquisition/collect.py): for each sampled point fetch a
four-heading block at a random yaw seed, upload the images to the object
store a manifest batch at a time, and keep the collected and failed
points in a ledger, so a run resumes where it stopped.  A 403 (the rate
limit) flushes what was collected and stops the run by raising.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from geoguessr_ai_torch.acquisition.sampling import CollectionLedger
from geoguessr_ai_torch.acquisition.street_view import (
    RateLimitError,
    fetch_block,
)
from geoguessr_ai_torch.utils.logging import logger


def collect_points(points_lnglat: np.ndarray, store, api_key: str,
                   secret: Optional[str] = None,
                   ledger: Optional[CollectionLedger] = None,
                   batch_size: int = 25, seed: Optional[int] = None,
                   session=None, fetch_fn=None) -> dict:
    """Collects panoramas for the (N, 2) (lon, lat) points into ``store``
    (a ``data.s3.ObjectStore``): the yaw seeds from ``random.Random(seed)``,
    one manifest every ``batch_size`` collected points and one for the
    rest; points the ``ledger`` holds are skipped, and each point asked is
    recorded there (collected when all four images came back).
    ``fetch_fn`` replaces ``fetch_block`` (same signature), e.g. offline.
    Returns {"collected", "failed", "batches"}."""
    fetch = fetch_fn or fetch_block
    rng = random.Random(seed)
    points = np.asarray(points_lnglat, np.float64)
    if ledger is not None:
        points = ledger.remaining(points)

    collected = failed = batches = 0
    batch_items = []

    def flush():
        nonlocal batches, batch_items
        if not batch_items:
            return
        store.write_manifest(store.upload_images(batch_items))
        batches += 1
        batch_items = []

    try:
        for lon, lat in points:
            try:
                meta, images = fetch(float(lat), float(lon), api_key, secret,
                                     yaw_seed=rng.uniform(0, 360),
                                     session=session)
            except RateLimitError:
                # flush what was collected, record nothing for this point
                flush()
                logger.error("rate limited (403): stopping collection")
                raise
            if len(images) == 4:
                for heading, blob in images:
                    batch_items.append(
                        (float(lat), float(lon), int(round(heading)), blob))
                collected += 1
                if ledger is not None:
                    ledger.record(float(lat), float(lon), ok=True)
            else:
                failed += 1
                if ledger is not None:
                    ledger.record(float(lat), float(lon), ok=False)
            if collected and collected % batch_size == 0:
                flush()
    finally:
        flush()
    logger.info(f"collection done: {collected} collected, {failed} failed, "
                f"{batches} manifest batches")
    return {"collected": collected, "failed": failed, "batches": batches}
