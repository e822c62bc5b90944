"""Streaming datasets over the object store (counterpart of
geoguessr_ai_tpu/data/streaming.py).

``GeoImageStream`` streams single images of the snapshot,
``PanoramaStream`` whole four-heading panoramas, so a panorama never
splits across shards; ``snapshot_panorama_table`` gives the panorama
records and the fetch function that ``train()`` takes to train straight
off the store.  Both streams:

  * read through a local file cache in front of the store (one file per
    key, named by the key's sha1),
  * shard round-robin by ``torch.distributed``'s rank and world size when
    a process group is initialised (or an explicit ``shard, num_shards``),
  * fetch an image up to 3 times and put a black placeholder in place of
    one that fails to fetch or decode,
  * decode through ``data.pipeline.decode_jpeg``.

They yield numpy uint8 images and target dicts.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from geoguessr_ai_torch.data.pipeline import decode_jpeg
from geoguessr_ai_torch.data.s3 import ObjectStore, image_key
from geoguessr_ai_torch.data.sqlite_dataset import Panorama
from geoguessr_ai_torch.utils.logging import logger

DEFAULT_CACHE_DIR = "./.s3cache"


class _CachedFetcher:
    """``store.read_bytes`` behind a local file cache, with retries; None
    after the last failed try."""

    def __init__(self, store: ObjectStore, cache_dir: str = DEFAULT_CACHE_DIR,
                 retries: int = 3):
        self.store = store
        self.cache_dir = cache_dir
        self.retries = retries
        os.makedirs(cache_dir, exist_ok=True)

    def fetch(self, key: str) -> Optional[bytes]:
        cpath = os.path.join(self.cache_dir,
                             hashlib.sha1(key.encode()).hexdigest())
        if os.path.exists(cpath):
            with open(cpath, "rb") as f:
                return f.read()
        for attempt in range(self.retries):
            try:
                blob = self.store.read_bytes(key)
                tmp = f"{cpath}.{os.getpid()}.tmp"  # ranks share the cache
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, cpath)  # a reader never sees half a file
                return blob
            except Exception as e:
                if attempt == self.retries - 1:
                    logger.warning(f"fetch failed after retries: {key} ({e})")
        return None


def _shard_params(shard: Optional[int],
                  num_shards: Optional[int]) -> Tuple[int, int]:
    if shard is not None and num_shards is not None:
        return shard, num_shards
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_len(n: int, shard: int, num_shards: int) -> int:
    return (n - shard + num_shards - 1) // num_shards


def _groups(rows: List[Dict]) -> List[List[Dict]]:
    """The rows by location_id, in location_id order, each group's rows
    sorted by heading."""
    by_loc: Dict[str, List[Dict]] = {}
    for r in rows:
        by_loc.setdefault(r["location_id"], []).append(r)
    return [sorted(by_loc[k], key=lambda r: r["heading"])
            for k in sorted(by_loc)]


class GeoImageStream:
    """Iterates (image (S, S, 3) uint8, target dict) over the snapshot's
    rows (``snapshot_rows``, else the store's latest snapshot) in order;
    ``len()`` is this shard's count."""

    def __init__(self, store: ObjectStore, image_size: int,
                 snapshot_rows: Optional[List[Dict]] = None,
                 holdout: bool = False, cache_dir: str = DEFAULT_CACHE_DIR,
                 shard: Optional[int] = None,
                 num_shards: Optional[int] = None):
        self.store = store
        self.rows = (snapshot_rows if snapshot_rows is not None
                     else store.load_latest_snapshot(holdout))
        self.image_size = image_size
        self.fetcher = _CachedFetcher(store, cache_dir)
        self.shard, self.num_shards = _shard_params(shard, num_shards)

    def __len__(self) -> int:
        return _shard_len(len(self.rows), self.shard, self.num_shards)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Dict]]:
        for i, row in enumerate(self.rows):
            if i % self.num_shards != self.shard:
                continue
            blob = self.fetcher.fetch(image_key(row["location_id"],
                                                int(row["heading"])))
            img = np.zeros((self.image_size, self.image_size, 3), np.uint8)
            if blob is not None:
                try:
                    img = decode_jpeg(blob, self.image_size)
                except Exception:
                    pass  # the black placeholder
            yield img, {"lat": float(row["lat"]), "lon": float(row["lon"]),
                        "location_id": row["location_id"],
                        "heading": int(row["heading"]),
                        "capture_date": row.get("capture_date")}


def snapshot_panorama_table(
        store: ObjectStore, holdout: bool = False,
        cache_dir: str = DEFAULT_CACHE_DIR,
) -> Tuple[List[Panorama], Callable[[str], Optional[bytes]]]:
    """The latest snapshot as panorama records whose ``images`` are store
    keys, with the cached fetch function that maps a key to its bytes:
    give both to ``train()`` (or ``PanoramaBatchIterator``) to train off the
    store without a local SQLite.  One Panorama a location, in location_id
    order, views sorted by heading, the point that of the first view; every
    location, whatever its number of headings."""
    fetcher = _CachedFetcher(store, cache_dir)
    table = [Panorama(g[0]["location_id"], float(g[0]["lat"]),
                      float(g[0]["lon"]), [r["heading"] for r in g],
                      [image_key(g[0]["location_id"], int(r["heading"]))
                       for r in g])
             for g in _groups(store.load_latest_snapshot(holdout))]
    return table, fetcher.fetch


class PanoramaStream:
    """Iterates (views (4, S, S, 3) uint8, target dict) over the
    locations with exactly four headings, in location_id order, views by
    heading; a panorama never crosses shards.  ``len()`` is this shard's
    count."""

    def __init__(self, store: ObjectStore, image_size: int,
                 snapshot_rows: Optional[List[Dict]] = None,
                 holdout: bool = False, cache_dir: str = DEFAULT_CACHE_DIR,
                 shard: Optional[int] = None,
                 num_shards: Optional[int] = None):
        self.store = store
        rows = (snapshot_rows if snapshot_rows is not None
                else store.load_latest_snapshot(holdout))
        self.groups = [g for g in _groups(rows) if len(g) == 4]
        self.image_size = image_size
        self.fetcher = _CachedFetcher(store, cache_dir)
        self.shard, self.num_shards = _shard_params(shard, num_shards)

    def __len__(self) -> int:
        return _shard_len(len(self.groups), self.shard, self.num_shards)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Dict]]:
        for i, group in enumerate(self.groups):
            if i % self.num_shards != self.shard:
                continue
            views = np.zeros((4, self.image_size, self.image_size, 3),
                             np.uint8)
            for v, row in enumerate(group):
                blob = self.fetcher.fetch(image_key(row["location_id"],
                                                    int(row["heading"])))
                if blob is not None:
                    try:
                        views[v] = decode_jpeg(blob, self.image_size)
                    except Exception:
                        pass  # the black placeholder
            yield views, {"lat": float(group[0]["lat"]),
                          "lon": float(group[0]["lon"]),
                          "location_id": group[0]["location_id"],
                          "headings": [r["heading"] for r in group]}
