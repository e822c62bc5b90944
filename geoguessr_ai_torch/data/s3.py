"""Object store: content-addressed images, manifests, snapshots, dataset
pointers and the model-checkpoint registry (counterpart of
geoguessr_ai_tpu/data/s3.py), on fsspec, so the same code runs against
s3:// (with s3fs installed), file:// or any other fsspec protocol.

The keys are the JAX package's, so both packages share a bucket:

  v1/images/location_id=<id>/heading=<XXX>.jpg        (content-addressed)
  v1/manifest/run_ts=<ts>/batch-0.parquet             (ingestion manifests)
  v1/snapshot/snapshot_ts=<ts>/part-0.parquet         (deduplicated snapshot)
  v1/snapshot/_latest.json                            ({"s3": <prefix URL>})
  holdout_dataset/{manifest,snapshot}/...             (the holdout tree)
  v1/sqlite/<name>/run_ts=<ts>/dataset.sqlite + _latest.json
  v1/saved_models/run_ts=<ts>/... + _latest.json      (checkpoint registry)

location_id = sha1("geo:v1:" + the >ii-packed lat/lon in 1e-7 degree
steps)[:12].  Tables are lists of row dicts (the JAX package holds pandas
DataFrames); Parquet is read and written through pyarrow.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import struct
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.utils.logging import logger

V1 = "v1"
HOLDOUT_PREFIX = "holdout_dataset"

#: ``ingest_local_folder``'s file names.
STREETVIEW_RE = re.compile(
    r"^streetview_([-+]?\d+(?:\.\d+)?)_([-+]?\d+(?:\.\d+)?)"
    r"_heading_(\d{1,3})\.jpg$", re.IGNORECASE)


def quantize_coord(value: float) -> int:
    """Degrees to integer steps of 1e-7 degree (Python's round: half to
    even)."""
    return int(round(float(value) * 1e7))


def location_id(lat: float, lon: float, hex_len: int = 12) -> str:
    """The content address of a point: sha1 over ``b"geo:v1:"`` and the
    big-endian int32 pair of its quantized lat and lon, -0.0 taken as 0.0;
    ValueError outside [-90, 90] x [-180, 180]."""
    if not (-90 <= lat <= 90 and -180 <= lon <= 180):
        raise ValueError("lat/lon out of bounds")
    if lat == 0.0:
        lat = 0.0  # -0.0
    if lon == 0.0:
        lon = 0.0
    payload = b"geo:v1:" + struct.pack(
        ">ii", quantize_coord(lat), quantize_coord(lon))
    return hashlib.sha1(payload).hexdigest()[:hex_len]


def image_key(loc_id: str, heading: int) -> str:
    return f"{V1}/images/location_id={loc_id}/heading={int(heading):03d}.jpg"


def _timestamp() -> str:
    # one second's resolution: two writes in one second share a prefix,
    # as in the JAX package
    return time.strftime("%Y%m%dT%H%M%S")


def _columns(rows: Sequence[Dict]) -> List[str]:
    """The union of the rows' keys in order of first appearance (the
    columns pandas' concat gives)."""
    cols: Dict[str, None] = {}
    for r in rows:
        for k in r:
            cols.setdefault(k, None)
    return list(cols)


def drop_duplicate_rows(rows: Sequence[Dict],
                        subset: Sequence[str]) -> List[Dict]:
    """pandas' ``drop_duplicates(subset, keep="last")``: of the rows that
    share ``subset``'s values only the last stays, and the kept rows keep
    their order."""
    last = {tuple(r.get(k) for k in subset): i for i, r in enumerate(rows)}
    keep = set(last.values())
    return [r for i, r in enumerate(rows) if i in keep]


class ObjectStore:
    """fsspec-backed store rooted at ``base_url`` (e.g. s3://bucket or
    file:///data/bucket); None means ``GEO_TPU_STORE_URL``, else
    ``s3://{config.S3_BUCKET}``.  Without s3fs an s3:// store raises
    fsspec's ImportError: nothing falls back to a local store."""

    def __init__(self, base_url: Optional[str] = None):
        import fsspec

        base_url = base_url or os.environ.get(
            "GEO_TPU_STORE_URL", f"s3://{C.S3_BUCKET}")
        self.base_url = base_url.rstrip("/")
        self.fs, self.root = fsspec.core.url_to_fs(self.base_url)

    # -- low-level ------------------------------------------------------

    def _p(self, key: str) -> str:
        return f"{self.root}/{key}"

    def exists(self, key: str) -> bool:
        return self.fs.exists(self._p(key))

    def read_bytes(self, key: str) -> bytes:
        with self.fs.open(self._p(key), "rb") as f:
            return f.read()

    def write_bytes(self, key: str, data: bytes) -> None:
        try:
            self.fs.makedirs(os.path.dirname(self._p(key)), exist_ok=True)
        except Exception:
            pass  # object stores have no directories
        with self.fs.open(self._p(key), "wb") as f:
            f.write(data)

    def read_json(self, key: str) -> Dict:
        return json.loads(self.read_bytes(key).decode())

    def write_json(self, key: str, obj: Dict) -> None:
        self.write_bytes(key, json.dumps(obj, indent=1).encode())

    def list(self, prefix: str) -> List[str]:
        """Every key under ``prefix``, sorted."""
        try:
            return [p[len(self.root) + 1:]
                    for p in self.fs.find(self._p(prefix))]
        except FileNotFoundError:
            return []

    def read_parquet(self, key: str) -> List[Dict]:
        """A Parquet object's rows as dicts; pandas' stored index columns
        (``__index_level_N__``) are left out, as pandas reads them into the
        index."""
        import pyarrow.parquet as pq

        table = pq.read_table(io.BytesIO(self.read_bytes(key)))
        keep = [n for n in table.column_names
                if not n.startswith("__index_level_")]
        return table.select(keep).to_pylist()

    def write_parquet(self, key: str, rows: Sequence[Dict]) -> None:
        """Rows as one Parquet object, one column per key (the union of
        the rows' keys; a row without one holds null there)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        table = pa.table({c: [r.get(c) for r in rows]
                          for c in _columns(rows)})
        buf = io.BytesIO()
        pq.write_table(table, buf)
        self.write_bytes(key, buf.getvalue())

    def read_parquet_prefix(self, prefix: str) -> List[Dict]:
        """Every Parquet object under a prefix, concatenated in key
        order."""
        parts = [self.read_parquet(k) for k in self.list(prefix)
                 if k.endswith(".parquet")]
        if not parts:
            raise FileNotFoundError(f"no parquet under {prefix}")
        rows = [r for part in parts for r in part]
        cols = _columns(rows)
        return [{c: r.get(c) for c in cols} for r in rows]

    # -- images ---------------------------------------------------------

    def upload_images(self, items: Sequence[Tuple[float, float, int, bytes]],
                      threads: int = 32) -> List[Dict]:
        """Threaded upload of (lat, lon, heading, jpeg) items; returns
        their manifest rows in item order."""

        def put(item):
            lat, lon, heading, blob = item
            lid = location_id(lat, lon)
            key = image_key(lid, heading)
            self.write_bytes(key, blob)
            return {"location_id": lid, "lat": lat, "lon": lon,
                    "heading": int(heading),
                    "image_path": f"{self.base_url}/{key}",
                    "batch_date": time.strftime("%Y-%m-%d")}

        with ThreadPoolExecutor(threads) as pool:
            return list(pool.map(put, items))

    def ingest_local_folder(self, folder: str, threads: int = 32,
                            holdout: bool = False) -> int:
        """Uploads a folder's ``streetview_<lat>_<lon>_heading_<h>.jpg``
        files (in name order; other files are skipped) and writes their
        manifest; returns the images ingested."""
        items = []
        for fname in sorted(os.listdir(folder)):
            m = STREETVIEW_RE.match(fname)
            if not m:
                continue
            with open(os.path.join(folder, fname), "rb") as f:
                items.append((float(m.group(1)), float(m.group(2)),
                              int(m.group(3)), f.read()))
        if not items:
            return 0
        self.write_manifest(self.upload_images(items, threads=threads),
                            holdout=holdout)
        return len(items)

    @staticmethod
    def _manifest_prefix(holdout: bool) -> str:
        # the holdout tree is a separate prefix, so its snapshot never
        # takes in a training manifest
        return f"{HOLDOUT_PREFIX}/manifest" if holdout else f"{V1}/manifest"

    @staticmethod
    def _snapshot_prefix(holdout: bool) -> str:
        return f"{HOLDOUT_PREFIX}/snapshot" if holdout else f"{V1}/snapshot"

    def write_manifest(self, rows: Sequence[Dict],
                       run_ts: Optional[str] = None,
                       holdout: bool = False) -> str:
        run_ts = run_ts or _timestamp()
        key = (f"{self._manifest_prefix(holdout)}/run_ts={run_ts}/"
               "batch-0.parquet")
        self.write_parquet(key, rows)
        return key

    # -- snapshots ------------------------------------------------------

    def merge_snapshot(self, holdout: bool = False) -> str:
        """The previous snapshot followed by every manifest, deduplicated
        on (location_id, heading) keeping the last row, written as a new
        snapshot with the ``_latest.json`` pointer ``{"s3": "<base>/<prefix>/",
        "rows": n}``; returns the snapshot's prefix."""
        manifests = self.read_parquet_prefix(
            f"{self._manifest_prefix(holdout)}/")
        try:
            rows = self.load_latest_snapshot(holdout) + manifests
        except FileNotFoundError:
            rows = manifests
        cols = _columns(rows)
        merged = drop_duplicate_rows(
            [{c: r.get(c) for c in cols} for r in rows],
            ["location_id", "heading"])
        snap_prefix = (f"{self._snapshot_prefix(holdout)}/"
                       f"snapshot_ts={_timestamp()}")
        self.write_parquet(f"{snap_prefix}/part-0.parquet", merged)
        self.write_json(f"{self._snapshot_prefix(holdout)}/_latest.json",
                        {"s3": f"{self.base_url}/{snap_prefix}/",
                         "rows": len(merged)})
        return snap_prefix

    def load_latest_snapshot(self, holdout: bool = False) -> List[Dict]:
        """The rows of every Parquet part under the latest snapshot's
        pointer: a ``{"s3": URL}`` under this store's base, or under any
        other ``scheme://bucket/`` (the pointer another stack wrote), or a
        legacy ``{"key": key}``.  FileNotFoundError without a pointer."""
        pointer_key = f"{self._snapshot_prefix(holdout)}/_latest.json"
        if not self.exists(pointer_key):
            raise FileNotFoundError(f"{pointer_key} missing")
        pointer = self.read_json(pointer_key)
        if "s3" in pointer:
            prefix = pointer["s3"]
            if prefix.startswith(self.base_url + "/"):
                prefix = prefix[len(self.base_url) + 1:]
            elif "://" in prefix:
                prefix = prefix.split("://", 1)[1].split("/", 1)[1]
            return self.read_parquet_prefix(prefix.rstrip("/") + "/")
        return self.read_parquet(pointer["key"])

    def download_random_panorama(self, out_dir: str, holdout: bool = True,
                                 seed: Optional[int] = None
                                 ) -> Tuple[List[str], float, float]:
        """One panorama of exactly four headings, drawn by
        ``default_rng(seed)`` among those in location_id order, written to
        ``out_dir/heading=XXX.jpg`` in heading order; returns (paths, lat,
        lon), the point of the group's first snapshot row."""
        by_loc: Dict[str, List[Dict]] = {}
        for r in self.load_latest_snapshot(holdout):
            by_loc.setdefault(r["location_id"], []).append(r)
        groups = [by_loc[k] for k in sorted(by_loc) if len(by_loc[k]) == 4]
        rng = np.random.default_rng(seed)
        group = groups[int(rng.integers(len(groups)))]
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for row in sorted(group, key=lambda r: r["heading"]):
            p = os.path.join(out_dir, f"heading={int(row['heading']):03d}.jpg")
            with open(p, "wb") as f:
                f.write(self.read_bytes(image_key(row["location_id"],
                                                  row["heading"])))
            paths.append(p)
        return paths, float(group[0]["lat"]), float(group[0]["lon"])

    # -- snapshot -> SQLite dataset -------------------------------------

    def build_sqlite_from_snapshot(self, out_path: str, holdout: bool = False,
                                   fetch_threads: int = 64,
                                   window: int = 10_000,
                                   publish: bool = False,
                                   log_fn=None) -> int:
        """The raw-JPEG SQLite dataset of the latest snapshot: threaded
        GETs, ``window`` rows at a time, into one batched writer
        (``create_sqlite_from_records``); an image that fails to fetch is
        left out.  ``publish`` uploads the file with its pointer.  Returns
        the rows written."""
        from geoguessr_ai_torch.data.pipeline import ThroughputMeter
        from geoguessr_ai_torch.data.sqlite_dataset import (
            create_sqlite_from_records,
        )

        rows = self.load_latest_snapshot(holdout)
        meter = ThroughputMeter("build_sqlite_raw", len(rows), log_fn)

        def fetch(row):
            try:
                blob = self.read_bytes(image_key(row["location_id"],
                                                 int(row["heading"])))
            except Exception:
                return None
            return {"location_id": row["location_id"],
                    "lat": float(row["lat"]), "lon": float(row["lon"]),
                    "heading": int(row["heading"]),
                    "capture_date": row.get("capture_date"),
                    "pano_id": row.get("pano_id"),
                    "batch_date": row.get("batch_date"),
                    "image": blob}

        def record_stream():
            with ThreadPoolExecutor(fetch_threads) as pool:
                for start in range(0, len(rows), window):
                    chunk = rows[start: start + window]
                    for rec in pool.map(fetch, chunk):
                        if rec is not None:
                            yield rec
                    meter.update(len(chunk), phase="fetch+insert")

        written = create_sqlite_from_records(out_path, record_stream())
        logger.info(f"built {written} rows -> {out_path}")
        if publish:
            self.publish_sqlite(out_path, "raw")
        return written

    # -- dataset pointers -----------------------------------------------

    def publish_sqlite(self, local_path: str, name: str = "raw") -> str:
        ts = _timestamp()
        key = f"{V1}/sqlite/{name}/run_ts={ts}/dataset.sqlite"
        with open(local_path, "rb") as f:
            self.write_bytes(key, f.read())
        self.write_json(f"{V1}/sqlite/{name}/_latest.json",
                        {"run_ts": ts, "key": key})
        return key

    def download_latest_sqlite(self, name: str, out_path: str) -> str:
        pointer = self.read_json(f"{V1}/sqlite/{name}/_latest.json")
        with open(out_path, "wb") as f:
            f.write(self.read_bytes(pointer["key"]))
        return out_path

    def download_climate_file(
            self, path: str = "koppen_geiger_climatezones_1991_2020_1km.tif"
    ) -> str:
        """Fetches the Koeppen-Geiger GeoTIFF (``v1/climate/<name>``) to
        ``path`` as bytes; a non-empty local copy is kept as it is."""
        if os.path.isfile(path) and os.path.getsize(path) > 0:
            return path
        key = f"{V1}/climate/{os.path.basename(path)}"
        with open(path, "wb") as f:
            f.write(self.read_bytes(key))
        return path

    # -- checkpoint registry --------------------------------------------

    def upload_model_checkpoint(self, local_dir_or_file: str) -> str:
        """Uploads a checkpoint file, or a directory (e.g. the port's
        ``<run>/best`` holding ``state.pt``) with its relative paths, under
        ``v1/saved_models/run_ts=<ts>/`` and points ``_latest.json`` at it;
        returns that prefix."""
        ts = _timestamp()
        base = f"{V1}/saved_models/run_ts={ts}"
        if os.path.isdir(local_dir_or_file):
            for dirpath, _, files in os.walk(local_dir_or_file):
                for fn in files:
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, local_dir_or_file)
                    with open(full, "rb") as f:
                        self.write_bytes(f"{base}/{rel}", f.read())
        else:
            with open(local_dir_or_file, "rb") as f:
                self.write_bytes(
                    f"{base}/{os.path.basename(local_dir_or_file)}", f.read())
        self.write_json(f"{V1}/saved_models/_latest.json",
                        {"run_ts": ts, "key": base})
        return base

    def list_model_checkpoints(self) -> List[str]:
        """The registry's ``run_ts=<ts>`` names, newest first."""
        keys = self.list(f"{V1}/saved_models/")
        return sorted({k.split("/")[2] for k in keys
                       if k.startswith(f"{V1}/saved_models/run_ts=")},
                      reverse=True)

    def download_model_checkpoint(self, out_dir: str,
                                  nth_most_recent: int = 0) -> str:
        """Downloads the ``nth_most_recent`` checkpoint (0 the newest; an
        index past the oldest takes the oldest) into ``out_dir``; returns
        ``out_dir``."""
        runs = self.list_model_checkpoints()
        if not runs:
            raise FileNotFoundError("no checkpoints in registry")
        base = f"{V1}/saved_models/{runs[min(nth_most_recent, len(runs) - 1)]}"
        os.makedirs(out_dir, exist_ok=True)
        for key in self.list(base):
            dst = os.path.join(out_dir, key[len(base) + 1:])
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            with open(dst, "wb") as f:
                f.write(self.read_bytes(key))
        return out_dir


# ---------------------------------------------------------------------------
# Module-level conveniences of the entry points, on the default store
# ---------------------------------------------------------------------------


def download_random_panorama(out_dir: Optional[str] = None) -> List[str]:
    """A random holdout panorama of the default store, written under
    ``out_dir`` (default: ``geo_tpu_pano`` in the temp directory)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "geo_tpu_pano")
    paths, lat, lon = ObjectStore().download_random_panorama(out_dir)
    logger.info(f"panorama at lat={lat} lon={lon}")
    return paths


def download_nth_model_checkpoint(n: int,
                                  out_dir: Optional[str] = None) -> str:
    """The n-th newest checkpoint of the default store's registry,
    downloaded to ``out_dir`` (default: ``geo_tpu_ckpt`` in the temp
    directory)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "geo_tpu_ckpt")
    return ObjectStore().download_model_checkpoint(out_dir, n)
