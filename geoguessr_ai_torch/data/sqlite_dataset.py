"""The SQLite panorama and embedding datasets: reader, panorama grouping,
train/val split and writer (counterpart of
geoguessr_ai_tpu/data/sqlite_dataset.py).

One ``samples`` table keyed (location_id, heading): JPEG blobs in a raw
dataset, float32 embedding blobs with their ``embedding_dim`` in an
embedding dataset.  The schema, the WAL pragmas and ``INSERT OR REPLACE``
are the JAX package's, so either package reads what the other writes.
Rows come back as namedtuples with the table's columns as attributes (the
JAX package returns a pandas DataFrame; the port needs no pandas).
"""

from __future__ import annotations

import collections
import os
import sqlite3
from typing import Dict, Iterable, List, Sequence

import numpy as np

SCHEMA = """
CREATE TABLE IF NOT EXISTS samples (
  location_id TEXT NOT NULL,
  lat REAL NOT NULL,
  lon REAL NOT NULL,
  heading INTEGER NOT NULL,
  capture_date TEXT,
  pano_id TEXT,
  batch_date TEXT,
  image BLOB NOT NULL,
  PRIMARY KEY (location_id, heading)
) WITHOUT ROWID;
"""

EMBEDDING_SCHEMA = """
CREATE TABLE IF NOT EXISTS samples (
  location_id TEXT NOT NULL,
  lat REAL NOT NULL,
  lon REAL NOT NULL,
  heading INTEGER NOT NULL,
  capture_date TEXT,
  pano_id TEXT,
  batch_date TEXT,
  embedding BLOB NOT NULL,
  embedding_dim INTEGER NOT NULL,
  PRIMARY KEY (location_id, heading)
) WITHOUT ROWID;
"""


def open_readonly(path: str) -> sqlite3.Connection:
    """A read-only connection that can never write WAL state."""
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    conn.execute("PRAGMA query_only=1;")
    return conn


def load_sqlite_dataset(path: str) -> List[tuple]:
    """Every row of ``samples``, in table order, as namedtuples with the
    table's columns as attributes; blobs as ``bytes``."""
    conn = open_readonly(path)
    try:
        cur = conn.execute("SELECT * FROM samples")
        cols = [d[0] for d in cur.description]
        Row = collections.namedtuple("Row", cols)
        return [Row(*(bytes(v) if isinstance(v, memoryview) else v
                      for v in r)) for r in cur]
    finally:
        conn.close()


#: One location's panorama: heading-sorted views and their blobs.
Panorama = collections.namedtuple(
    "Panorama", ["location_id", "lat", "lon", "headings", "images"])


def build_panorama_table(rows: Sequence) -> List[Panorama]:
    """Per-image rows (namedtuples or dicts with ``location_id``, ``lat``,
    ``lon``, ``heading`` and an ``image`` or ``embedding`` blob) -> one
    Panorama per location, in location order, views sorted by heading;
    rows without a blob are left out, and so is a location with none."""
    rows = [r._asdict() if hasattr(r, "_asdict") else dict(r) for r in rows]
    if not rows:
        raise ValueError("no panorama records in dataset")
    missing = {"location_id", "lat", "lon", "heading"}.difference(rows[0])
    if missing:
        raise ValueError(f"missing columns: {missing}")
    blob = "image" if "image" in rows[0] else "embedding"
    by_location: Dict[str, List[Dict]] = collections.defaultdict(list)
    for r in rows:
        if r.get(blob) is not None:
            by_location[r["location_id"]].append(r)
    out = []
    for location_id in sorted(by_location):
        group = sorted(by_location[location_id], key=lambda r: r["heading"])
        out.append(Panorama(location_id, float(group[0]["lat"]),
                            float(group[0]["lon"]),
                            [r["heading"] for r in group],
                            [r[blob] for r in group]))
    if not out:
        raise ValueError("no panorama records in dataset")
    return out


def load_sqlite_panorama_dataset(path: str) -> List[Panorama]:
    """The panoramas of a SQLite dataset (``build_panorama_table``)."""
    return build_panorama_table(load_sqlite_dataset(path))


def split_train_val(panoramas: Sequence, val_fraction: float = 0.1):
    """(train, val): the first int(n * (1 - f)) panoramas and the rest, in
    order, unshuffled; val is also the benchmark's test split."""
    n_train = int(len(panoramas) * (1.0 - val_fraction))
    return panoramas[:n_train], panoramas[n_train:]


def create_sqlite_from_records(
    path: str,
    records: Iterable[Dict],
    batch_size: int = 1000,
    embedding: bool = False,
) -> int:
    """Writes records (dicts with the schema's columns) from one writer in
    batched transactions; returns the number of rows written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    conn = sqlite3.connect(path)
    try:
        cur = conn.cursor()
        cur.execute("PRAGMA journal_mode=WAL;")
        cur.execute("PRAGMA synchronous=NORMAL;")
        cur.execute("PRAGMA temp_store=MEMORY;")
        cur.executescript(EMBEDDING_SCHEMA if embedding else SCHEMA)
        conn.commit()
        blob = ["embedding", "embedding_dim"] if embedding else ["image"]
        cols = ["location_id", "lat", "lon", "heading", "capture_date",
                "pano_id", "batch_date"] + blob
        sql = (f"INSERT OR REPLACE INTO samples ({', '.join(cols)}) "
               f"VALUES ({', '.join('?' * len(cols))})")
        total = 0
        buf: List[Sequence] = []
        for rec in records:
            buf.append(tuple(rec.get(c) for c in cols))
            if len(buf) >= batch_size:
                cur.executemany(sql, buf)
                conn.commit()
                total += len(buf)
                buf = []
        if buf:
            cur.executemany(sql, buf)
            conn.commit()
            total += len(buf)
        return total
    finally:
        conn.close()


def read_embeddings(path: str) -> List[tuple]:
    """The rows of an embedding dataset with ``embedding`` decoded to a
    float32 array of ``embedding_dim`` values."""
    rows = load_sqlite_dataset(path)
    if rows and "embedding_dim" not in rows[0]._fields:
        raise ValueError("not an embedding dataset")
    return [r._replace(embedding=np.frombuffer(r.embedding, np.float32,
                                               count=int(r.embedding_dim)))
            for r in rows]
