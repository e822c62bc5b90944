"""Host input pipeline: JPEG decode -> panorama batches -> the device
(counterpart of geoguessr_ai_tpu/data/pipeline.py).

Decode backend: the native libjpeg decoder (``data/native``, built at first
use) when it loads, otherwise PIL.  Both decode straight to the model's
square target size."""

from __future__ import annotations

import collections
import concurrent.futures as cf
import io
import threading
import time
import types
from typing import Dict, Iterator

import numpy as np
import torch

from geoguessr_ai_torch.config import NUM_PANORAMA_VIEWS


def _pil_decode(blob: bytes, size: int) -> np.ndarray:
    """PIL's decode to (size, size, 3) uint8 RGB, resized bilinearly when
    it is not already size x size."""
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def decode_jpeg(blob: bytes, size: int) -> np.ndarray:
    """Decode one JPEG to (size, size, 3) uint8 RGB.

    Native libjpeg first; a native failure (no library, a grayscale, CMYK
    or corrupt stream) falls back to PIL, which converts exotic color
    spaces, as the JAX package does."""
    from geoguessr_ai_torch.data.native import jpeg as native_jpeg

    if native_jpeg.available():
        try:
            return native_jpeg.decode_resize(blob, size)
        except ValueError:
            pass
    return _pil_decode(blob, size)


def _rows(records) -> list:
    """Panorama records as objects with ``location_id``, ``lat``, ``lon``
    and ``images`` attributes: a table's ``itertuples()``, or a sequence of
    dicts or of such objects."""
    if hasattr(records, "itertuples"):
        return list(records.itertuples(index=False))
    return [types.SimpleNamespace(**r) if isinstance(r, dict) else r
            for r in records]


class _RecordBatches:
    """What the batch iterators share: the records, their order (shuffled
    with ``seed`` + epoch when ``shuffle``), and the last short batch
    padded up to batch_size by repeating the last record, or dropped when
    ``drop_remainder``."""

    def __init__(self, records, batch_size: int, num_views: int,
                 shuffle: bool, seed: int, drop_remainder: bool):
        self.rows = _rows(records)
        self.batch_size = batch_size
        self.num_views = num_views
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.rows)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _row_batches(self):
        """One epoch's (records, true count) batches."""
        order = np.arange(len(self.rows))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        for start in range(0, len(order), self.batch_size):
            idx = order[start: start + self.batch_size]
            num_real = len(idx)
            if num_real < self.batch_size:
                if self.drop_remainder:
                    break
                idx = np.concatenate(
                    [idx, np.repeat(idx[-1:], self.batch_size - num_real)])
            yield [self.rows[i] for i in idx], num_real

    @staticmethod
    def _batch(rows, num_real, **arrays) -> Dict:
        return {**arrays,
                "coords": np.array([[r.lon, r.lat] for r in rows],
                                   dtype=np.float32),
                "location_id": [r.location_id for r in rows],
                "num_real": num_real}


class PanoramaBatchIterator(_RecordBatches):
    """Yields host batches from panorama records.

    Each batch dict:
      pixel_values: (B, V, size, size, 3) uint8
      view_mask:    (B, V) float32, 1 for real views, 0 for padding
      coords:       (B, 2) float32 (lng, lat)
      location_id:  list[str]
      num_real:     the true count before the last batch's padding
    Panoramas with fewer than V views, or with views that fail to fetch or
    decode, get black views with mask 0.  The final short batch is padded
    up to batch_size by repeating the last record, or dropped when
    ``drop_remainder``.
    """

    def __init__(self, records, batch_size: int, image_size: int,
                 num_views: int = NUM_PANORAMA_VIEWS, shuffle: bool = False,
                 seed: int = 0, decode_threads: int = 8,
                 drop_remainder: bool = False, fetch_fn=None):
        """fetch_fn maps an entry of a record's ``images`` to JPEG bytes
        (None: the entries are the bytes)."""
        super().__init__(records, batch_size, num_views, shuffle, seed,
                         drop_remainder)
        self.image_size = image_size
        self.decode_threads = decode_threads
        self.fetch_fn = fetch_fn

    def _decode_row(self, row):
        views = np.zeros(
            (self.num_views, self.image_size, self.image_size, 3), np.uint8)
        mask = np.zeros((self.num_views,), np.float32)
        for v, blob in enumerate(row.images[: self.num_views]):
            if self.fetch_fn is not None:
                blob = self.fetch_fn(blob)
            if blob is None:
                continue  # black placeholder (fetch failed)
            try:
                views[v] = decode_jpeg(blob, self.image_size)
                mask[v] = 1.0
            except (OSError, ValueError):
                pass  # undecodable view -> black placeholder, mask 0
        return views, mask

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        with cf.ThreadPoolExecutor(self.decode_threads) as pool:
            for rows, num_real in self._row_batches():
                decoded = list(pool.map(self._decode_row, rows))
                yield self._batch(
                    rows, num_real,
                    pixel_values=np.stack([d[0] for d in decoded]),
                    view_mask=np.stack([d[1] for d in decoded]))


class EmbeddingBatchIterator(_RecordBatches):
    """Yields host batches from panorama records whose ``images`` entries
    are float32 embedding blobs (an embedding SQLite grouped by
    ``sqlite_dataset.build_panorama_table``): the input of embedding-only
    head training.

    Each batch dict:
      embedding:   (B, V, D) float32, zero rows for missing views
      view_mask:   (B, V) float32
      coords:      (B, 2) float32 (lng, lat)
      location_id: list[str]
      num_real:    the true count before the last batch's padding
    The order, the shuffle and the padding are PanoramaBatchIterator's.
    """

    def __init__(self, records, batch_size: int, embed_dim: int,
                 num_views: int = NUM_PANORAMA_VIEWS, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = False):
        super().__init__(records, batch_size, num_views, shuffle, seed,
                         drop_remainder)
        self.embed_dim = embed_dim

    def _row(self, row):
        emb = np.zeros((self.num_views, self.embed_dim), np.float32)
        mask = np.zeros((self.num_views,), np.float32)
        for v, blob in enumerate(row.images[: self.num_views]):
            if blob is None:
                continue
            vec = (np.frombuffer(blob, np.float32)
                   if isinstance(blob, (bytes, memoryview))
                   else np.asarray(blob, np.float32))
            emb[v, : vec.shape[-1]] = vec[: self.embed_dim]
            mask[v] = 1.0
        return emb, mask

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for rows, num_real in self._row_batches():
            packed = [self._row(r) for r in rows]
            yield self._batch(rows, num_real,
                              embedding=np.stack([p[0] for p in packed]),
                              view_mask=np.stack([p[1] for p in packed]))


def prefetch_to_device(iterator, device, depth: int = 2):
    """Keeps the next ``depth`` batches' copies to ``device`` in flight:
    the pixel (or embedding), mask and coordinate arrays go to pinned host
    memory and over with ``non_blocking`` copies on a CUDA device; other
    entries stay on the host."""
    device = torch.device(device)

    def transfer(batch):
        out = dict(batch)
        for k in ("pixel_values", "embedding", "view_mask", "coords"):
            if k in out:
                t = torch.from_numpy(np.ascontiguousarray(out[k]))
                if device.type == "cuda":
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=True)
        return out

    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(transfer(batch))
        if len(queue) >= depth:
            break
    while queue:
        batch = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(transfer(nxt))
        yield batch


class ThroughputMeter:
    """Telemetry of the bulk builders, as the JAX package logs it: mode,
    processed, total, throughput_img_per_s and phase per update."""

    def __init__(self, mode: str, total: int, log_fn=None):
        self.mode = mode
        self.total = total
        self.processed = 0
        self._t0 = time.perf_counter()
        self._log = log_fn or (lambda d: None)
        self._lock = threading.Lock()

    def update(self, n: int, phase: str = "run") -> Dict:
        with self._lock:
            self.processed += n
            dt = max(time.perf_counter() - self._t0, 1e-9)
            rec = {
                "mode": self.mode,
                "processed": self.processed,
                "total": self.total,
                "throughput_img_per_s": self.processed / dt,
                "phase": phase,
            }
        self._log(rec)
        return rec
