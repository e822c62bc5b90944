"""Point sampling for data acquisition (counterpart of
geoguessr_ai_tpu/acquisition/sampling.py): uniform points in admin
polygons, area-weighted across a multipolygon with a density scalar,
deduplicated at 1e-6 degree and, with an API key, kept only where the
Street View metadata API finds imagery; and the collection ledger.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, Optional, Sequence

import numpy as np

from geoguessr_ai_torch.geo.polygon import polygon_area, sample_points_uniform


def sample_points_in_polygons(polygons: Sequence[np.ndarray],
                              total_points: int, density_scalar: float = 1.0,
                              rng: Optional[np.random.Generator] = None
                              ) -> np.ndarray:
    """round(total_points * density_scalar) (lon, lat) points, spread over
    the (M, 2) (lon, lat) rings by a multinomial draw on their areas and
    sampled uniformly in each; (0, 2) when there is nothing to draw."""
    rng = rng or np.random.default_rng()
    n = max(0, int(round(total_points * density_scalar)))
    if n == 0 or not polygons:
        return np.zeros((0, 2))
    areas = np.array([polygon_area(p) for p in polygons], dtype=np.float64)
    if areas.sum() <= 0:
        return np.zeros((0, 2))
    counts = rng.multinomial(n, areas / areas.sum())
    parts = [sample_points_uniform(poly, int(c), rng)
             for poly, c in zip(polygons, counts) if c > 0]
    if not parts:
        return np.zeros((0, 2))
    return np.concatenate(parts, axis=0)


def dedupe_points(points: np.ndarray, precision: float = 1e-6) -> np.ndarray:
    """The first of each group of points equal at ``precision`` degree, in
    their order."""
    if len(points) == 0:
        return points
    quant = np.round(np.asarray(points, np.float64) / precision).astype(
        np.int64)
    _, keep = np.unique(quant, axis=0, return_index=True)
    return points[np.sort(keep)]


def validate_points(points: np.ndarray,
                    validator: Callable[[float, float], bool],
                    threads: int = 16) -> np.ndarray:
    """The points for which ``validator(lat, lon)`` holds, asked on
    ``threads`` threads; a validator that raises rejects its point."""

    def check(pt):
        try:
            return bool(validator(float(pt[1]), float(pt[0])))
        except Exception:
            return False

    with cf.ThreadPoolExecutor(threads) as pool:
        mask = list(pool.map(check, points))
    return points[np.asarray(mask, bool)]


def sample_sv_points_from_polygons(polygons: Sequence[np.ndarray],
                                   total_points: int,
                                   api_key: Optional[str] = None,
                                   secret: Optional[str] = None,
                                   density_scalar: float = 1.0,
                                   rng: Optional[np.random.Generator] = None,
                                   threads: int = 16) -> np.ndarray:
    """Sample, deduplicate and, given ``api_key``, keep the points where the
    live Street View metadata API finds imagery (needs the network)."""
    pts = dedupe_points(sample_points_in_polygons(polygons, total_points,
                                                  density_scalar, rng))
    if api_key:
        from geoguessr_ai_torch.acquisition.street_view import fetch_metadata

        pts = validate_points(
            pts, lambda lat, lon: fetch_metadata(lat, lon, api_key, secret)
            is not None, threads=threads)
    return pts


class CollectionLedger:
    """Resumable bookkeeping of a collection run: one ``lat,lon`` line a
    point in the collected or the failed file."""

    def __init__(self, collected_path: str, failed_path: str):
        self.collected_path = collected_path
        self.failed_path = failed_path

    @staticmethod
    def _load(path: str) -> set:
        if not os.path.exists(path):
            return set()
        out = set()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    lat, lon = line.split(",")[:2]
                    out.add((float(lat), float(lon)))
        return out

    def remaining(self, points: np.ndarray) -> np.ndarray:
        """The (lon, lat) points in neither file, matched exactly and
        rounded to 6 decimals."""
        done = self._load(self.collected_path) | self._load(self.failed_path)
        mask = [(round(float(p[1]), 6), round(float(p[0]), 6)) not in done
                and (float(p[1]), float(p[0])) not in done for p in points]
        return points[np.asarray(mask, bool)]

    def record(self, lat: float, lon: float, ok: bool) -> None:
        with open(self.collected_path if ok else self.failed_path, "a") as f:
            f.write(f"{lat},{lon}\n")
