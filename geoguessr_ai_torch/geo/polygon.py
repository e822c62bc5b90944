"""Minimal polygon geometry in numpy (copy of
geoguessr_ai_tpu/geo/polygon.py): vectorised point-in-polygon (ray
casting), shoelace area, bbox and rejection sampling, for the labeling of
``data.preprocessing``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def polygon_area(polygon: np.ndarray) -> float:
    """Shoelace area of a (M, 2) (lon, lat) ring (degrees², unsigned)."""
    p = np.asarray(polygon, dtype=np.float64)
    x, y = p[:, 0], p[:, 1]
    return float(
        0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def polygon_bbox(polygon: np.ndarray) -> Tuple[float, float, float, float]:
    p = np.asarray(polygon, dtype=np.float64)
    return (
        float(p[:, 0].min()),
        float(p[:, 1].min()),
        float(p[:, 0].max()),
        float(p[:, 1].max()),
    )


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting containment test.

    Args:
      points: (N, 2) (lon, lat).
      polygon: (M, 2) ring (closed or open).

    Returns:
      (N,) bool mask.
    """
    pts = np.asarray(points, dtype=np.float64)
    poly = np.asarray(polygon, dtype=np.float64)
    if len(poly) > 1 and np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x1, y1 = poly[:, 0][None, :], poly[:, 1][None, :]
    x2 = np.roll(poly[:, 0], -1)[None, :]
    y2 = np.roll(poly[:, 1], -1)[None, :]

    cond = (y1 > y) != (y2 > y)
    denom = np.where(y2 - y1 == 0.0, 1e-300, y2 - y1)
    x_int = x1 + (y - y1) * (x2 - x1) / denom
    crossings = np.sum(cond & (x < x_int), axis=1)
    return (crossings % 2) == 1


def sample_points_uniform(
    polygon: np.ndarray,
    n: int,
    rng: np.random.Generator,
    max_attempts_factor: int = 200,
) -> np.ndarray:
    """Rejection-sample n uniform points inside one polygon ring."""
    lon0, lat0, lon1, lat1 = polygon_bbox(polygon)
    out: List[np.ndarray] = []
    need = n
    attempts = 0
    while need > 0 and attempts < max_attempts_factor:
        batch = max(need * 4, 64)
        cand = np.stack(
            [
                rng.uniform(lon0, lon1, batch),
                rng.uniform(lat0, lat1, batch),
            ],
            axis=-1,
        )
        inside = cand[points_in_polygon(cand, polygon)]
        out.append(inside[:need])
        need -= len(inside[:need])
        attempts += 1
    if not out:
        return np.zeros((0, 2))
    return np.concatenate(out, axis=0)[:n]
