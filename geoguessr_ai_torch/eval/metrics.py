"""Benchmark scoring on the host (counterpart of
geoguessr_ai_tpu/eval/metrics.py).

The benchmark's haversine uses the mean Earth radius (6371000 m), the
model's the WGS84 semi-major axis (6378137 m, ``geo.core``): both come from
the config.
"""

from __future__ import annotations

import numpy as np

from geoguessr_ai_torch.config import (
    EARTH_RADIUS_BENCH_M,
    GEOGUESSR_DECAY_CONSTANT_KM,
)


def haversine_km_np(lat1, lon1, lat2, lon2,
                    radius_m: float = EARTH_RADIUS_BENCH_M) -> np.ndarray:
    """Scalar or array haversine in km (benchmark semantics)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2)
    return radius_m / 1000.0 * 2 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def geoguessr_score_np(distance_km,
                       decay_km: float = GEOGUESSR_DECAY_CONSTANT_KM):
    """round(clamp(5000 * exp(-d / decay), 0, 5000))."""
    return np.round(np.clip(
        5000.0 * np.exp(-np.asarray(distance_km) / decay_km), 0, 5000))


def summarize_results(records) -> dict:
    """The summary record of the benchmark's output JSON."""
    d = np.array([r["distance_km"] for r in records], dtype=np.float64)
    scores = np.array([r["score"] for r in records], dtype=np.float64)
    top1 = np.array([r["top1_prob"] for r in records], dtype=np.float64)
    return {
        "summary": True,
        "num_samples": len(records),
        "avg_distance_km": float(d.mean()) if len(d) else float("nan"),
        "median_distance_km": float(np.median(d)) if len(d) else float("nan"),
        "avg_score": float(scores.mean()) if len(scores) else float("nan"),
        "avg_top1_prob": float(top1.mean()) if len(top1) else float("nan"),
    }
