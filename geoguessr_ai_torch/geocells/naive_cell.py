"""Naive rectangle geocells: heap-driven recursive bbox splitting
(counterpart of geoguessr_ai_tpu/geocells/naive_cell.py, numpy only).

Repeatedly split the most populated rectangle until a target cell count: a
baseline partitioner to compare against the semantic geocells.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class NaiveCell:
    lon_min: float
    lat_min: float
    lon_max: float
    lat_max: float
    points: np.ndarray  # (N, 2) lnglat

    def __len__(self) -> int:
        return len(self.points)

    @property
    def centroid(self) -> Tuple[float, float]:
        if len(self.points):
            return tuple(self.points.mean(axis=0))
        return (
            (self.lon_min + self.lon_max) / 2,
            (self.lat_min + self.lat_max) / 2,
        )

    def split(self) -> Tuple["NaiveCell", "NaiveCell"]:
        """Split along the longer axis at the median point."""
        if (self.lon_max - self.lon_min) >= (self.lat_max - self.lat_min):
            axis, lo, hi = 0, self.lon_min, self.lon_max
        else:
            axis, lo, hi = 1, self.lat_min, self.lat_max
        mid = (
            float(np.median(self.points[:, axis]))
            if len(self.points)
            else (lo + hi) / 2
        )
        mid = min(max(mid, lo), hi)
        left_mask = self.points[:, axis] <= mid
        if axis == 0:
            a = NaiveCell(self.lon_min, self.lat_min, mid, self.lat_max,
                          self.points[left_mask])
            b = NaiveCell(mid, self.lat_min, self.lon_max, self.lat_max,
                          self.points[~left_mask])
        else:
            a = NaiveCell(self.lon_min, self.lat_min, self.lon_max, mid,
                          self.points[left_mask])
            b = NaiveCell(self.lon_min, mid, self.lon_max, self.lat_max,
                          self.points[~left_mask])
        return a, b


def partition(
    points_lnglat: np.ndarray, num_cells: int
) -> List[NaiveCell]:
    """Heap-driven partition: always split the fullest cell."""
    pts = np.asarray(points_lnglat, np.float64)
    root = NaiveCell(
        float(pts[:, 0].min()),
        float(pts[:, 1].min()),
        float(pts[:, 0].max()),
        float(pts[:, 1].max()),
        pts,
    )
    counter = itertools.count()
    heap = [(-len(root), next(counter), root)]
    while len(heap) < num_cells:
        neg, _, cell = heapq.heappop(heap)
        if -neg <= 1:
            heapq.heappush(heap, (neg, next(counter), cell))
            break
        a, b = cell.split()
        if len(a) == 0 or len(b) == 0:  # degenerate split: stop this branch
            heapq.heappush(heap, (0, next(counter), cell))
            continue
        heapq.heappush(heap, (-len(a), next(counter), a))
        heapq.heappush(heap, (-len(b), next(counter), b))
    return [c for _, _, c in heap]
