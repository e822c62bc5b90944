"""The geocell centroid table, numpy only (copy of ``CentroidTable`` in
geoguessr_ai_tpu/geocells/manager.py)."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class CentroidTable:
    """The classifier-head contract: row i is geocell i's (lng, lat)
    centroid."""

    centroids: np.ndarray  # (num_cells, 2) float32, (lng, lat)
    country: np.ndarray  # (num_cells,) str
    admin1: np.ndarray  # (num_cells,) str
    cell_id: np.ndarray  # (num_cells,) str

    @property
    def num_cells(self) -> int:
        return int(self.centroids.shape[0])

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path,
            centroids=self.centroids,
            country=self.country,
            admin1=self.admin1,
            cell_id=self.cell_id,
        )

    @staticmethod
    def load(path: str) -> "CentroidTable":
        with np.load(path, allow_pickle=False) as z:
            return CentroidTable(
                centroids=z["centroids"].astype(np.float32),
                country=z["country"],
                admin1=z["admin1"],
                cell_id=z["cell_id"],
            )
