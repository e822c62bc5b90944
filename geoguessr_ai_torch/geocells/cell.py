"""Cell: the unit of semantic geocell generation (counterpart of
geoguessr_ai_tpu/geocells/cell.py).

A cell owns training points, admin polygons, a neighbour list and its
OPTICS clusters.  The attribute names are the JAX ``Cell``'s (id, points,
curr_coords, polygons, country, admin_1, neighbours, point_centroid,
geom_centroid, clusters, current_shape), so both packages' managers read
either package's pickles; the device a cell is clustered on is an argument
and never pickled.

Clustering runs the port's own OPTICS (``geocells.optics``, where the JAX
package calls scikit-learn's): ``cluster_cells`` and ``split_cells`` batch
many cells into one ``optics_many`` call, each cell's result the one its
own call gives; ``Cell.cluster`` and ``Cell.split_cell`` are those on one
cell.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geoguessr_ai_torch.config import resolve_device
from geoguessr_ai_torch.geo.polygon import points_in_polygon, polygon_area
from geoguessr_ai_torch.geocells.optics import optics_many


def _point_latlng(point) -> Tuple[float, float]:
    try:
        return float(point["latitude"]), float(point["longitude"])
    except (TypeError, KeyError, IndexError):
        lat, lng = point
        return float(lat), float(lng)


class Cell:
    """A geocell: points + polygons + neighbours + clusters."""

    def __init__(
        self,
        name: str,
        country: str,
        admin_1: str,
        points: Optional[List] = None,
        polygons: Optional[List[np.ndarray]] = None,
    ):
        self.id = f"{name}{uuid.uuid1()}"
        self.country = country
        self.admin_1 = admin_1
        self.points = list(points or [])
        self.polygons = list(polygons or [])
        self.neighbours: List["Cell"] = []
        self.clusters: Dict[int, Dict] = {}
        self.current_shape = None
        self._refresh()

    # ------------------------------------------------------------------

    def _refresh(self) -> None:
        self.curr_coords = [
            _point_latlng(p) for p in self.points
        ]  # (lat, lng) tuples
        if self.curr_coords:
            lats, lngs = zip(*self.curr_coords)
            self.point_centroid = [float(np.mean(lngs)), float(np.mean(lats))]
        else:
            self.point_centroid = [None, None]
        self.geom_centroid = self._geometry_centroid()

    def _geometry_centroid(self) -> List:
        if not self.polygons:
            return list(self.point_centroid)
        # area-weighted mean of polygon vertex centroids
        tot, cx, cy = 0.0, 0.0, 0.0
        for poly in self.polygons:
            poly = np.asarray(poly, np.float64)
            a = max(polygon_area(poly), 1e-12)
            tot += a
            cx += a * float(poly[:, 0].mean())
            cy += a * float(poly[:, 1].mean())
        return [cx / tot, cy / tot]

    def __len__(self) -> int:
        return len(self.points)

    def __repr__(self) -> str:
        return (
            f"Cell({self.id[:18]}…, {self.country}/{self.admin_1}, "
            f"{len(self)} pts, {len(self.clusters)} clusters)"
        )

    # ------------------------------------------------------------------

    def contains(self, lng: float, lat: float) -> bool:
        pt = np.array([[lng, lat]])
        return any(
            points_in_polygon(pt, poly)[0] for poly in self.polygons
        )

    def add_points(self, points: Sequence) -> None:
        self.points.extend(points)
        self._refresh()

    def combine(self, other: "Cell") -> None:
        """Absorb another cell: merge points and polygons, rewire the
        neighbours."""
        self.points.extend(other.points)
        self.polygons.extend(other.polygons)
        for n in other.neighbours:
            if n is not self and n not in self.neighbours:
                self.neighbours.append(n)
            if other in getattr(n, "neighbours", []):
                n.neighbours.remove(other)
                if self not in n.neighbours and n is not self:
                    n.neighbours.append(self)
        if other in self.neighbours:
            self.neighbours.remove(other)
        other.points = []
        other.polygons = []
        other.neighbours = []
        self._refresh()

    # ------------------------------------------------------------------

    def cluster(
        self, xi: float = 0.05, min_samples: int = 5,
        min_cluster_size: float = 0.05, device=None,
    ) -> None:
        """OPTICS-cluster the member points into self.clusters on
        ``device`` (None: the GPU); ``cluster_cells`` of this cell."""
        cluster_cells([self], xi, min_samples, min_cluster_size, device)

    def split_cell(
        self, min_split_points: int = 10, fine_xi: float = 0.00005,
        device=None,
    ) -> List["Cell"]:
        """Spawn child cells from clusters of more than min_split_points
        points, re-clustered at ``fine_xi``; the parent keeps the rest and
        is re-clustered.  ``split_cells`` of this cell."""
        return split_cells([self], min_split_points, fine_xi, device)[0]

    def clean_cell_before_saving(self) -> None:
        """Drop geometry for pickling."""
        self.current_shape = np.array([None], dtype=object)
        self.neighbours = []


def _clusters(points, coords: np.ndarray, labels: np.ndarray) -> Dict:
    """The clusters dict of one cell from its OPTICS labels: noise joins
    the nearest cluster centroid (everything is cluster 0 when there is no
    cluster); each cluster keeps its points, its (lng, lat) centroid and
    the hashes of its points' (lat, lng)."""
    if (labels >= 0).any():
        cluster_ids = np.unique(labels[labels >= 0])
        cents = np.stack(
            [coords[labels == c].mean(axis=0) for c in cluster_ids]
        )
        for i in np.where(labels < 0)[0]:
            d = np.linalg.norm(cents - coords[i], axis=1)
            labels[i] = cluster_ids[int(np.argmin(d))]
    else:
        labels = np.zeros(len(coords), np.int64)
    clusters = {}
    for cid in np.unique(labels):
        idx = np.where(labels == cid)[0]
        pts = [points[i] for i in idx]
        clusters[int(cid)] = {
            "points": pts,
            "centroid": coords[idx].mean(axis=0)[::-1].tolist(),  # lng,lat
            "hashes": {hash(_point_latlng(p)) for p in pts},
        }
    return clusters


def cluster_cells(
    cells: Sequence, xi: float = 0.05, min_samples: int = 5,
    min_cluster_size: float = 0.05, device=None,
) -> None:
    """``Cell.cluster`` of every cell, with one ``optics_many`` call on
    ``device`` (None: the GPU) over the cells of more than min_samples
    points.  Reads each cell's ``points`` and ``curr_coords`` and sets its
    ``clusters``."""
    dev = resolve_device(device)
    coords = [np.array(c.curr_coords, np.float64) for c in cells]
    todo = [i for i, xy in enumerate(coords) if len(xy) > min_samples]
    found = optics_many([coords[i] for i in todo], min_samples, xi,
                        min_cluster_size, dev)
    labels = {i: r.labels for i, r in zip(todo, found)}
    for i, cell in enumerate(cells):
        if len(coords[i]) == 0:
            cell.clusters = {}
            continue
        cell.clusters = _clusters(
            cell.points, coords[i],
            labels.get(i, np.zeros(len(coords[i]), np.int64)))


def split_cells(
    cells: Sequence[Cell], min_split_points: int = 10,
    fine_xi: float = 0.00005, device=None,
) -> List[List[Cell]]:
    """``Cell.split_cell`` of every cell, in order: the children of every
    cell from its clusters, then all children re-clustered at ``fine_xi``
    in one call, then every parent that spawned children re-clustered in
    one call.  Returns each cell's children."""
    dev = resolve_device(device)
    cluster_cells([c for c in cells if not c.clusters], device=dev)
    all_children, parents = [], []
    for cell in cells:
        children: List[Cell] = []
        keep_points: List = []
        for cid, cdata in sorted(cell.clusters.items()):
            if len(cdata["points"]) > min_split_points and len(
                cell.clusters
            ) > 1:
                child = Cell(
                    f"{cell.country}_{cell.admin_1}_split",
                    cell.country,
                    cell.admin_1,
                    points=cdata["points"],
                )
                child.neighbours = [cell]
                children.append(child)
            else:
                keep_points.extend(cdata["points"])
        if children:
            # the parent keeps its remainder; if nothing remains it
            # absorbs the first child back so no empty cell survives
            cell.points = keep_points
            if not cell.points:
                first = children.pop(0)
                cell.points = first.points
            cell.neighbours.extend(children)
            cell._refresh()
            parents.append(cell)
        all_children.append(children)
    cluster_cells([ch for chs in all_children for ch in chs], xi=fine_xi,
                  device=dev)
    cluster_cells(parents, device=dev)
    return all_children
