"""Geocell manager and centroid table (counterpart of
geoguessr_ai_tpu/geocells/manager.py), numpy and the standard library only.

``GeocellManager`` loads the per-country geocell pickles, assigns every
cell its ``geocell_index`` (country files sorted, then each file's inner
dict in insertion order, then list order: the contract between the
centroid table and the classifier head), and answers point -> (country,
admin1, geocell, cluster) lookups; a point joins its cluster through
``hash((lat, lng))``, the hashes ``Cell.cluster`` stored.

Pickles written by the JAX package's ``GenerateGeocells`` name its
``Cell`` class (``geoguessr_ai_tpu.geocells.cell.Cell``), and older ones a
module ``cell``.  The port never imports either: the unpickler maps every
class of the JAX package, and any class it cannot import, to
``_CellRecord``, which keeps the pickled attributes.

``generate_proto_df`` returns its rows as a list of dicts and writes the
CSV with the ``csv`` module, where the JAX package builds a DataFrame;
``CentroidTable.from_proto_df`` takes such rows.
"""

from __future__ import annotations

import csv
import os
import pickle
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np

#: The JAX package, whose classes the unpickler never imports.
_JAX_PACKAGE = "geoguessr_ai_tpu"

#: Columns of a proto row, in the JAX DataFrame's order.
PROTO_COLUMNS = ("geocell_index", "country", "admin1", "cell_id",
                 "cluster_id", "count", "indices", "centroid_lat",
                 "centroid_lng")


class _CellRecord:
    """Stand-in for any pickled cell class: keeps the pickled attributes."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)

    def __len__(self):
        pts = getattr(self, "points", None)
        try:
            return len(pts) if pts is not None else 0
        except TypeError:
            return 0


class _TolerantUnpickler(pickle.Unpickler):
    """Maps every class of the JAX package, and any class that cannot be
    imported (the reference's module ``cell``), to ``_CellRecord``."""

    def find_class(self, module, name):
        if module.split(".")[0] == _JAX_PACKAGE:
            return _CellRecord
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _CellRecord


def _point_lat_lng(point) -> Tuple[float, float]:
    """(lat, lng) of a point given as a mapping with ``latitude`` and
    ``longitude``, or as a (lat, lng) pair."""
    try:
        return float(point["latitude"]), float(point["longitude"])
    except (TypeError, KeyError, IndexError):
        lat, lng = point
        return float(lat), float(lng)


@dataclass
class PointInfo:
    country: str
    admin1: str
    geocell: str
    cluster_id: int
    lat: float
    lng: float
    geocell_index: int


class GeocellManager:
    """Loads the ``geocells_<Country>.pickle`` files of ``geocell_dir`` and
    serves point -> cell lookups."""

    def __init__(self, geocell_dir: str):
        self.geocell_dir = geocell_dir
        self.geocells = self._load_geocells(geocell_dir)
        self._index_cells()
        self.point_info = self._build_point_index()

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @staticmethod
    def _load_pickle(path: str):
        with open(path, "rb") as f:
            return _TolerantUnpickler(f).load()

    def _load_geocells(self, geocell_dir: str) -> Dict[str, Dict[str, list]]:
        cells: Dict[str, Dict[str, list]] = {}
        files = sorted(
            f for f in os.listdir(geocell_dir) if f.endswith(".pickle")
        )
        for fname in files:
            country = fname.split("_", 1)[-1].rsplit(".", 1)[0]
            data = self._load_pickle(os.path.join(geocell_dir, fname))
            # pickles hold {inner_key: [cells]}; a bare list is one group
            if not isinstance(data, dict):
                data = {country: list(data)}
            cells[country] = data
        return cells

    def _index_cells(self) -> None:
        """The canonical geocell_index of every cell: sorted country file,
        inner dict insertion order, cell list order."""
        self._flat_cells: List[Tuple[str, str, object]] = []
        for country, inner in self.geocells.items():
            for group_key, cell_list in inner.items():
                for cell in cell_list:
                    self._flat_cells.append((country, group_key, cell))

    def _build_point_index(self) -> Dict[Tuple[float, float], PointInfo]:
        info: Dict[Tuple[float, float], PointInfo] = {}
        for idx, (country, group_key, cell) in enumerate(self._flat_cells):
            clusters = getattr(cell, "clusters", {}) or {}
            hash_to_cluster: Dict[int, int] = {}
            for cluster_id, cdata in clusters.items():
                for h in cdata.get("hashes", []):
                    hash_to_cluster[h] = cluster_id
            for point in getattr(cell, "points", []) or []:
                lat, lng = _point_lat_lng(point)
                cluster_id = hash_to_cluster.get(hash((lat, lng)), -1)
                info[(lat, lng)] = PointInfo(
                    country=country,
                    admin1=getattr(cell, "admin_1", group_key),
                    geocell=getattr(cell, "id", str(idx)),
                    cluster_id=cluster_id,
                    lat=lat,
                    lng=lng,
                    geocell_index=idx,
                )
        return info

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    @property
    def num_cells(self) -> int:
        return len(self._flat_cells)

    def get_num_geocells(self) -> int:
        return self.num_cells

    def iter_cells(self) -> Iterator[Tuple[int, str, str, object]]:
        for idx, (country, group_key, cell) in enumerate(self._flat_cells):
            yield idx, country, group_key, cell

    def get_geocell_id(self, point) -> Tuple[
        Optional[str], Optional[str], Optional[str]
    ]:
        """(geocell_id, country, admin1) of a training point, or (None,
        None, None) when no cell holds it."""
        rec = self.point_info.get(_point_lat_lng(point))
        if rec is None:
            return None, None, None
        return rec.geocell, rec.country, rec.admin1

    def get_geocell_index(self, point) -> Optional[int]:
        rec = self.point_info.get(_point_lat_lng(point))
        return None if rec is None else rec.geocell_index

    def get_geocell_info(self, geocell_id: str, country: str, group_key: str):
        for cell in self.geocells.get(country, {}).get(group_key, []):
            if getattr(cell, "id", None) == geocell_id:
                return cell
        return None

    # ------------------------------------------------------------------
    # Artifacts
    # ------------------------------------------------------------------

    @staticmethod
    def _cell_centroid(cell) -> Tuple[float, float]:
        """(lng, lat) of a cell: its geometry centroid, else its point
        centroid, else the mean of its points ((0, 0) for none)."""
        cen = getattr(cell, "geom_centroid", None)
        if cen is not None and len(cen) == 2 and cen[0] is not None:
            return float(cen[0]), float(cen[1])
        cen = getattr(cell, "point_centroid", None)
        if cen is not None and len(cen) == 2 and cen[0] is not None:
            return float(cen[0]), float(cen[1])
        pts = getattr(cell, "points", []) or []
        if not pts:
            return 0.0, 0.0
        lats, lngs = zip(*[_point_lat_lng(p) for p in pts])
        return float(np.mean(lngs)), float(np.mean(lats))

    def generate_proto_df(self, out_csv: Optional[str] = None) -> List[Dict]:
        """One row per (cell, cluster) with the canonical geocell_index
        (``PROTO_COLUMNS``; a cell without clusters is one row of cluster
        -1 over all its points); written to ``out_csv`` with a header and
        no index column when given."""
        rows = []
        for idx, country, group_key, cell in self.iter_cells():
            lng, lat = self._cell_centroid(cell)
            clusters = getattr(cell, "clusters", {}) or {}
            if not clusters:
                clusters = {-1: {"points": getattr(cell, "points", []) or []}}
            for cluster_id, cdata in clusters.items():
                pts = cdata.get("points", [])
                indices = []
                for p in pts:
                    name = getattr(p, "name", None)
                    if name is not None:
                        indices.append(int(name))
                rows.append(
                    {
                        "geocell_index": idx,
                        "country": country,
                        "admin1": getattr(cell, "admin_1", group_key),
                        "cell_id": getattr(cell, "id", str(idx)),
                        "cluster_id": cluster_id,
                        "count": len(pts),
                        "indices": indices,
                        "centroid_lat": lat,
                        "centroid_lng": lng,
                    }
                )
        if out_csv is not None:
            with open(out_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(PROTO_COLUMNS)
                w.writerows([r[c] for c in PROTO_COLUMNS] for r in rows)
        return rows

    def build_centroid_table(self) -> "CentroidTable":
        """The (num_cells, 2) float32 (lng, lat) centroid table in
        geocell_index order, with each cell's country, admin1 and id."""
        centroids = np.zeros((self.num_cells, 2), dtype=np.float32)
        countries: List[str] = []
        admin1s: List[str] = []
        cell_ids: List[str] = []
        for idx, country, group_key, cell in self.iter_cells():
            lng, lat = self._cell_centroid(cell)
            centroids[idx] = (lng, lat)
            countries.append(country)
            admin1s.append(str(getattr(cell, "admin_1", group_key)))
            cell_ids.append(str(getattr(cell, "id", idx)))
        return CentroidTable(
            centroids=centroids,
            country=np.array(countries),
            admin1=np.array(admin1s),
            cell_id=np.array(cell_ids),
        )


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

    @staticmethod
    def from_proto_df(rows: Iterable[Mapping]) -> "CentroidTable":
        """From proto rows (one per cluster): the first row of each
        geocell_index, in index order.  Rows of one index carry one cell's
        values, so which of them comes first does not matter."""
        first: Dict[int, Mapping] = {}
        for r in rows:
            first.setdefault(int(r["geocell_index"]), r)
        dedup = [first[i] for i in sorted(first)]
        return CentroidTable(
            centroids=np.array(
                [(float(r["centroid_lng"]), float(r["centroid_lat"]))
                 for r in dedup], np.float32).reshape(-1, 2),
            country=np.array([str(r["country"]) for r in dedup], dtype=str),
            admin1=np.array([str(r["admin1"]) for r in dedup], dtype=str),
            cell_id=np.array([str(r["cell_id"]) for r in dedup], dtype=str),
        )
