"""Semantic geocell generation: the combine / cluster / split algorithm
(counterpart of geoguessr_ai_tpu/geocells/generate.py).

Input is admin boundary tables (country -> admin1 -> list of polygon rings)
plus the training points; output is per-country pickles in the
finished_geocells format that ``GeocellManager`` reads.

Pipeline:
  1. build the admin-level Cell hierarchy + neighbour graph,
  2. assign points hierarchically (containment, nearest-cell fallback),
  3. COMBINE cells under ``min_points`` into a neighbour,
  4. OPTICS-cluster each cell's points,
  5. SPLIT cells over ``max_points`` into cluster-derived child cells,
  6. save per-country pickles.

Steps 4 and 5 run the port's OPTICS on ``device`` (None: the GPU): step 4
clusters every cell of every country in one batched call, and step 5 takes
all the children in one call and all the split parents in another
(``cell.cluster_cells`` / ``cell.split_cells``), with the cells, clusters
and neighbour lists the JAX package's cell-by-cell loop gives.

Admin boundaries come from any source; ``load_admin_tables_from_gadm``
reads a GADM GeoPackage where geopandas exists (ImportError otherwise),
and a plain dict of polygons works everywhere.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from geoguessr_ai_torch.config import (
    GENERATOR_MAX_POINTS,
    GENERATOR_MIN_POINTS,
    resolve_device,
)
from geoguessr_ai_torch.geo.polygon import points_in_polygon, polygon_bbox
from geoguessr_ai_torch.geocells.cell import (
    Cell,
    _point_latlng,
    cluster_cells,
    split_cells,
)
from geoguessr_ai_torch.utils.logging import logger

#: Admin tables type: country -> admin1 -> list of (M, 2) lon/lat rings.
AdminTables = Dict[str, Dict[str, List[np.ndarray]]]


def _bboxes_touch(b1, b2, tol: float = 1e-9) -> bool:
    return not (
        b1[2] < b2[0] - tol
        or b2[2] < b1[0] - tol
        or b1[3] < b2[1] - tol
        or b2[3] < b1[1] - tol
    )


class GenerateGeocells:
    """Builds geocells for one or more countries."""

    def __init__(
        self,
        admin_tables: AdminTables,
        points_by_country: Dict[str, Sequence],
        min_points: int = GENERATOR_MIN_POINTS,
        max_points: int = GENERATOR_MAX_POINTS,
        device=None,
    ):
        """
        Args:
          admin_tables: country -> admin1 -> polygon rings (lon, lat).
          points_by_country: country -> list of points (each a mapping
            with latitude/longitude, or a (lat, lng) tuple).
          device: where OPTICS runs (None: the GPU; raises without one).
        """
        self.admin_tables = admin_tables
        self.points_by_country = points_by_country
        self.min_points = min_points
        self.max_points = max_points
        self.device = resolve_device(device)
        self.cells: Dict[str, List[Cell]] = {}

    # -- step 1: init cells + neighbours --------------------------------

    def init_cells(self) -> None:
        for country, admins in self.admin_tables.items():
            cells = []
            for admin1, rings in admins.items():
                cells.append(
                    Cell(admin1, country, admin1, polygons=list(rings))
                )
            # neighbour graph by bbox adjacency: an over-approximation of
            # shape intersection (extra neighbours only widen the combine)
            boxes = [
                [polygon_bbox(p) for p in c.polygons] for c in cells
            ]
            for i, ci in enumerate(cells):
                for j in range(i + 1, len(cells)):
                    if any(
                        _bboxes_touch(bi, bj)
                        for bi in boxes[i]
                        for bj in boxes[j]
                    ):
                        ci.neighbours.append(cells[j])
                        cells[j].neighbours.append(ci)
            self.cells[country] = cells

    # -- step 2: assign points ------------------------------------------

    def add_points_to_cells(self) -> None:
        for country, points in self.points_by_country.items():
            cells = self.cells.get(country, [])
            if not cells:
                continue
            latlng = np.array([_point_latlng(p) for p in points])
            if len(latlng) == 0:
                continue
            lnglat = latlng[:, ::-1]
            assigned = np.full(len(points), -1, np.int64)
            for ci, cell in enumerate(cells):
                todo = np.where(assigned < 0)[0]
                if len(todo) == 0:
                    break
                for poly in cell.polygons:
                    inside = points_in_polygon(lnglat[todo], poly)
                    assigned[todo[inside]] = ci
                    todo = todo[~inside]
                    if len(todo) == 0:
                        break
            # nearest-centroid fallback for unassigned points
            centroids = np.array(
                [
                    c.geom_centroid
                    if c.geom_centroid[0] is not None
                    else [0.0, 0.0]
                    for c in cells
                ]
            )
            for i in np.where(assigned < 0)[0]:
                d = np.linalg.norm(centroids - lnglat[i], axis=1)
                assigned[i] = int(np.argmin(d))
            for ci, cell in enumerate(cells):
                cell.add_points(
                    [points[i] for i in np.where(assigned == ci)[0]]
                )

    # -- step 3/4/5: combine, cluster, split ----------------------------

    def combine_small_cells(self) -> None:
        """Merge cells below min_points into a neighbour, until none is
        left."""
        for country, cells in self.cells.items():
            changed = True
            while changed:
                changed = False
                for cell in cells:
                    if 0 < len(cell) < self.min_points:
                        target = None
                        # prefer the smallest non-empty neighbour
                        candidates = [
                            n
                            for n in cell.neighbours
                            if n in cells and n is not cell
                        ]
                        if candidates:
                            target = min(candidates, key=len)
                        if target is None:
                            others = [
                                c for c in cells if c is not cell and len(c)
                            ]
                            if not others:
                                continue
                            target = min(others, key=len)
                        target.combine(cell)
                        changed = True
                cells[:] = [c for c in cells if len(c) > 0]

    def cluster_cells(self) -> None:
        """Every cell of every country in one batched OPTICS call."""
        cluster_cells([c for cells in self.cells.values() for c in cells],
                      device=self.device)

    def split_large_cells(self) -> None:
        """Split cells above max_points, each followed by its children."""
        big = [c for cells in self.cells.values() for c in cells
               if len(c) > self.max_points]
        children = dict(zip(map(id, big),
                            split_cells(big, device=self.device)))
        for country, cells in self.cells.items():
            out = []
            for cell in cells:
                out.append(cell)
                out.extend(children.get(id(cell), []))
            self.cells[country] = out

    # -- step 6: save ---------------------------------------------------

    def save(self, out_dir: str) -> List[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for country, cells in self.cells.items():
            for c in cells:
                c.clean_cell_before_saving()
            path = os.path.join(out_dir, f"geocells_{country}.pickle")
            with open(path, "wb") as f:
                pickle.dump({country: cells}, f)
            paths.append(path)
        return paths

    # -- full pipeline --------------------------------------------------

    def generate_geocells(self, out_dir: Optional[str] = None):
        self.init_cells()
        self.add_points_to_cells()
        self.combine_small_cells()
        self.cluster_cells()
        self.split_large_cells()
        total = sum(len(v) for v in self.cells.values())
        logger.info(
            f"generated {total} geocells across {len(self.cells)} countries"
        )
        if out_dir:
            self.save(out_dir)
        return self.cells


def load_admin_tables_from_gadm(
    gpkg_path: str, countries: Optional[Sequence[str]] = None
) -> AdminTables:
    """Read GADM ADM_1 boundaries from a GeoPackage (needs geopandas,
    which neither this package nor the card's machine ships: ImportError
    without it)."""
    import geopandas as gpd

    gdf = gpd.read_file(gpkg_path, layer="ADM_1")
    if countries:
        gdf = gdf[gdf["COUNTRY"].isin(countries)]
    tables: AdminTables = {}
    for _, row in gdf.iterrows():
        rings = []
        geom = row.geometry
        geoms = getattr(geom, "geoms", [geom])
        for g in geoms:
            rings.append(np.asarray(g.exterior.coords))
        tables.setdefault(row["COUNTRY"], {})[row["NAME_1"]] = rings
    return tables
