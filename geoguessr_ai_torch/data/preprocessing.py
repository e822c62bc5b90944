"""Dataset preprocessing: cell labeling, heading encoding, aux labels
(counterpart of geoguessr_ai_tpu/data/preprocessing.py).

The labeling and encoding functions are numpy, as in the JAX package.
``attach_aux_labels`` and ``attach_embeddings`` take rows (mappings with
``lat``, ``lon`` and ``location_id``) where the JAX package takes a
DataFrame, and return new row dicts with the column added, in order: the
port has no pandas.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from geoguessr_ai_torch.geo.polygon import points_in_polygon


def label_points_by_cells(
    lnglat: np.ndarray,
    cell_polygons: Sequence[Sequence[np.ndarray]],
    cell_centroids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Each point's index of the first cell whose rings contain it; a
    point in no polygon takes the nearest centroid (by planar distance in
    degrees; the centroids are the mean vertex of each cell's rings when
    omitted).  (N, 2) points, per-cell ring lists -> (N,) int64."""
    n = len(lnglat)
    labels = np.full(n, -1, np.int64)
    # a bbox prefilter per cell before the ray casting
    boxes = []
    for rings in cell_polygons:
        pts = np.concatenate([np.asarray(r) for r in rings], axis=0)
        boxes.append(
            (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
        )
    for ci, rings in enumerate(cell_polygons):
        todo = np.where(labels < 0)[0]
        if len(todo) == 0:
            break
        b = boxes[ci]
        cand = todo[
            (lnglat[todo, 0] >= b[0])
            & (lnglat[todo, 0] <= b[2])
            & (lnglat[todo, 1] >= b[1])
            & (lnglat[todo, 1] <= b[3])
        ]
        for ring in rings:
            if len(cand) == 0:
                break
            inside = points_in_polygon(lnglat[cand], ring)
            labels[cand[inside]] = ci
            cand = cand[~inside]
    missing = np.where(labels < 0)[0]
    if len(missing):
        if cell_centroids is None:
            cell_centroids = np.stack(
                [
                    np.concatenate([np.asarray(r) for r in rings]).mean(0)
                    for rings in cell_polygons
                ]
            )
        for i in missing:
            d = np.linalg.norm(cell_centroids - lnglat[i], axis=1)
            labels[i] = int(np.argmin(d))
    return labels


def label_points_by_bbox(lnglat: np.ndarray, bboxes: np.ndarray) -> np.ndarray:
    """(N, 2) points, (C, 4) boxes (lon_min, lat_min, lon_max, lat_max) ->
    (N,) int64: the first box holding each point, -1 if none."""
    x = lnglat[:, 0][:, None]
    y = lnglat[:, 1][:, None]
    inside = (
        (x >= bboxes[None, :, 0])
        & (x <= bboxes[None, :, 2])
        & (y >= bboxes[None, :, 1])
        & (y <= bboxes[None, :, 3])
    )  # (N, C)
    any_hit = inside.any(axis=1)
    labels = np.where(any_hit, inside.argmax(axis=1), -1)
    return labels.astype(np.int64)


def encode_headings(headings_deg: np.ndarray) -> np.ndarray:
    """(..., V) heading angles in degrees -> (..., V, 2) float32 [sin,
    cos]."""
    rad = np.deg2rad(np.asarray(headings_deg, np.float64))
    return np.stack([np.sin(rad), np.cos(rad)], axis=-1).astype(np.float32)


def attach_aux_labels(
    rows: Iterable[Mapping],
    samplers: Mapping[str, Callable[[np.ndarray], np.ndarray]],
) -> List[Dict]:
    """Rows with one auxiliary label per sampler: ``samplers`` maps a column
    name to fn((N, 2) float64 (lon, lat)) -> (N,) values (an elevation or
    population raster, ``train.captions``' Köppen sampler, the month)."""
    rows = [dict(r) for r in rows]
    lnglat = np.array([(r["lon"], r["lat"]) for r in rows],
                      np.float64).reshape(-1, 2)
    for name, fn in samplers.items():
        for r, v in zip(rows, fn(lnglat)):
            r[name] = v
    return rows


def attach_embeddings(
    rows: Iterable[Mapping],
    embeddings_by_location: Mapping[str, np.ndarray],
    column: str = "embedding",
) -> List[Dict]:
    """Rows with their precomputed embedding under ``column``, looked up by
    ``location_id`` (None where there is none)."""
    out = []
    for r in rows:
        r = dict(r)
        r[column] = embeddings_by_location.get(r["location_id"])
        out.append(r)
    return out
