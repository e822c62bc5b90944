"""Finite Voronoi regions in 2D (counterpart of
geoguessr_ai_tpu/geocells/voronoi.py, numpy only; it takes scipy's
``Voronoi`` output).

Reconstructs scipy's infinite Voronoi regions into finite polygons, for
drawing cluster areas.  The algorithm is the standard public
finite-Voronoi reconstruction: Pauli Virtanen's gist, via
https://nbviewer.org/gist/pv/8037100 ("Colorized Voronoi diagram with
Scipy, in less than 50 lines of code").
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def voronoi_finite_polygons_2d(
    vor, radius: float = None
) -> Tuple[List[List[int]], np.ndarray]:
    """Clip infinite Voronoi regions to finite ones.

    Args:
      vor: scipy.spatial.Voronoi output (2D).
      radius: distance to extend infinite ridges (default: 2x the point
        cloud's span).

    Returns:
      (regions, vertices): region index lists + vertex array.
    """
    if vor.points.shape[1] != 2:
        raise ValueError("2D input required")
    new_regions: List[List[int]] = []
    new_vertices = vor.vertices.tolist()

    center = vor.points.mean(axis=0)
    if radius is None:
        radius = float(np.ptp(vor.points, axis=0).max()) * 2.0

    # Map point index -> ridges
    all_ridges: dict = {}
    for (p1, p2), (v1, v2) in zip(vor.ridge_points, vor.ridge_vertices):
        all_ridges.setdefault(p1, []).append((p2, v1, v2))
        all_ridges.setdefault(p2, []).append((p1, v1, v2))

    for p1, region_idx in enumerate(vor.point_region):
        vertices = vor.regions[region_idx]
        if all(v >= 0 for v in vertices):
            new_regions.append(list(vertices))
            continue
        ridges = all_ridges.get(p1, [])
        region = [v for v in vertices if v >= 0]
        for p2, v1, v2 in ridges:
            if v2 < 0:
                v1, v2 = v2, v1
            if v1 >= 0:
                continue
            # infinite ridge: extend from the finite endpoint
            t = vor.points[p2] - vor.points[p1]
            t = t / np.linalg.norm(t)
            n = np.array([-t[1], t[0]])
            midpoint = vor.points[[p1, p2]].mean(axis=0)
            direction = np.sign(np.dot(midpoint - center, n)) * n
            far_point = vor.vertices[v2] + direction * radius
            region.append(len(new_vertices))
            new_vertices.append(far_point.tolist())
        # sort region counterclockwise
        vs = np.asarray([new_vertices[v] for v in region])
        c = vs.mean(axis=0)
        angles = np.arctan2(vs[:, 1] - c[1], vs[:, 0] - c[0])
        region = [region[i] for i in np.argsort(angles)]
        new_regions.append(region)
    return new_regions, np.asarray(new_vertices)
