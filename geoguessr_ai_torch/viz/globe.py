"""Self-contained deck.gl globe HTML generation (counterpart of
geoguessr_ai_tpu/viz/globe.py; json, os, csv and numpy only).

Layers are serialised to JSON and embedded in a single HTML file that
loads deck.gl from a CDN; the file is viewed in a browser.  The same
inputs give the JAX module's HTML text; ``visualize_finished_geocells``
reads the proto CSV with the ``csv`` module, where the JAX module uses
pandas.
"""

from __future__ import annotations

import colorsys
import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8"/>
  <title>{title}</title>
  <script src="https://unpkg.com/deck.gl@9.0.0/dist.min.js"></script>
  <style>
    body {{ margin: 0; background: #0b0e1a; }}
    #tooltip {{ position: absolute; z-index: 2; pointer-events: none;
               background: rgba(0,0,0,.8); color: #fff; padding: 6px 8px;
               font: 12px sans-serif; border-radius: 4px; display: none; }}
  </style>
</head>
<body>
<div id="tooltip"></div>
<script>
  const layersSpec = {layers_json};
  const layerCtors = {{
    ArcLayer: deck.ArcLayer,
    ScatterplotLayer: deck.ScatterplotLayer,
    GeoJsonLayer: deck.GeoJsonLayer,
    LineLayer: deck.LineLayer,
  }};
  const layers = layersSpec.map(spec => {{
    const Ctor = layerCtors[spec.type];
    const accessors = {{}};
    for (const [k, v] of Object.entries(spec.accessors || {{}})) {{
      accessors[k] = typeof v === "string" ? d => d[v] : v;
    }}
    return new Ctor({{id: spec.id, data: spec.data, pickable: true,
                     ...spec.props, ...accessors}});
  }});
  new deck.DeckGL({{
    container: document.body,
    views: new deck._GlobeView(),
    initialViewState: {view_state},
    controller: true,
    layers,
    getTooltip: ({{object}}) => object && object.tooltip,
    parameters: {{clearColor: [0.04, 0.05, 0.1, 1]}},
  }});
</script>
</body>
</html>
"""


def _color_by_distance(distance_km: float) -> List[int]:
    """Green (close) -> red (far) ramp used by the reference's guess arcs."""
    t = min(max(distance_km / 5000.0, 0.0), 1.0)
    return [int(255 * t), int(200 * (1 - t)), 60, 200]


def write_globe_html(
    layers: List[Dict],
    out_path: str,
    title: str = "geoguessr-ai-tpu",
    view_state: Optional[Dict] = None,
) -> str:
    view_state = view_state or {
        "longitude": 10.0,
        "latitude": 30.0,
        "zoom": 0.6,
    }
    html = _HTML_TEMPLATE.format(
        title=title,
        layers_json=json.dumps(layers),
        view_state=json.dumps(view_state),
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def guesses_layers(records: Sequence[Dict]) -> List[Dict]:
    """Arc layer gt -> prediction colored by distance + endpoints
    (reference visualize_guesses.py behavior over
    inference_results.json)."""
    arcs = []
    gts = []
    preds = []
    for r in records:
        if r.get("summary"):
            continue
        d = float(r["distance_km"])
        arcs.append(
            {
                "source": [r["gt_lon"], r["gt_lat"]],
                "target": [r["pred_lon"], r["pred_lat"]],
                "color": _color_by_distance(d),
                "tooltip": f"{d:.0f} km, score {r.get('score', 0):.0f}",
            }
        )
        gts.append(
            {
                "position": [r["gt_lon"], r["gt_lat"]],
                "color": [80, 220, 120, 255],
                "tooltip": "ground truth",
            }
        )
        preds.append(
            {
                "position": [r["pred_lon"], r["pred_lat"]],
                "color": [240, 80, 80, 255],
                "tooltip": "prediction",
            }
        )
    return [
        {
            "type": "ArcLayer",
            "id": "guess-arcs",
            "data": arcs,
            "props": {"getWidth": 2, "greatCircle": True},
            "accessors": {
                "getSourcePosition": "source",
                "getTargetPosition": "target",
                "getSourceColor": "color",
                "getTargetColor": "color",
            },
        },
        {
            "type": "ScatterplotLayer",
            "id": "gt-points",
            "data": gts,
            "props": {"radiusMinPixels": 3},
            "accessors": {
                "getPosition": "position",
                "getFillColor": "color",
            },
        },
        {
            "type": "ScatterplotLayer",
            "id": "pred-points",
            "data": preds,
            "props": {"radiusMinPixels": 3},
            "accessors": {
                "getPosition": "position",
                "getFillColor": "color",
            },
        },
    ]


def visualize_guesses(
    results_json: str,
    out_path: str = "data/out/guesses_globe.html",
) -> str:
    """inference_results.json -> globe HTML (reference
    visualize_guesses.py / visualize_guesses_pydeck.py)."""
    with open(results_json) as f:
        records = json.load(f)
    return write_globe_html(
        guesses_layers(records), out_path, title="guess arcs"
    )


def visualize_geocells(
    centroid_table,
    out_path: str = "data/out/geocells_globe.html",
    max_cells: Optional[int] = None,
) -> str:
    """Centroid scatter colored by country hash (reference
    geocell_visualizer.py / visualize_finished_geocells.py)."""
    data = []
    n = centroid_table.num_cells if max_cells is None else min(
        max_cells, centroid_table.num_cells
    )
    for i in range(n):
        country = str(centroid_table.country[i])
        h = hash(country)
        data.append(
            {
                "position": [
                    float(centroid_table.centroids[i, 0]),
                    float(centroid_table.centroids[i, 1]),
                ],
                "color": [
                    64 + (h % 191),
                    64 + ((h // 191) % 191),
                    64 + ((h // 36481) % 191),
                    220,
                ],
                "tooltip": f"{country} / {centroid_table.admin1[i]}",
            }
        )
    layers = [
        {
            "type": "ScatterplotLayer",
            "id": "geocells",
            "data": data,
            "props": {"radiusMinPixels": 2},
            "accessors": {
                "getPosition": "position",
                "getFillColor": "color",
            },
        }
    ]
    return write_globe_html(layers, out_path, title="geocells")


def _category_color(key: str) -> List[int]:
    h = hash(str(key))
    return [
        64 + (h % 191),
        64 + ((h // 191) % 191),
        64 + ((h // 36481) % 191),
        230,
    ]


def visualize_cell_clusters(
    cell,
    out_path: str = "data/out/cell_clusters.html",
) -> str:
    """One cell's points colored by OPTICS cluster + cluster centroids
    (reference cell_visualizer.py / geocells_entrypoint.py mode 8).

    Accepts a geocells.cell.Cell: ``curr_coords`` are (lat, lng) tuples;
    ``clusters`` maps cluster_id -> {points, centroid [lng, lat], hashes}.
    Points not in any cluster render grey.
    """
    clusters = getattr(cell, "clusters", None) or {}
    # map point -> cluster id via the per-cluster coordinate-hash sets
    label_of = {}
    for cid, cdata in clusters.items():
        for h in cdata.get("hashes", ()):
            label_of[h] = cid
    pts = []
    cents = []
    for lat, lng in cell.curr_coords:
        lab = label_of.get(hash((lat, lng)), -1)
        color = (
            [120, 120, 120, 160]
            if lab < 0
            else _category_color(f"{cell.id}:{lab}")
        )
        pts.append(
            {
                "position": [float(lng), float(lat)],
                "color": color,
                "tooltip": f"cluster {lab}",
            }
        )
    for cid, cdata in sorted(clusters.items()):
        cents.append(
            {
                "position": [
                    float(cdata["centroid"][0]),
                    float(cdata["centroid"][1]),
                ],
                "color": [255, 255, 255, 255],
                "tooltip": f"cluster {cid} ({len(cdata['points'])} pts)",
            }
        )
    lat0, lng0 = (
        (float(cell.curr_coords[0][0]), float(cell.curr_coords[0][1]))
        if len(cell.curr_coords)
        else (30.0, 10.0)
    )
    layers = [
        {
            "type": "ScatterplotLayer",
            "id": "members",
            "data": pts,
            "props": {"radiusMinPixels": 3},
            "accessors": {"getPosition": "position", "getFillColor": "color"},
        },
        {
            "type": "ScatterplotLayer",
            "id": "centroids",
            "data": cents,
            "props": {"radiusMinPixels": 6, "stroked": True},
            "accessors": {"getPosition": "position", "getFillColor": "color"},
        },
    ]
    return write_globe_html(
        layers,
        out_path,
        title=f"cell {getattr(cell, 'id', '?')} clusters",
        view_state={"longitude": lng0, "latitude": lat0, "zoom": 5.0},
    )


def visualize_admin_regions(
    manager,
    out_path: str = "data/out/admin_regions.html",
    max_points: int = 200_000,
) -> str:
    """Training points colored by admin1 region (reference
    admin_visualizer.py / load_admin_data.py — rendered from the
    GeocellManager's point index instead of raw GADM polygons, which are
    not part of the shipped artifacts)."""
    data = []
    for i, ((lat, lng), rec) in enumerate(manager.point_info.items()):
        if i >= max_points:
            break
        key = f"{rec.country}/{rec.admin1}"
        data.append(
            {
                "position": [float(lng), float(lat)],
                "color": _category_color(key),
                "tooltip": key,
            }
        )
    layers = [
        {
            "type": "ScatterplotLayer",
            "id": "admin-points",
            "data": data,
            "props": {"radiusMinPixels": 2},
            "accessors": {"getPosition": "position", "getFillColor": "color"},
        }
    ]
    return write_globe_html(layers, out_path, title="admin regions")


def visualize_single_guess(
    gt_lat: float,
    gt_lon: float,
    pred_lat: float,
    pred_lon: float,
    distance_km: float,
    score: float,
    out_path: str = "data/out/single_guess.html",
) -> str:
    """One-guess globe (reference run_local_inference.py:94-279)."""
    rec = {
        "gt_lat": gt_lat,
        "gt_lon": gt_lon,
        "pred_lat": pred_lat,
        "pred_lon": pred_lon,
        "distance_km": distance_km,
        "score": score,
    }
    return write_globe_html(
        guesses_layers([rec]),
        out_path,
        title=f"guess: {distance_km:.0f} km, {score:.0f} pts",
        view_state={"longitude": gt_lon, "latitude": gt_lat, "zoom": 1.5},
    )


def load_sv_points(points_txt_path: str):
    """Parse 'lat, lng' (or whitespace-separated) lines; skip malformed
    (reference visualize_finished_geocells._load_sv_points:13-35)."""
    latlng = []
    with open(points_txt_path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != 2:
                parts = line.split()
            if len(parts) != 2:
                continue
            try:
                latlng.append((float(parts[0]), float(parts[1])))
            except ValueError:
                continue
    if not latlng:
        raise ValueError(f"no valid coordinates in {points_txt_path}")
    return np.asarray(latlng, float)


def parse_indices_column(value):
    """proto_df 'indices' cell -> list[int] (reference
    visualize_finished_geocells._parse_indices_column:38-55)."""
    import ast

    if isinstance(value, (list, tuple)):
        return [int(i) for i in value]
    try:
        parsed = ast.literal_eval(str(value))
        if isinstance(parsed, (list, tuple)):
            return [int(i) for i in parsed]
        return [int(parsed)]
    except Exception:
        s = str(value).strip().strip("[]")
        return [int(x) for x in s.split(",") if x.strip()] if s else []


def visualize_finished_geocells(
    proto_csv_path: str,
    sv_points_path: str,
    out_path: str = "data/out/finished_geocells_globe.html",
) -> str:
    """Detail view of the finished geocells (reference
    visualize_finished_geocells.py:437-466): every training point colored
    by its (geocell, cluster) — clusters within one geocell get distinct
    hues — plus arrows from each point to its cluster centroid.
    """
    sv_points = load_sv_points(sv_points_path)
    with open(proto_csv_path, newline="") as f:
        rows = list(csv.DictReader(f))

    # distinct hue per cluster WITHIN each geocell
    by_cell: Dict[int, set] = {}
    for row in rows:
        by_cell.setdefault(int(row["geocell_index"]), set()).add(
            int(row["cluster_id"]))
    colors = {}
    for geocell_id in sorted(by_cell):
        clusters = sorted(by_cell[geocell_id])
        n = max(1, len(clusters))
        for i, cid in enumerate(clusters):
            r, g, b = colorsys.hsv_to_rgb((i / n) % 1.0, 0.70, 0.95)
            colors[(geocell_id, cid)] = [
                int(r * 255), int(g * 255), int(b * 255), 200,
            ]

    pts, arrows = [], []
    for row in rows:
        gid, cid = int(row["geocell_index"]), int(row["cluster_id"])
        idxs = [
            i
            for i in parse_indices_column(row["indices"])
            if 0 <= i < len(sv_points)
        ]
        if not idxs:
            continue
        color = colors.get((gid, cid), [180, 180, 180, 200])
        lats = sv_points[idxs, 0]
        lngs = sv_points[idxs, 1]
        centroid = [float(np.mean(lngs)), float(np.mean(lats))]
        tooltip = (
            f"geocell {gid} cluster {cid} "
            f"({row.get('country', '')}/{row.get('admin1', '')})"
        )
        for lat, lng in zip(lats, lngs):
            pos = [float(lng), float(lat)]
            pts.append(
                {"position": pos, "color": color, "tooltip": tooltip}
            )
            arrows.append(
                {
                    "source": pos,
                    "target": centroid,
                    "color": color[:3] + [110],
                    "tooltip": tooltip,
                }
            )

    layers = [
        {
            "type": "LineLayer",
            "id": "to-centroid",
            "data": arrows,
            "props": {"widthMinPixels": 1},
            "accessors": {
                "getSourcePosition": "source",
                "getTargetPosition": "target",
                "getColor": "color",
            },
        },
        {
            "type": "ScatterplotLayer",
            "id": "cluster-points",
            "data": pts,
            "props": {"radiusMinPixels": 2},
            "accessors": {"getPosition": "position", "getFillColor": "color"},
        },
    ]
    return write_globe_html(
        layers, out_path, title="finished geocells"
    )


def load_point_set(path: str):
    """(N, 2) lat/lng from either the acquisition pipeline's JSON point
    lists ([{"lat": .., "lon"/"lng": ..}, ...] — reference
    src/point_visualization/visualize_sv_points.py:23-28) or the
    'lat, lng'-per-line txt ledgers (load_sv_points)."""
    if path.endswith(".json"):
        with open(path) as f:
            points = json.load(f)
        latlng = [
            (float(p["lat"]), float(p.get("lon", p.get("lng"))))
            for p in points
        ]
        if not latlng:
            raise ValueError(f"no points in {path}")
        return np.asarray(latlng, float)
    return load_sv_points(path)


def _point_set_layer(layer_id: str, latlng, color: List[int]) -> Dict:
    return {
        "type": "ScatterplotLayer",
        "id": layer_id,
        "data": [
            {"position": [float(lng), float(lat)]} for lat, lng in latlng
        ],
        "props": {
            "radiusMinPixels": 2,
            "getFillColor": color,
            "opacity": 0.8,
        },
        "accessors": {"getPosition": "position"},
    }


def create_sv_points_map(
    input_file: str = "data/out/sv_points.json",
    candidate_file: str = "data/out/candidate_points.json",
    output_file: str = "data/out/sv_points_map.html",
) -> Optional[str]:
    """Map of sampled Street View points, with the candidate-set success
    rate in the title when the candidate file exists (reference
    src/point_visualization/visualize_sv_points.py:11-49).  Returns the
    written path, or None when the input is missing (the reference
    prints and returns)."""
    if not os.path.exists(input_file):
        print(f"Error: {input_file} not found! Run the sampling script first.")
        return None
    sv = load_point_set(input_file)
    title = f"{len(sv):,} Street View points"
    if candidate_file and os.path.exists(candidate_file):
        n_cand = len(load_point_set(candidate_file))
        if n_cand:
            title += f" · success rate {len(sv) / n_cand * 100:.1f}%"
    center = sv.mean(axis=0)
    return write_globe_html(
        [_point_set_layer("sv-points", sv, [255, 120, 0, 220])],
        output_file,
        title=title,
        view_state={
            "longitude": float(center[1]),
            "latitude": float(center[0]),
            "zoom": 3.0,
        },
    )


def create_comparison_map(
    candidate_file: str = "data/out/candidate_points.json",
    sv_file: str = "data/out/sv_points.json",
    output_file: str = "data/out/comparison_map.html",
) -> Optional[str]:
    """Overlay candidate points (blue) vs verified Street View points
    (orange) to show where sampling succeeds (reference
    src/point_visualization/compare_point.py:11-78; same legend colors
    #3388ff / #ff7800).  Returns the written path, or None when neither
    input exists."""
    candidates = (
        load_point_set(candidate_file)
        if candidate_file and os.path.exists(candidate_file)
        else np.zeros((0, 2))
    )
    sv = (
        load_point_set(sv_file)
        if sv_file and os.path.exists(sv_file)
        else np.zeros((0, 2))
    )
    if not len(candidates) and not len(sv):
        print("No data files found. Run the sampling script first.")
        return None
    rate = len(sv) / len(candidates) * 100 if len(candidates) else 0.0
    allpts = np.concatenate([candidates, sv]) if len(candidates) else sv
    center = allpts.mean(axis=0)
    layers = [
        _point_set_layer("candidate-points", candidates, [51, 136, 255, 160]),
        _point_set_layer("sv-points", sv, [255, 120, 0, 220]),
    ]
    return write_globe_html(
        layers,
        output_file,
        title=(
            f"{len(candidates):,} candidates vs {len(sv):,} SV points "
            f"· success rate {rate:.1f}%"
        ),
        view_state={
            "longitude": float(center[1]),
            "latitude": float(center[0]),
            "zoom": 3.0,
        },
    )
