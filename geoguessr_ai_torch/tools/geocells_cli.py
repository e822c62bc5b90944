"""Geocell subsystem CLI (the port of tools/geocells_cli.py):

    python -m geoguessr_ai_torch.tools.geocells_cli <subcommand> ...

Subcommands:

  generate    — run combine/OPTICS/split over admin tables + points
  proto-df    — emit proto_df.csv from finished pickles
  centroids   — export the centroid-table .npz
  info        — counts per country
  visualize   — geocell globe HTML
  visualize-cell  — one cell's OPTICS clusters (reference cell_visualizer)
  visualize-admin — points colored by admin1 (reference admin_visualizer)
  naive       — naive rectangle partition of a point file
  cluster-demo — OPTICS-cluster random points in one Cell (ref mode 8)
  generate-all — sweep every GPKG country through generation (ref mode 9)
  gadm-query  — query country GIDs from the GPKG (ref mode 10)
  inspect     — dump one country's cells from the manager (ref mode 11)
  show-gadm   — geopackage layer-structure dump (reference show_gadm.py)
  visualize-finished — per-cluster colored points + centroid arrows
                (reference visualize_finished_geocells.py)

The subcommands that cluster (generate, generate-all, visualize-cell,
cluster-demo) run OPTICS on ``--device`` (default: the GPU).  The GADM
readers (generate-all's country list, gadm-query, show-gadm) go through
``sqlite3`` alone; show-gadm prints each column's declared SQLite type
where the root CLI prints a pandas dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import sqlite3
from typing import Optional, Sequence

import numpy as np

from geoguessr_ai_torch import config as C


def cmd_generate(args):
    from geoguessr_ai_torch.geocells.generate import (
        GenerateGeocells,
        load_admin_tables_from_gadm,
    )

    with open(args.points) as f:
        pts = [
            {"latitude": float(l.split(",")[0]),
             "longitude": float(l.split(",")[1])}
            for l in f
            if l.strip()
        ]
    tables = load_admin_tables_from_gadm(args.gadm, [args.country])
    gen = GenerateGeocells(tables, {args.country: pts}, device=args.device)
    gen.generate_geocells(args.out)


def cmd_proto_df(args):
    from geoguessr_ai_torch.geocells.manager import GeocellManager

    mgr = GeocellManager(args.geocell_dir)
    df = mgr.generate_proto_df(args.out)
    print(f"{len(df)} cluster rows, {mgr.num_cells} cells -> {args.out}")


def cmd_centroids(args):
    from geoguessr_ai_torch.geocells.manager import GeocellManager

    mgr = GeocellManager(args.geocell_dir)
    tab = mgr.build_centroid_table()
    tab.save(args.out)
    print(f"{tab.num_cells} centroids -> {args.out}")


def cmd_info(args):
    from geoguessr_ai_torch.geocells.manager import GeocellManager

    mgr = GeocellManager(args.geocell_dir)
    counts = {}
    for _, country, _, cell in mgr.iter_cells():
        counts[country] = counts.get(country, 0) + 1
    print(json.dumps(
        {"num_cells": mgr.num_cells, "num_points": len(mgr.point_info),
         "per_country": counts}, indent=1))


def cmd_visualize(args):
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.viz.globe import visualize_geocells

    tab = CentroidTable.load(args.centroids)
    print(visualize_geocells(tab, args.out))


def cmd_visualize_cell(args):
    from geoguessr_ai_torch.geocells.cell import cluster_cells
    from geoguessr_ai_torch.geocells.manager import GeocellManager
    from geoguessr_ai_torch.viz.globe import visualize_cell_clusters

    mgr = GeocellManager(args.geocell_dir)
    for idx, country, admin1, cell in mgr.iter_cells():
        if idx == args.cell_index:
            if not getattr(cell, "clusters", None):
                # any pickled cell (the JAX package's too): its points
                cluster_cells([cell], device=args.device)
            print(visualize_cell_clusters(cell, args.out))
            return
    raise SystemExit(f"no cell with index {args.cell_index}")


def cmd_visualize_admin(args):
    from geoguessr_ai_torch.geocells.manager import GeocellManager
    from geoguessr_ai_torch.viz.globe import visualize_admin_regions

    mgr = GeocellManager(args.geocell_dir)
    print(visualize_admin_regions(mgr, args.out, max_points=args.max_points))


def cmd_cluster_demo(args):
    """Reference mode 8 (geocells_entrypoint.py:60-65): cluster random
    points in one Cell and print the result."""
    import random as _random

    from geoguessr_ai_torch.geocells.cell import Cell

    rng = _random.Random(args.seed)
    pts = [
        {
            "latitude": rng.random() * args.spread,
            "longitude": rng.random() * args.spread,
        }
        for _ in range(args.num_points)
    ]
    cell = Cell("demo", "Demo", "Demo", points=pts)
    cell.cluster(device=args.device)
    for cid, c in cell.clusters.items():
        print(
            f"cluster {cid}: {len(c['points'])} pts, "
            f"centroid {c['centroid']}"
        )


def cmd_generate_all(args):
    """Reference mode 9 (geocells_entrypoint.py:66-78): generate geocells
    for EVERY country in the GPKG, one at a time."""
    from geoguessr_ai_torch.geocells.generate import (
        GenerateGeocells,
        load_admin_tables_from_gadm,
    )

    with sqlite3.connect(args.gadm) as sql:
        countries = [
            r[0] for r in sql.execute("SELECT COUNTRY FROM ADM_0")
        ]
    with open(args.points) as f:
        pts = [
            {
                "latitude": float(line.split(",")[0]),
                "longitude": float(line.split(",")[1]),
            }
            for line in f
            if line.strip()
        ]
    for i, country in enumerate(countries):
        print(f"[{i + 1}/{len(countries)}] {country}", flush=True)
        try:
            tables = load_admin_tables_from_gadm(args.gadm, [country])
            GenerateGeocells(
                tables, {country: pts}, device=args.device
            ).generate_geocells(args.out)
        except Exception as e:  # keep sweeping (reference loops all)
            print(f"  skipped: {e}")


def cmd_gadm_query(args):
    """Reference mode 10 (geocells_entrypoint.py:79-90): query country
    GIDs straight from the GPKG-as-SQLite."""
    with sqlite3.connect(args.gadm) as sql:
        q = "SELECT GID_0, COUNTRY FROM ADM_0"
        if args.country:
            q += " WHERE COUNTRY = ?"
            rows = sql.execute(q, (args.country,)).fetchall()
        else:
            rows = sql.execute(q).fetchall()
    for gid, country in rows:
        print(f"{gid}\t{country}")


def cmd_inspect(args):
    """Reference mode 11 (geocells_entrypoint.py:91-95): dump one
    country's cells from the GeocellManager."""
    from geoguessr_ai_torch.geocells.manager import GeocellManager

    mgr = GeocellManager(args.geocell_dir)
    for idx, country, admin1, cell in mgr.iter_cells():
        if country == args.country:
            print(
                f"[{idx}] {country}/{admin1} id={cell.id} "
                f"points={len(getattr(cell, 'points', []))} "
                f"clusters={len(getattr(cell, 'clusters', {}) or {})}"
            )


def _is_null(value) -> bool:
    """pandas' notion of a missing SQLite value: NULL or a float NaN."""
    return value is None or (isinstance(value, float) and value != value)


def cmd_show_gadm(args):
    """Reference show_gadm.py:1-81: dump a geopackage's layer structure
    (rows, columns, declared types, sample values) via its SQLite
    tables."""
    if not os.path.exists(args.gadm):
        raise SystemExit(f"Error: File {args.gadm} does not exist")
    print(f"Analyzing Geopackage: {args.gadm}")
    print("=" * 50)
    with sqlite3.connect(args.gadm) as conn:
        try:
            layers = [
                r[0]
                for r in conn.execute(
                    "SELECT table_name FROM gpkg_contents"
                ).fetchall()
            ]
        except sqlite3.Error as e:
            raise SystemExit(
                f"Error accessing gpkg_contents: {e}\n"
                "This might not be a valid geopackage file."
            )
        print(f"Found {len(layers)} layers:\n")
        for layer in layers:
            print(f"Layer: {layer}")
            print("-" * 30)
            try:
                cur = conn.execute(
                    f'SELECT * FROM "{layer}" LIMIT {args.sample_rows}'
                )
                columns = [d[0] for d in cur.description]
                rows = cur.fetchall()
                types = {
                    r[1]: r[2]
                    for r in conn.execute(f'PRAGMA table_info("{layer}")')
                }
                n = conn.execute(
                    f'SELECT COUNT(*) FROM "{layer}"'
                ).fetchone()[0]
                print(f"  Rows: {n}")
                print(f"  Columns: {len(columns)}")
                print("  Column details:")
                for j, col in enumerate(columns):
                    sample = "All null"
                    nonnull = [r[j] for r in rows if not _is_null(r[j])]
                    if nonnull:
                        sample = str(nonnull[0])
                        if len(sample) > 50:
                            sample = sample[:47] + "..."
                    print(f"    {col}: {types.get(col, '')} -> {sample}")
                print()
            except Exception as e:
                print(f"  Error reading layer: {e}\n")


def cmd_visualize_finished(args):
    from geoguessr_ai_torch.viz.globe import visualize_finished_geocells

    print(
        visualize_finished_geocells(args.proto_df, args.sv_points, args.out)
    )


def cmd_visualize_sv_points(args):
    from geoguessr_ai_torch.viz.globe import create_sv_points_map

    out = create_sv_points_map(args.points, args.candidates, args.out)
    print(out or "no input")


def cmd_compare_points(args):
    from geoguessr_ai_torch.viz.globe import create_comparison_map

    out = create_comparison_map(args.candidates, args.points, args.out)
    print(out or "no input")


def cmd_naive(args):
    from geoguessr_ai_torch.geocells.naive_cell import partition

    pts = np.loadtxt(args.points, delimiter=",")  # lat,lon rows
    cells = partition(pts[:, ::-1], args.num_cells)
    for c in cells:
        print(f"{len(c):6d} pts  [{c.lon_min:.2f},{c.lat_min:.2f}]..."
              f"[{c.lon_max:.2f},{c.lat_max:.2f}]")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    g.add_argument("--gadm", required=True)
    g.add_argument("--country", required=True)
    g.add_argument("--points", required=True, help="lat,lon lines")
    g.add_argument("--out", default=f"{C.GEOCELL_DIR}/finished_geocells")
    g.set_defaults(fn=cmd_generate)

    p = sub.add_parser("proto-df")
    p.add_argument("--geocell-dir", default=f"{C.GEOCELL_DIR}/finished_geocells")
    p.add_argument("--out", default=f"{C.GEOCELL_DIR}/proto_df.csv")
    p.set_defaults(fn=cmd_proto_df)

    c = sub.add_parser("centroids")
    c.add_argument("--geocell-dir", default=f"{C.GEOCELL_DIR}/finished_geocells")
    c.add_argument("--out", default=C.CENTROID_TABLE_PATH)
    c.set_defaults(fn=cmd_centroids)

    i = sub.add_parser("info")
    i.add_argument("--geocell-dir", default=f"{C.GEOCELL_DIR}/finished_geocells")
    i.set_defaults(fn=cmd_info)

    v = sub.add_parser("visualize")
    v.add_argument("--centroids", default=C.CENTROID_TABLE_PATH)
    v.add_argument("--out", default="data/out/geocells_globe.html")
    v.set_defaults(fn=cmd_visualize)

    vc = sub.add_parser("visualize-cell")
    vc.add_argument("--geocell-dir", default=f"{C.GEOCELL_DIR}/finished_geocells")
    vc.add_argument("--cell-index", type=int, required=True)
    vc.add_argument("--out", default="data/out/cell_clusters.html")
    vc.set_defaults(fn=cmd_visualize_cell)

    va = sub.add_parser("visualize-admin")
    va.add_argument("--geocell-dir", default=f"{C.GEOCELL_DIR}/finished_geocells")
    va.add_argument("--max-points", type=int, default=200_000)
    va.add_argument("--out", default="data/out/admin_regions.html")
    va.set_defaults(fn=cmd_visualize_admin)

    n = sub.add_parser("naive")
    n.add_argument("--points", required=True)
    n.add_argument("--num-cells", type=int, default=100)
    n.set_defaults(fn=cmd_naive)

    cd = sub.add_parser("cluster-demo")
    cd.add_argument("--num-points", type=int, default=100)
    cd.add_argument("--spread", type=float, default=1.0)
    cd.add_argument("--seed", type=int, default=0)
    cd.set_defaults(fn=cmd_cluster_demo)

    ga = sub.add_parser("generate-all")
    ga.add_argument("--gadm", required=True)
    ga.add_argument("--points", required=True, help="lat,lon lines")
    ga.add_argument("--out", default=f"{C.GEOCELL_DIR}/finished_geocells")
    ga.set_defaults(fn=cmd_generate_all)

    gq = sub.add_parser("gadm-query")
    gq.add_argument("--gadm", required=True)
    gq.add_argument("--country", default=None)
    gq.set_defaults(fn=cmd_gadm_query)

    ins = sub.add_parser("inspect")
    ins.add_argument(
        "--geocell-dir", default=f"{C.GEOCELL_DIR}/finished_geocells"
    )
    ins.add_argument("--country", required=True)
    ins.set_defaults(fn=cmd_inspect)

    vf = sub.add_parser("visualize-finished")
    vf.add_argument("--proto-df", default=f"{C.GEOCELL_DIR}/proto_df.csv")
    vf.add_argument("--sv-points", required=True, help="lat,lng lines")
    vf.add_argument(
        "--out", default="data/out/finished_geocells_globe.html"
    )
    vf.set_defaults(fn=cmd_visualize_finished)

    vs = sub.add_parser(
        "visualize-sv-points",
        help="map of sampled SV points (reference "
        "src/point_visualization/visualize_sv_points.py)",
    )
    vs.add_argument("--points", default="data/out/sv_points.json")
    vs.add_argument("--candidates", default="data/out/candidate_points.json")
    vs.add_argument("--out", default="data/out/sv_points_map.html")
    vs.set_defaults(fn=cmd_visualize_sv_points)

    cp = sub.add_parser(
        "compare-points",
        help="candidates vs verified SV points overlay (reference "
        "src/point_visualization/compare_point.py)",
    )
    cp.add_argument("--points", default="data/out/sv_points.json")
    cp.add_argument("--candidates", default="data/out/candidate_points.json")
    cp.add_argument("--out", default="data/out/comparison_map.html")
    cp.set_defaults(fn=cmd_compare_points)

    sg = sub.add_parser("show-gadm")
    sg.add_argument("--gadm", required=True)
    sg.add_argument("--sample-rows", type=int, default=5)
    sg.set_defaults(fn=cmd_show_gadm)

    for clusters in (g, vc, cd, ga):
        clusters.add_argument(
            "--device", default=None,
            help="where OPTICS runs (default: the GPU; 'cpu' to ask for "
            "the CPU)")
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
