"""The port's geocell generation, its OPTICS, the naive and Voronoi cells,
the globe HTML and the geocell and BPE commands, held against the JAX
package, scikit-learn and the root tools on the CPU.

* ``geocells.optics`` equals ``sklearn.cluster.OPTICS`` (min_samples 5,
  min_cluster_size 0.05, xi 0.05 and 0.00005) bit for bit: ordering, core
  distances, reachability, predecessors and labels, on seeded clouds with
  blobs, exact duplicates and collinear grids (ties), at sizes on both
  sides of scikit-learn's brute-force / kd-tree switch, on hypothesis'
  small clouds and on 3,000 points of ``chip_smoke.py``'s phase 35 set of
  20,000; ``optics_many`` equals the per-set calls;
* ``Cell`` and ``GenerateGeocells(device="cpu")`` give the JAX package's
  cells, clusters and neighbour lists (``tests/test_geocell_generation.py``
  fixtures and more), and both managers read both packages' pickles alike;
* ``naive_cell``, ``voronoi`` and every ``viz/globe.py`` function give the
  JAX module's output; the port's geocell CLI prints what the root CLI
  prints (but show-gadm's type column), and ``tools.build_clip_bpe``
  writes the root tool's files byte for byte.
"""

import csv
import dataclasses
import hashlib
import importlib.util
import json
import os
import pickle
import re
import sqlite3
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.spatial import Voronoi
from sklearn.cluster import OPTICS

from geoguessr_ai_tpu.geocells import naive_cell as jnaive
from geoguessr_ai_tpu.geocells import voronoi as jvoronoi
from geoguessr_ai_tpu.geocells.cell import Cell as JaxCell
from geoguessr_ai_tpu.geocells.generate import GenerateGeocells as JaxGenerate
from geoguessr_ai_tpu.geocells.manager import (
    CentroidTable as JaxCentroidTable,
    GeocellManager as JaxManager,
)
from geoguessr_ai_tpu.viz import globe as jglobe

from geoguessr_ai_torch import config as C
from geoguessr_ai_torch.geocells import naive_cell, optics, voronoi
from geoguessr_ai_torch.geocells.cell import Cell, cluster_cells, split_cells
from geoguessr_ai_torch.geocells.generate import (
    GenerateGeocells,
    load_admin_tables_from_gadm,
)
from geoguessr_ai_torch.geocells.manager import GeocellManager
from geoguessr_ai_torch.tools import build_clip_bpe, geocells_cli
from geoguessr_ai_torch.viz import globe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _load_root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# OPTICS against scikit-learn
# ---------------------------------------------------------------------------


def _cloud(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "blobs":
        k = max(1, n // 40)
        centres = rng.uniform(-20, 20, (k, 2))
        blob = centres[rng.integers(0, k, n // 2)] + rng.normal(
            0, 0.3, (n // 2, 2))
        return np.concatenate([blob, rng.uniform(-25, 25, (n - n // 2, 2))])
    if kind == "duplicates":
        base = rng.uniform(40, 41, (max(2, n // 3), 2))
        return base[rng.integers(0, len(base), n)]
    # a collinear grid: every distance repeats
    side = int(np.ceil(np.sqrt(n)))
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    return grid.reshape(-1, 2)[:n] * 0.5 + 10.0


def _optics(X, xi=0.05, **kwargs):
    return optics.optics_many([X], 5, xi, 0.05, **kwargs)[0]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        a, b = a.view(np.int64), b.view(np.int64)
    return a.shape == b.shape and np.array_equal(a, b)


def _assert_equals_sklearn(X, xi):
    with np.errstate(divide="ignore"):
        want = OPTICS(min_samples=5, xi=xi, min_cluster_size=0.05).fit(X)
    got = _optics(X, xi, device=CPU)
    assert _same_bits(got.ordering, want.ordering_)
    assert _same_bits(got.core_distances, want.core_distances_)
    assert _same_bits(got.reachability, want.reachability_)
    assert _same_bits(got.predecessor, want.predecessor_)
    assert _same_bits(got.labels, want.labels_)
    return got


@pytest.mark.parametrize("xi", [0.05, 0.00005])
@pytest.mark.parametrize("kind", ["blobs", "duplicates", "grid"])
@pytest.mark.parametrize("n", [6, 7, 50, 300])
def test_optics_equals_sklearn_bit_for_bit(n, kind, xi):
    _assert_equals_sklearn(_cloud(n, kind, seed=n), xi)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(6, 40), st.integers(0, 2**32 - 1),
       st.sampled_from(["blobs", "duplicates", "grid", "wide"]))
def test_optics_equals_sklearn_on_small_clouds(n, seed, kind):
    if kind == "wide":
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 2)) * rng.uniform(1e-3, 50) + rng.uniform(
            -170, 170, 2)
    else:
        X = _cloud(n, kind, seed)
    _assert_equals_sklearn(X, 0.05)


@pytest.fixture(scope="module")
def chip_big_set():
    """The (20,000, 2) set of chip_smoke.py's phase 35 (b): the world's
    points nearest its largest admin1's centroid, nearest first."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke._gen_world(np.random.default_rng(chip_smoke.SEED))[2]


@pytest.mark.parametrize("part", ["nearest", "thinned"])
def test_optics_equals_sklearn_on_the_chip_worlds_big_set(chip_big_set,
                                                          part):
    """Phase 35's big set at 3,000 points, where the card meets only the
    port's CPU path: its 3,000 points nearest the centre, or 3,000 of its
    points drawn with a seed (its shape, thinned)."""
    if part == "nearest":
        X = chip_big_set[:3000]
    else:
        X = chip_big_set[np.sort(np.random.default_rng(0).choice(
            len(chip_big_set), 3000, replace=False))]
    got = _assert_equals_sklearn(X, 0.05)
    assert got.labels.max() >= 1


def test_fma_and_sqrt_are_rounded_once():
    rng = np.random.default_rng(0)
    n = 3000
    a = rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n)
    b = rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n)
    c = -(a * b) * (1 + rng.normal(size=n) * 1e-9)  # cancellation
    c[::3] = rng.normal(size=len(c[::3]))
    c[1::7] = 0.0
    got = optics._fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert _same_bits(got, np.array(want))
    x = np.concatenate([rng.uniform(0, 1000, 20000), [0.0, 4.0, 2.0]])
    assert _same_bits(optics._sqrt_rn(torch.from_numpy(x)).numpy(),
                      np.sqrt(x))


def test_optics_many_equals_each_call():
    sets = [_cloud(n, kind, seed=n + 7)
            for n in (6, 9, 11, 12, 13, 30, 64, 65, 200)
            for kind in ("blobs", "duplicates", "grid")]
    many = optics.optics_many(sets, device=CPU)
    assert len(many) == len(sets)
    for X, got in zip(sets, many):
        one = _optics(X, device=CPU)
        for field in dataclasses.fields(one):
            assert _same_bits(getattr(got, field.name),
                              getattr(one, field.name))


def test_buckets_keep_the_brute_force_sets_apart():
    sizes = [6, 300, 11, 12, 150, 149, 40, 9]
    buckets = optics._buckets(sizes, 5)
    assert sorted(i for b in buckets for i in b) == list(range(len(sizes)))
    for b in buckets:
        ns = [sizes[i] for i in b]
        assert ns == sorted(ns, reverse=True)
        assert len({5 >= n // 2 for n in ns}) == 1
        assert ns[-1] >= optics._BUCKET_SPAN * ns[0]


def test_optics_refuses_what_sklearn_refuses():
    X = _cloud(6, "blobs", 0)
    with pytest.raises(ValueError, match="min_samples"):
        optics.optics_many([X[:4]], device=CPU)
    with pytest.raises(ValueError, match="min_samples"):
        optics.optics_many([X], min_samples=1, device=CPU)
    with pytest.raises(ValueError, match="min_cluster_size"):
        optics.optics_many([X], min_cluster_size=7, device=CPU)
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        optics.optics_many([np.zeros((8, 3))], device=CPU)


# ---------------------------------------------------------------------------
# Cell and GenerateGeocells against the JAX package
# ---------------------------------------------------------------------------


def _square(x0, y0, size=10.0):
    return np.array(
        [[x0, y0], [x0 + size, y0], [x0 + size, y0 + size], [x0, y0 + size]]
    )


def _points_in(x0, y0, n, size=10.0, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {
            "latitude": float(rng.uniform(y0 + 0.5, y0 + size - 0.5)),
            "longitude": float(rng.uniform(x0 + 0.5, x0 + size - 0.5)),
        }
        for _ in range(n)
    ]


def _blob_points(lat, lng, n, sigma, seed):
    rng = np.random.default_rng(seed)
    return [{"latitude": float(lat + rng.normal(0, sigma)),
             "longitude": float(lng + rng.normal(0, sigma))}
            for _ in range(n)]


def _fixture_world():
    """tests/test_geocell_generation.py's three admin squares and 153
    points."""
    admin = {
        "Testland": {
            "West": [_square(0, 0)],
            "East": [_square(10, 0)],
            "North": [_square(0, 10)],
        }
    }
    points = (
        _points_in(0, 0, 30, seed=1)
        + _points_in(10, 0, 3, seed=2)
        + _points_in(0, 10, 120, seed=3)
    )
    return admin, {"Testland": points}


def _wider_world():
    """Three countries: blobs that split in two of them, a small admin
    area combined away, a lone cell."""
    admin = {
        "Gamma": {"A": [_square(0, 0, 4)], "B": [_square(4, 0, 4)],
                  "C": [_square(0, 4, 4)], "D": [_square(20, 20, 2)]},
        "Beta": {"Only": [_square(40, 40)]},
        "Alpha": {"South": [_square(-60, -30)], "Rest": [_square(-50, -30)]},
    }
    points = {
        "Gamma": (_blob_points(1, 1, 60, 0.05, 1) + _blob_points(3, 3, 50,
                                                                 0.05, 2)
                  + _points_in(0, 0, 40, 4.0, seed=3)
                  + _points_in(4, 0, 4, 4.0, seed=4)
                  + _blob_points(6, 1, 80, 0.2, 5)
                  + _points_in(0, 4, 30, 4.0, seed=6)
                  + _points_in(20, 20, 8, 2.0, seed=7)),
        "Beta": _blob_points(45, 45, 70, 0.3, 8) + _blob_points(
            42, 48, 70, 0.3, 9),
        "Alpha": _points_in(-60, -30, 18, seed=10) + _points_in(
            -50, -30, 22, seed=11),
    }
    return admin, points


def _same_clusters(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k]["points"] == b[k]["points"]
        assert a[k]["centroid"] == b[k]["centroid"]
        assert a[k]["hashes"] == b[k]["hashes"]


def _same_cells(jcells, pcells):
    assert set(jcells) == set(pcells)
    for country in jcells:
        js, ps = jcells[country], pcells[country]
        assert len(js) == len(ps)
        for jc, pc in zip(js, ps):
            assert (pc.country, pc.admin_1) == (jc.country, jc.admin_1)
            assert pc.points == jc.points
            assert pc.curr_coords == jc.curr_coords
            assert pc.point_centroid == jc.point_centroid
            assert pc.geom_centroid == jc.geom_centroid
            _same_clusters(jc.clusters, pc.clusters)
            assert [js.index(n) for n in jc.neighbours] == \
                [ps.index(n) for n in pc.neighbours]


@pytest.mark.parametrize("world", ["fixture", "wider"])
def test_generation_matches_the_jax_package(world):
    admin, points = _fixture_world() if world == "fixture" else \
        _wider_world()
    jgen = JaxGenerate(admin, points, min_points=10, max_points=67)
    pgen = GenerateGeocells(admin, points, min_points=10, max_points=67,
                            device=CPU)
    for step in ("init_cells", "add_points_to_cells", "combine_small_cells",
                 "cluster_cells", "split_large_cells"):
        getattr(jgen, step)()
        getattr(pgen, step)()
        _same_cells(jgen.cells, pgen.cells)
    if world == "wider":
        # splits happened in more than one country, in one batched call
        assert sum(len(v) for v in pgen.cells.values()) > sum(
            len(v) for v in admin.values())


def test_cell_cluster_and_split_match_the_jax_cell():
    # test_cluster_and_split's two far-apart blobs
    pts = _points_in(0, 0, 40, size=2.0, seed=7) + _points_in(
        50, 50, 40, size=2.0, seed=8
    )
    jc, pc = JaxCell("S", "X", "S", points=pts), Cell("S", "X", "S",
                                                      points=pts)
    jc.cluster()
    pc.cluster(device=CPU)
    _same_clusters(jc.clusters, pc.clusters)
    jkids = jc.split_cell(min_split_points=10)
    pkids = pc.split_cell(min_split_points=10, device=CPU)
    assert len(pkids) == len(jkids) and len(pkids) >= 1
    assert pc.points == jc.points
    _same_clusters(jc.clusters, pc.clusters)
    for jk, pk in zip(jkids, pkids):
        assert pk.points == jk.points and pk.neighbours == [pc]
        _same_clusters(jk.clusters, pk.clusters)
    assert pc.neighbours == pkids
    # a few points only: one cluster, no OPTICS; none at all: no clusters
    for n in (0, 5):
        jc, pc = JaxCell("T", "X", "T", points=pts[:n]), Cell(
            "T", "X", "T", points=pts[:n])
        jc.cluster()
        pc.cluster(device=CPU)
        _same_clusters(jc.clusters, pc.clusters)


def test_split_cells_equals_split_cell_one_by_one():
    _, points = _wider_world()
    cells = [Cell(c, c, c, points=p) for c, p in points.items()]
    alone = [Cell(c, c, c, points=p) for c, p in points.items()]
    cluster_cells(cells, device=CPU)
    kids = split_cells(cells, device=CPU)
    for cell, mine, lone in zip(cells, kids, alone):
        lone.cluster(device=CPU)
        theirs = lone.split_cell(device=CPU)
        assert [k.points for k in mine] == [k.points for k in theirs]
        for a, b in zip(mine, theirs):
            _same_clusters(a.clusters, b.clusters)
        assert cell.points == lone.points
        _same_clusters(cell.clusters, lone.clusters)


def test_combine_rewires_neighbours_as_the_jax_cell():
    made = {}
    for mod, cls in (("jax", JaxCell), ("port", Cell)):
        a = cls("A", "X", "A", points=_points_in(0, 0, 5))
        b = cls("B", "X", "B", points=_points_in(10, 0, 20, seed=5))
        c = cls("C", "X", "C", points=_points_in(20, 0, 20, seed=6))
        a.neighbours = [b]
        b.neighbours = [a, c]
        c.neighbours = [b]
        b.combine(a)
        made[mod] = [a, b, c]
        assert len(b) == 25 and a not in b.neighbours and len(a) == 0
    for j, p in zip(*made.values()):
        assert p.points == j.points and p.geom_centroid == j.geom_centroid
        assert [made["port"].index(n) for n in p.neighbours] == \
            [made["jax"].index(n) for n in j.neighbours]
    assert made["port"][1].contains(15.0, 5.0) is False
    cell = Cell("P", "X", "P", polygons=[_square(0, 0)])
    jcell = JaxCell("P", "X", "P", polygons=[_square(0, 0)])
    assert cell.contains(5.0, 5.0) and not cell.contains(15.0, 5.0)
    assert cell.geom_centroid == jcell.geom_centroid


@pytest.fixture(scope="module")
def both_pickles(tmp_path_factory):
    """The fixture world's pickles, written by each package."""
    admin, points = _wider_world()
    root = tmp_path_factory.mktemp("pickles")
    dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
    JaxGenerate(admin, points).generate_geocells(dirs["jax"])
    GenerateGeocells(admin, points, device=CPU).generate_geocells(
        dirs["port"])
    return dirs


def _table(t):
    return (t.centroids.tobytes(), list(t.country), list(t.admin1),
            list(t.cell_id))


def test_both_managers_read_both_packages_pickles(both_pickles):
    tables, protos = {}, {}
    for maker, path in both_pickles.items():
        jm, pm = JaxManager(path), GeocellManager(path)
        assert pm.num_cells == jm.num_cells > 4
        assert [(i, c, k, cell.id) for i, c, k, cell in pm.iter_cells()] == \
            [(i, c, k, cell.id) for i, c, k, cell in jm.iter_cells()]
        assert _table(pm.build_centroid_table()) == \
            _table(jm.build_centroid_table())
        assert [dataclasses.asdict(v) for v in pm.point_info.values()] == \
            [dataclasses.asdict(v) for v in jm.point_info.values()]
        rows = pm.generate_proto_df()
        jrows = jm.generate_proto_df().to_dict("records")
        assert len(rows) == len(jrows)
        for r, jr in zip(rows, jrows):
            assert {k: r[k] for k in r if k != "indices"} == \
                {k: jr[k] for k in r if k != "indices"}
            assert list(r["indices"]) == list(jr["indices"])
        tables[maker] = pm.build_centroid_table()
        protos[maker] = [{k: v for k, v in r.items() if k != "cell_id"}
                         for r in rows]
    # the two packages' pickles differ only in the uuid ids
    a, b = tables["jax"], tables["port"]
    assert a.centroids.tobytes() == b.centroids.tobytes()
    assert list(a.country) == list(b.country)
    assert list(a.admin1) == list(b.admin1)
    assert protos["jax"] == protos["port"]
    # a pickle holds the reference's attributes and no device
    with open(os.path.join(both_pickles["port"],
                           "geocells_Gamma.pickle"), "rb") as f:
        cell = pickle.load(f)["Gamma"][0]
    assert set(vars(cell)) == {
        "id", "country", "admin_1", "points", "polygons", "neighbours",
        "clusters", "current_shape", "curr_coords", "point_centroid",
        "geom_centroid"}


# ---------------------------------------------------------------------------
# The naive cells, the Voronoi regions and the globe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_cells", [1, 16, 64])
def test_naive_partition_matches_the_jax_module(num_cells):
    rng = np.random.default_rng(num_cells)
    pts = np.concatenate([rng.uniform(-50, 50, (400, 2)),
                          np.repeat(rng.uniform(0, 1, (1, 2)), 30, 0)])
    mine = naive_cell.partition(pts, num_cells)
    theirs = jnaive.partition(pts, num_cells)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert (a.lon_min, a.lat_min, a.lon_max, a.lat_max) == \
            (b.lon_min, b.lat_min, b.lon_max, b.lat_max)
        assert np.array_equal(a.points, b.points)
        assert a.centroid == b.centroid


def test_voronoi_matches_the_jax_module():
    rng = np.random.default_rng(1)
    vor = Voronoi(rng.uniform(0, 10, (30, 2)))
    for radius in (None, 3.0):
        mine = voronoi.voronoi_finite_polygons_2d(vor, radius)
        theirs = jvoronoi.voronoi_finite_polygons_2d(vor, radius)
        assert mine[0] == theirs[0]
        assert np.array_equal(mine[1], theirs[1])


def _globe_pair(tmp_path, name, fn, *args, **kwargs):
    """fn of both modules on the same inputs: (port's HTML, JAX's)."""
    out = []
    for mod in (globe, jglobe):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}_{name}.html")
        got = getattr(mod, fn)(*args, path, **kwargs)
        assert got == path
        with open(path) as f:
            out.append(f.read())
    return out


def _guess_records():
    return [
        {"gt_lat": 59.9, "gt_lon": 10.7, "pred_lat": 48.8, "pred_lon": 2.3,
         "distance_km": 1343.0, "score": 2000},
        {"gt_lat": -33.9, "gt_lon": 151.2, "pred_lat": -37.8,
         "pred_lon": 145.0, "distance_km": 713.4},
        {"summary": True, "num_samples": 2},
    ]


def test_globe_writes_the_jax_html(tmp_path):
    records = _guess_records()
    assert globe.guesses_layers(records) == jglobe.guesses_layers(records)
    jpath = tmp_path / "results.json"
    jpath.write_text(json.dumps(records))
    a, b = _globe_pair(tmp_path, "guesses", "visualize_guesses", str(jpath))
    assert a == b and "1343 km" in a
    layers = globe.guesses_layers(records)
    a, b = _globe_pair(tmp_path, "raw", "write_globe_html", layers,
                       title="t", view_state={"zoom": 2})
    assert a == b
    tab = JaxCentroidTable.load(C.CENTROID_TABLE_PATH)
    a, b = _globe_pair(tmp_path, "cells", "visualize_geocells", tab,
                       max_cells=100)
    assert a == b and a.count('"position": [') == 100
    a, b = _globe_pair(tmp_path, "single", "visualize_single_guess", 59.9,
                       10.7, 48.8, 2.3, 1343.0, 2000.0)
    assert a == b

    class _Rec:
        def __init__(self, country, admin1):
            self.country, self.admin1 = country, admin1

    class _Mgr:
        point_info = {(10.0, 20.0): _Rec("Norway", "Rogaland"),
                      (10.1, 20.1): _Rec("Norway", "Oslo"),
                      (-5.0, 30.0): _Rec("Kenya", "Nairobi")}

    a, b = _globe_pair(tmp_path, "admin", "visualize_admin_regions", _Mgr(),
                       max_points=2)
    assert a == b and "Kenya" not in a


def test_globe_cell_clusters_match_the_jax_html(tmp_path):
    rng = np.random.default_rng(0)
    pts = [(10.0 + float(rng.normal(0, 0.05)), 20.0 + float(
        rng.normal(0, 0.05))) for _ in range(20)] + [
        (11.0 + float(rng.normal(0, 0.05)), 21.0 + float(
            rng.normal(0, 0.05))) for _ in range(20)]
    cell = Cell("t", "Testland", "T1", points=pts)
    cell.cluster(device=CPU)
    jcell = JaxCell("t", "Testland", "T1", points=pts)
    jcell.cluster()
    _same_clusters(jcell.clusters, cell.clusters)
    a, b = _globe_pair(tmp_path, "cell", "visualize_cell_clusters", cell)
    assert a == b and '"id": "members"' in a
    empty = Cell("e", "X", "E")
    a, b = _globe_pair(tmp_path, "empty", "visualize_cell_clusters", empty)
    assert a == b


def _proto_csv(path):
    rows = [
        {"geocell_index": 0, "country": "X", "admin1": "Y", "cell_id": "c0",
         "cluster_id": 0, "count": 2, "indices": "[0, 1]",
         "centroid_lat": 10.05, "centroid_lng": 20.05},
        {"geocell_index": 0, "country": "X", "admin1": "Y", "cell_id": "c0",
         "cluster_id": 3, "count": 1, "indices": "[4]",
         "centroid_lat": 10.05, "centroid_lng": 20.05},
        {"geocell_index": 1, "country": "X", "admin1": "Z", "cell_id": "c1",
         "cluster_id": 0, "count": 1, "indices": "[2, 99]",
         "centroid_lat": -5.0, "centroid_lng": 30.0},
        {"geocell_index": 2, "country": "W", "admin1": "V", "cell_id": "c2",
         "cluster_id": -1, "count": 0, "indices": "[]",
         "centroid_lat": 0.0, "centroid_lng": 0.0},
    ]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_globe_point_maps_match_the_jax_html(tmp_path):
    sv_txt = tmp_path / "sv_points.txt"
    sv_txt.write_text("10.0, 20.0\n10.1, 20.1\n-5.0, 30.0\nbad line\n"
                      "1 2\n7.0, 8.0\n")
    proto = tmp_path / "proto_df.csv"
    _proto_csv(proto)
    a, b = _globe_pair(tmp_path, "finished", "visualize_finished_geocells",
                       str(proto), str(sv_txt))
    assert a == b and "geocell 0 cluster 3" in a
    assert np.array_equal(globe.load_sv_points(str(sv_txt)),
                          jglobe.load_sv_points(str(sv_txt)))
    for value in ("[3, 4]", "7", "", "[1, x]", [5, 6], (7,)):
        try:
            want = jglobe.parse_indices_column(value)
        except ValueError:
            with pytest.raises(ValueError):
                globe.parse_indices_column(value)
            continue
        assert globe.parse_indices_column(value) == want
    sv = tmp_path / "sv.json"
    sv.write_text(json.dumps([{"lat": 59.9, "lon": 10.7},
                              {"lat": 63.4, "lon": 10.4}]))
    cand = tmp_path / "cand.json"
    cand.write_text(json.dumps([{"lat": 59.9, "lng": 10.7},
                                {"lat": 60.0, "lng": 9.0},
                                {"lat": 61.0, "lng": 8.0}]))
    for path in (sv, cand, sv_txt):
        assert np.array_equal(globe.load_point_set(str(path)),
                              jglobe.load_point_set(str(path)))
    for fn, args in (("create_sv_points_map", (str(sv), str(cand))),
                     ("create_comparison_map", (str(cand), str(sv_txt)))):
        outs = []
        for mod in (globe, jglobe):
            out = str(tmp_path / f"{mod.__name__.split('.')[0]}_{fn}.html")
            assert getattr(mod, fn)(*args, out) == out
            outs.append(open(out).read())
        assert outs[0] == outs[1]
    missing = str(tmp_path / "missing.json")
    assert globe.create_sv_points_map(missing, str(cand), missing) is None
    assert globe.create_comparison_map(missing, missing, missing) is None


# ---------------------------------------------------------------------------
# The geocell CLI and the BPE command against the root tools
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root_cli():
    return _load_root_tool("geocells_cli")


def _run_cli(capsys, monkeypatch, which, root_cli, argv):
    if which == "root":
        monkeypatch.setattr(sys, "argv", ["geocells_cli.py"] + argv)
        root_cli.main()
    else:
        geocells_cli.main(argv)
    return capsys.readouterr().out


def _gadm(path):
    with sqlite3.connect(path) as db:
        db.execute("CREATE TABLE gpkg_contents (table_name TEXT, "
                   "data_type TEXT)")
        db.executemany("INSERT INTO gpkg_contents VALUES (?, ?)",
                       [("ADM_0", "features"), ("ADM_1", "features")])
        db.execute("CREATE TABLE ADM_0 (fid INTEGER, GID_0 TEXT, "
                   "COUNTRY TEXT, AREA REAL, NOTE TEXT)")
        db.executemany("INSERT INTO ADM_0 VALUES (?, ?, ?, ?, ?)",
                       [(1, "NOR", "Norway", 1.5, None),
                        (2, "KEN", "Kenya", 2.25, None),
                        (3, "XYZ", "A country with a very long name that "
                         "runs on past fifty characters", 0.5, None)])
        db.execute("CREATE TABLE ADM_1 (fid INTEGER, NAME_1 TEXT)")
        db.execute("INSERT INTO ADM_1 VALUES (1, 'Oslo')")


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """JAX-made pickles of the wider world (the Beta cell's clusters
    dropped: visualize-cell clusters it first), their centroid table, a
    points file, a GeoPackage-like SQLite, a proto CSV and point sets."""
    tmp = tmp_path_factory.mktemp("cli")
    admin, points = _wider_world()
    geo = tmp / "geocells"
    JaxGenerate(admin, points).generate_geocells(str(geo))
    path = geo / "geocells_Beta.pickle"
    with open(path, "rb") as f:
        data = pickle.load(f)
    data["Beta"][0].clusters = {}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    npz = str(tmp / "table.npz")
    JaxManager(str(geo)).build_centroid_table().save(npz)
    pts = tmp / "points.txt"
    rng = np.random.default_rng(3)
    pts.write_text("".join(f"{lat},{lon}\n" for lat, lon in rng.uniform(
        -40, 40, (200, 2))))
    gadm = str(tmp / "gadm.gpkg")
    _gadm(gadm)
    proto = str(tmp / "proto.csv")
    _proto_csv(proto)
    sv = tmp / "sv.txt"
    sv.write_text("10.0, 20.0\n10.1, 20.1\n-5.0, 30.0\n")
    svjson = tmp / "sv.json"
    svjson.write_text(json.dumps([{"lat": 59.9, "lon": 10.7}]))
    beta = next(i for i, c, _, _ in JaxManager(str(geo)).iter_cells()
                if c == "Beta")
    return dict(geo=str(geo), pts=str(pts), gadm=gadm, npz=npz, beta=beta,
                proto=proto, sv=str(sv), svjson=str(svjson))


CLI_CASES = {
    "proto-df": ["proto-df", "--geocell-dir", "{geo}", "--out", "{out}.csv"],
    "centroids": ["centroids", "--geocell-dir", "{geo}", "--out",
                  "{out}.npz"],
    "info": ["info", "--geocell-dir", "{geo}"],
    "visualize": ["visualize", "--centroids", "{npz}", "--out", "{out}.html"],
    "visualize-cell": ["visualize-cell", "--geocell-dir", "{geo}",
                       "--cell-index", "{beta}", "--out", "{out}.html"],
    "visualize-cell-clustered": ["visualize-cell", "--geocell-dir", "{geo}",
                                 "--cell-index", "0", "--out", "{out}.html"],
    "visualize-admin": ["visualize-admin", "--geocell-dir", "{geo}",
                        "--max-points", "50", "--out", "{out}.html"],
    "naive": ["naive", "--points", "{pts}", "--num-cells", "12"],
    "cluster-demo": ["cluster-demo", "--num-points", "120", "--seed", "4"],
    "generate-all": ["generate-all", "--gadm", "{gadm}", "--points", "{pts}",
                     "--out", "{out}"],
    "gadm-query": ["gadm-query", "--gadm", "{gadm}"],
    "gadm-query-country": ["gadm-query", "--gadm", "{gadm}", "--country",
                           "Kenya"],
    "inspect": ["inspect", "--geocell-dir", "{geo}", "--country", "Gamma"],
    "show-gadm": ["show-gadm", "--gadm", "{gadm}", "--sample-rows", "2"],
    "visualize-finished": ["visualize-finished", "--proto-df", "{proto}",
                           "--sv-points", "{sv}", "--out", "{out}.html"],
    "visualize-sv-points": ["visualize-sv-points", "--points", "{svjson}",
                            "--candidates", "{svjson}", "--out",
                            "{out}.html"],
    "compare-points": ["compare-points", "--points", "{sv}", "--candidates",
                       "{svjson}", "--out", "{out}.html"],
}
#: The subcommands that cluster take the port's --device.
CLUSTERING = ("visualize-cell", "cluster-demo", "generate-all", "generate")


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_geocell_cli_prints_what_the_root_cli_prints(
        case, tmp_path, capsys, monkeypatch, root_cli, cli_world):
    outs, files = [], []
    for which in ("root", "port"):
        out = str(tmp_path / f"{which}_out")
        argv = [a.format(out=out, **cli_world) for a in CLI_CASES[case]]
        if which == "port" and argv[0] in CLUSTERING:
            argv += ["--device", "cpu"]
        printed = _run_cli(capsys, monkeypatch, which, root_cli, argv)
        outs.append(printed.replace(out, "OUT"))
        written = sorted(p for p in os.listdir(tmp_path)
                         if p.startswith(f"{which}_out"))
        files.append([open(tmp_path / p, "rb").read() for p in written
                      if not p.endswith(".npz")])
    if case == "show-gadm":
        # the type column: a pandas dtype there, the declared type here
        outs = [re.sub(r"^(    \w+): \S* -> ", r"\1: -> ", o, flags=re.M)
                for o in outs]
    assert outs[0] == outs[1]
    assert files[0] == files[1]
    assert outs[1].strip()
    if case == "generate-all":
        assert "skipped: No module named 'geopandas'" in outs[1]


def test_show_gadm_prints_the_declared_types(tmp_path, capsys):
    gadm = str(tmp_path / "gadm.gpkg")
    _gadm(gadm)
    geocells_cli.main(["show-gadm", "--gadm", gadm])
    out = capsys.readouterr().out
    for line in ("    fid: INTEGER -> 1", "    GID_0: TEXT -> NOR",
                 "    AREA: REAL -> 1.5", "    NOTE: TEXT -> All null",
                 "  Rows: 3", "  Columns: 5", "Found 2 layers:"):
        assert line in out
    with pytest.raises(SystemExit, match="does not exist"):
        geocells_cli.main(["show-gadm", "--gadm", str(tmp_path / "no")])


def test_generate_needs_geopandas_in_both_clis(tmp_path, capsys,
                                               monkeypatch, root_cli,
                                               cli_world):
    pts, gadm = cli_world["pts"], cli_world["gadm"]
    argv = ["generate", "--gadm", gadm, "--country", "Kenya", "--points",
            pts, "--out", str(tmp_path / "g")]
    monkeypatch.setitem(sys.modules, "geopandas", None)
    with pytest.raises(ImportError):
        _run_cli(capsys, monkeypatch, "root", root_cli, argv)
    with pytest.raises(ImportError):
        geocells_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(ImportError):
        load_admin_tables_from_gadm(gadm, ["Kenya"])


def test_build_clip_bpe_writes_the_root_tools_files(tmp_path, monkeypatch,
                                                    capsys):
    shipped = os.path.join(REPO, "data", "clip_bpe")

    def digest():
        return {f: hashlib.sha256(open(os.path.join(shipped, f), "rb")
                                  .read()).hexdigest()
                for f in sorted(os.listdir(shipped))}

    before = digest()
    root_tool = _load_root_tool("build_clip_bpe")
    assert build_clip_bpe.build_corpus() == root_tool.build_corpus()
    monkeypatch.setattr(sys, "argv", ["build_clip_bpe.py", "--num-merges",
                                      "64", "--out", str(tmp_path / "root")])
    root_tool.main()
    build_clip_bpe.main(["--num-merges", "64", "--out",
                         str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "merges=64" in out
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "root" / name).read_bytes()
    assert digest() == before


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------


def test_generation_and_clustering_default_to_the_card():
    if torch.cuda.is_available():
        assert C.resolve_device(None) == torch.device("cuda")
        return
    admin, points = _fixture_world()
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerateGeocells(admin, points)
    with pytest.raises(RuntimeError, match="CUDA"):
        Cell("S", "X", "S", points=points["Testland"][:20]).cluster()
    with pytest.raises(RuntimeError, match="CUDA"):
        optics.optics_many([_cloud(10, "blobs", 0)])
