"""The port's geocell manager, its two geocell tools, the polygon labeling
and the ECEF conversions held against the JAX package on the CPU.

Geocell pickles come from the JAX package's ``GenerateGeocells`` over
synthetic admin squares of three countries (as
tests/test_geocell_generation.py makes them), once for the module; both
managers load the same files:

* every ``PointInfo``, ``num_cells``, ``get_geocell_id`` /
  ``get_geocell_index`` on every point and on an unknown one, the
  centroid table and the proto rows (parsed back from both CSVs), all
  equal; loading imports neither the JAX package nor jax;
* ``tools/build_centroid_table.py`` and the port's tool write equal
  arrays; the prototype and member banks of both tools are bitwise equal
  on one embedding SQLite;
* ``geo/polygon.py`` and ``data/preprocessing.py`` give equal outputs;
  ``lla2ecef`` / ``ecef2lla`` agree within 1e-5 relative.
"""

import ast
import csv
import dataclasses
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_tpu.data import preprocessing as jpre
from geoguessr_ai_tpu.data.sqlite_dataset import (
    read_embeddings as jax_read_embeddings,
)
from geoguessr_ai_tpu.geo import core as jcore
from geoguessr_ai_tpu.geo import polygon as jpoly
from geoguessr_ai_tpu.geocells.generate import GenerateGeocells
from geoguessr_ai_tpu.geocells.manager import (
    CentroidTable as JaxCentroidTable,
    GeocellManager as JaxManager,
)

from geoguessr_ai_torch.data import preprocessing as tpre
from geoguessr_ai_torch.data.sqlite_dataset import (
    EMBEDDING_SCHEMA,
    read_embeddings,
)
from geoguessr_ai_torch.geo import core as tcore
from geoguessr_ai_torch.geo import polygon as tpoly
from geoguessr_ai_torch.geocells.manager import CentroidTable, GeocellManager
from geoguessr_ai_torch.tools import build_centroid_table as port_cent_tool
from geoguessr_ai_torch.tools import build_prototype_bank as port_bank_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: A point in no cell.
UNKNOWN = {"latitude": -33.3, "longitude": 151.1}


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


def make_geocell_pickles(out_dir):
    """Three countries' pickles written by the JAX ``GenerateGeocells``:
    Testland (a small admin area merged away, a large one split), Beta and
    Alpha (written in that order, loaded sorted).  Returns the points by
    country."""
    admin = {
        "Testland": {"West": [_square(0, 0)], "East": [_square(10, 0)],
                     "North": [_square(0, 10)]},
        "Beta": {"Only": [_square(40, 40)]},
        "Alpha": {"South": [_square(-60, -30)], "Rest": [_square(-50, -30)]},
    }
    points = {
        "Testland": (_points_in(0, 0, 30, seed=1) + _points_in(10, 0, 3, seed=2)
                     + _points_in(0, 10, 120, seed=3)),
        "Beta": _points_in(40, 40, 25, seed=4),
        "Alpha": _points_in(-60, -30, 18, seed=5) + _points_in(-50, -30, 22,
                                                               seed=6),
    }
    GenerateGeocells(admin, points, min_points=10,
                     max_points=67).generate_geocells(str(out_dir))
    return points


@pytest.fixture(scope="module")
def geocells(tmp_path_factory):
    out = tmp_path_factory.mktemp("geocells")
    points = make_geocell_pickles(out)
    return str(out), points, JaxManager(str(out)), GeocellManager(str(out))


def _all_points(points):
    return [p for pts in points.values() for p in pts]


def test_manager_matches_the_jax_manager(geocells):
    _, points, jm, tm = geocells
    assert tm.num_cells == jm.num_cells == tm.get_num_geocells()
    assert tm.num_cells >= 4
    assert list(tm.point_info) == list(jm.point_info)
    for key, info in jm.point_info.items():
        assert dataclasses.asdict(tm.point_info[key]) == \
            dataclasses.asdict(info)
    assert any(i.cluster_id >= 0 for i in tm.point_info.values())
    for p in _all_points(points) + [UNKNOWN]:
        assert tm.get_geocell_id(p) == jm.get_geocell_id(p)
        assert tm.get_geocell_index(p) == jm.get_geocell_index(p)
    assert tm.get_geocell_id(UNKNOWN) == (None, None, None)
    # a (lat, lng) pair is a point too
    assert tm.get_geocell_index((points["Beta"][0]["latitude"],
                                 points["Beta"][0]["longitude"])) == \
        jm.get_geocell_index(points["Beta"][0])
    for idx, country, key, cell in tm.iter_cells():
        assert tm.get_geocell_info(cell.id, country, key) is cell
    assert tm.get_geocell_info("nope", "Beta", "Only") is None


def _proto_rows(path):
    """A proto CSV's rows with each column parsed to its value."""
    types = {"geocell_index": int, "cluster_id": int, "count": int,
             "centroid_lat": float, "centroid_lng": float,
             "indices": ast.literal_eval}
    with open(path, newline="") as f:
        return [{k: types.get(k, str)(v) for k, v in r.items()}
                for r in csv.DictReader(f)]


def test_centroid_table_and_proto_rows_match(geocells, tmp_path):
    _, _, jm, tm = geocells
    want, got = jm.build_centroid_table(), tm.build_centroid_table()
    np.testing.assert_array_equal(got.centroids, want.centroids)
    assert got.centroids.dtype == np.float32
    for field in ("country", "admin1", "cell_id"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    jdf = jm.generate_proto_df(str(tmp_path / "jax.csv"))
    rows = tm.generate_proto_df(str(tmp_path / "port.csv"))
    assert rows == jdf.to_dict("records")
    assert _proto_rows(tmp_path / "port.csv") == \
        _proto_rows(tmp_path / "jax.csv")
    # from_proto_df: rows (the port) against the DataFrame (JAX)
    a = CentroidTable.from_proto_df(rows)
    b = JaxCentroidTable.from_proto_df(jdf)
    np.testing.assert_array_equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.centroids, want.centroids)
    for field in ("country", "admin1", "cell_id"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_loading_imports_neither_jax_nor_the_jax_package(geocells):
    """The pickles name geoguessr_ai_tpu.geocells.cell.Cell: the port's
    unpickler maps it without importing it (jax and the JAX package
    blocked, then checked absent)."""
    out_dir, _, jm, _ = geocells
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'geoguessr_ai_tpu', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "from geoguessr_ai_torch.geocells.manager import GeocellManager\n"
        f"m = GeocellManager({out_dir!r})\n"
        "cell = m.iter_cells().__next__()[3]\n"
        "assert type(cell).__module__.startswith('geoguessr_ai_torch')\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None and\n"
        "          k.split('.')[0] in ('jax', 'geoguessr_ai_tpu')]\n"
        "assert not loaded, loaded\n"
        "print(m.num_cells, len(m.point_info))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(jm.num_cells), str(len(jm.point_info))]


def _load_root_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"root_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_centroid_table_tool_matches(geocells, tmp_path, monkeypatch,
                                           capsys):
    out_dir = geocells[0]
    jtool = _load_root_tool("build_centroid_table")
    monkeypatch.setattr(sys, "argv", [
        "build_centroid_table.py", "--geocell-dir", out_dir,
        "--out-npz", str(tmp_path / "jax.npz"),
        "--out-csv", str(tmp_path / "jax.csv")])
    jtool.main()
    port_cent_tool.main(["--geocell-dir", out_dir,
                         "--out-npz", str(tmp_path / "port.npz"),
                         "--out-csv", str(tmp_path / "port.csv")])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 6 and [
        line.replace("jax.", "port.") for line in printed[:3]] == printed[3:]
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files) == {"centroids", "country",
                                                "admin1", "cell_id"}
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])
    assert _proto_rows(tmp_path / "port.csv") == \
        _proto_rows(tmp_path / "jax.csv")


def _embedding_sqlite(path, points, D=12, seed=0):
    """An embedding SQLite over most of the cells' points (two to four
    headings each, table order shuffled) and a few points in no cell."""
    rng = np.random.default_rng(seed)
    locs = [(p["latitude"], p["longitude"]) for p in points
            if rng.random() < 0.8]
    locs += [(-33.0 + i * 1e-7, 151.0) for i in range(3)]
    rows = []
    for i, (lat, lon) in enumerate(locs):
        for h in range(int(rng.integers(2, 5))):
            emb = rng.normal(0, 1, D).astype(np.float32)
            rows.append((f"l{i}", lat, lon, h * 90, None, None, None,
                         emb.tobytes(), D))
    rows = [rows[i] for i in rng.permutation(len(rows))]
    conn = sqlite3.connect(path)
    conn.executescript(EMBEDDING_SCHEMA)
    conn.executemany("INSERT INTO samples VALUES (?,?,?,?,?,?,?,?,?)", rows)
    conn.commit()
    conn.close()


def test_bank_functions_are_bitwise_the_jax_tools(geocells, tmp_path):
    _, points, jm, tm = geocells
    db = str(tmp_path / "emb.sqlite")
    _embedding_sqlite(db, _all_points(points))
    jtool = _load_root_tool("build_prototype_bank")
    jdf, rows = jax_read_embeddings(db), read_embeddings(db)
    want = jtool.build_bank_from_manager(jm, jdf, max_protos=3)
    got = port_bank_tool.build_bank_from_manager(tm, rows, max_protos=3)
    assert float(got.mask.sum()) > tm.num_cells
    for k in ("embeddings", "coords", "mask"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for reduce_dim in (5, 64):  # projected, and kept at D
        want = jtool.build_member_bank_from_manager(
            jm, jdf, max_protos=3, max_members=4, reduce_dim=reduce_dim)
        got = port_bank_tool.build_member_bank_from_manager(
            tm, rows, max_protos=3, max_members=4, reduce_dim=reduce_dim)
        for k in ("embeddings", "coords", "mask", "projection"):
            a, b = getattr(got, k), getattr(want, k)
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_build_prototype_bank_main_writes_both_banks(geocells, tmp_path):
    out_dir, points, _, tm = geocells
    db = str(tmp_path / "emb.sqlite")
    _embedding_sqlite(db, _all_points(points), seed=1)
    out = str(tmp_path / "bank.npz")
    port_bank_tool.main(["--embeddings", db, "--geocell-dir", out_dir,
                         "--out", out, "--max-protos", "2",
                         "--max-members", "3", "--reduce-dim", "4"])
    from geoguessr_ai_torch.models.proto_refiner import (
        MemberBank,
        PrototypeBank,
    )

    bank = PrototypeBank.load(out)
    members = MemberBank.load(str(tmp_path / "prototype_member_bank.npz"))
    assert bank.embeddings.shape == (tm.num_cells, 2, 12)
    assert members.embeddings.shape == (tm.num_cells, 2, 3, 4)
    assert members.embeddings.dtype == np.float16


def test_polygon_functions_match():
    rng = np.random.default_rng(0)
    ring = np.array([[0, 0], [4, 0.5], [5, 4], [2, 6], [-1, 3], [0, 0]],
                    np.float64)
    pts = rng.uniform(-2, 7, (500, 2))
    np.testing.assert_array_equal(tpoly.points_in_polygon(pts, ring),
                                  jpoly.points_in_polygon(pts, ring))
    assert tpoly.polygon_area(ring) == jpoly.polygon_area(ring)
    assert tpoly.polygon_bbox(ring) == jpoly.polygon_bbox(ring)
    a = tpoly.sample_points_uniform(ring, 50, np.random.default_rng(3))
    b = jpoly.sample_points_uniform(ring, 50, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)


def test_preprocessing_matches():
    rng = np.random.default_rng(1)
    cells = [[_square(0, 0)], [_square(10, 0), _square(10, 10)],
             [np.array([[30, 30], [35, 30], [32, 36]], np.float64)]]
    lnglat = rng.uniform(-5, 40, (300, 2))
    np.testing.assert_array_equal(tpre.label_points_by_cells(lnglat, cells),
                                  jpre.label_points_by_cells(lnglat, cells))
    cents = rng.uniform(0, 30, (3, 2))
    np.testing.assert_array_equal(
        tpre.label_points_by_cells(lnglat, cells, cents),
        jpre.label_points_by_cells(lnglat, cells, cents))
    boxes = np.array([[0, 0, 10, 10], [5, 5, 20, 20], [30, 30, 40, 40]],
                     np.float64)
    np.testing.assert_array_equal(tpre.label_points_by_bbox(lnglat, boxes),
                                  jpre.label_points_by_bbox(lnglat, boxes))
    heads = rng.uniform(0, 360, (7, 4))
    np.testing.assert_array_equal(tpre.encode_headings(heads),
                                  jpre.encode_headings(heads))
    rows = [{"location_id": f"l{i}", "lat": float(lat), "lon": float(lon)}
            for i, (lon, lat) in enumerate(lnglat[:20])]
    samplers = {"elev": lambda ll: ll[:, 0] * 2 + ll[:, 1],
                "month": lambda ll: (ll[:, 1] > 10).astype(np.int64)}
    got = tpre.attach_aux_labels(rows, samplers)
    want = jpre.attach_aux_labels(pd.DataFrame(rows), samplers)
    assert got == want.to_dict("records")
    assert "elev" not in rows[0]  # the input rows stay as they were
    embs = {f"l{i}": np.full(3, i, np.float32) for i in range(0, 20, 3)}
    got = tpre.attach_embeddings(rows, embs)
    want = jpre.attach_embeddings(pd.DataFrame(rows), embs)
    for a, b in zip(got, want.to_dict("records")):
        assert a.keys() == b.keys()
        if b["embedding"] is None:
            assert a["embedding"] is None
        else:
            np.testing.assert_array_equal(a["embedding"], b["embedding"])


def test_ecef_conversions_match():
    rng = np.random.default_rng(2)
    lnglat = np.stack([rng.uniform(-180, 180, 400),
                       rng.uniform(-89, 89, 400)], -1).astype(np.float32)
    want = np.asarray(jcore.lla2ecef(jnp.asarray(lnglat)))
    got = tcore.lla2ecef(torch.from_numpy(lnglat)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    back_want = np.asarray(jcore.ecef2lla(jnp.asarray(want)))
    back = tcore.ecef2lla(torch.from_numpy(want.copy())).numpy()
    assert np.abs(back - back_want).max() <= 1e-5 * np.abs(back_want).max()
    # and the round trip lands where it started
    assert np.abs(back - lnglat).max() < 1e-3
