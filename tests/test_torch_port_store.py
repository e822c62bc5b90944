"""The port's object-store slice held against the JAX package on the CPU:
content addresses, a bucket written by either package and read by the
other, snapshots and their pointers, the random panorama, the snapshot to
SQLite build, the streaming datasets, the checkpoint registry, the Street
View client, sampling and the collection loop; then ``main_streaming``,
``run_benchmark(clip_checkpoint_index=)`` and the inference fallback on
the port alone.

The buckets are file:// stores in the test's directory.  Both packages'
``time.strftime`` is one fake clock (a fixed date, a new second at each
run timestamp), so both write the same keys.  Nothing is jitted: the JAX
side here is plain Python with pandas.  Equalities are exact unless a test
states its tolerance.
"""

import base64
import hashlib
import json
import os
import sqlite3
import tempfile
import time

import numpy as np
import pandas as pd
import pytest
import torch

from geoguessr_ai_tpu.acquisition import collect as jax_collect
from geoguessr_ai_tpu.acquisition import sampling as jax_sampling
from geoguessr_ai_tpu.acquisition import street_view as jax_sv
from geoguessr_ai_tpu.data import s3 as jax_s3
from geoguessr_ai_tpu.data import streaming as jax_streaming

from geoguessr_ai_torch import inference
from geoguessr_ai_torch import run_benchmark as rb
from geoguessr_ai_torch.acquisition import collect, sampling
from geoguessr_ai_torch.acquisition import street_view as sv
from geoguessr_ai_torch.data import s3, streaming
# imported here, before any test patches coordinator.build_backbone: the
# engine binds that name when it is first imported
from geoguessr_ai_torch.serving import engine as serving
from test_torch_port_train import (
    _same_decoder,
    _tiny_backbone,
    _tiny_table,
)

#: The JAX gate of native against PIL decode (tests/test_data_pipeline.py).
DECODE_MAX_MEAN_DIFF = 4.0
_REAL_STRFTIME = time.strftime


class _Clock:
    """time.strftime: "2026-01-02" for the batch date, and a clock one
    second later than at the last call for the run timestamps; any other
    format (a log line's) as it was."""

    def __init__(self):
        self.n = 0

    def __call__(self, fmt, *t):
        if fmt == "%Y-%m-%d":
            return "2026-01-02"
        if fmt != "%Y%m%dT%H%M%S":
            return _REAL_STRFTIME(fmt, *t)
        self.n += 1
        return _REAL_STRFTIME(fmt, time.gmtime(1767312000 + self.n))


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "strftime", c)
    return c


@pytest.fixture()
def blobs(fixtures_dir):
    return [open(os.path.join(fixtures_dir, f"heading={h:03d}.jpg"),
                 "rb").read() for h in (0, 90, 180, 270)]


def _url(tmp_path, name):
    return f"file://{tmp_path}/{name}"


def _points(n, seed):
    rng = np.random.default_rng(seed)
    # on the 1e-5 grid, so a 2e-8 shift keeps the location_id
    return [(round(float(a), 5), round(float(b), 5))
            for a, b in rng.uniform((-60, -170), (60, 170), (n, 2))]


def _items(points, blobs, headings=(0, 90, 180, 270)):
    return [(lat, lon, h, blobs[k % 4]) for i, (lat, lon) in
            enumerate(points) for k, h in enumerate(headings)]


def _fill(store, blobs):
    """Two training manifests with a snapshot merged after each (the
    second repeats three (location, heading) pairs of the first at a point
    2e-8 degree away, with other bytes, and adds a location), and a holdout
    manifest and snapshot with a two-heading location."""
    pts = _points(6, seed=1)
    first = _items(pts[:5], blobs)
    moved = [(lat + 2e-8, lon, h, blobs[3]) for lat, lon, h, _ in first[4:7]]
    assert all(s3.location_id(a[0], a[1]) == s3.location_id(b[0], b[1])
               for a, b in zip(first[4:7], moved))
    store.write_manifest(store.upload_images(first, threads=4))
    store.merge_snapshot()
    store.write_manifest(store.upload_images(moved + _items(pts[5:], blobs),
                                             threads=4))
    store.merge_snapshot()
    hold = _points(4, seed=2)
    store.write_manifest(store.upload_images(
        _items(hold[:3], blobs) + _items(hold[3:], blobs, (90, 0)),
        threads=4), holdout=True)
    store.merge_snapshot(holdout=True)


@pytest.fixture()
def buckets(tmp_path, clock, blobs):
    """The same writes by the JAX package and by the port, each into its
    own bucket from the same clock."""
    jax_store = jax_s3.ObjectStore(_url(tmp_path, "jax"))
    _fill(jax_store, blobs)
    clock.n = 0
    port_store = s3.ObjectStore(_url(tmp_path, "port"))
    _fill(port_store, blobs)
    return jax_store, port_store


def _normalised(df, base):
    df = df.copy()
    df["image_path"] = df["image_path"].str.replace(base, "BASE", regex=False)
    return df


# ---------------------------------------------------------------------------
# content addresses
# ---------------------------------------------------------------------------


def test_location_id_matches_jax_on_a_grid_and_its_edges():
    rng = np.random.default_rng(0)
    grid = [tuple(map(float, p)) for p in
            rng.uniform((-90, -180), (90, 180), (500, 2))]
    ties = [((2 * k + 1) * 0.5e-7, -(2 * k + 1) * 0.5e-7) for k in range(20)]
    edges = [(90.0, 180.0), (-90.0, -180.0), (90, -180), (-0.0, -0.0),
             (0.0, -0.0), (-0.0, 12.5), (45.00000005, 7.00000015),
             (-45.00000005, -7.00000015), (1e-7, -1e-7)]
    for lat, lon in grid + ties + edges:
        assert s3.location_id(lat, lon) == jax_s3.location_id(lat, lon), (
            lat, lon)
        assert s3.quantize_coord(lat) == jax_s3.quantize_coord(lat)
        assert s3.image_key(s3.location_id(lat, lon), 7) == \
            jax_s3.image_key(jax_s3.location_id(lat, lon), 7)
    assert s3.location_id(-0.0, -0.0) == s3.location_id(0.0, 0.0)
    for lat, lon in ((90.0000001, 0.0), (-90.5, 0.0), (0.0, 180.0000001),
                     (0.0, -181.0), (float("nan"), 0.0)):
        for mod in (s3, jax_s3):
            with pytest.raises(ValueError):
                mod.location_id(lat, lon)


# ---------------------------------------------------------------------------
# a shared bucket
# ---------------------------------------------------------------------------


def test_bucket_keys_and_bytes_are_the_jax_packages(buckets):
    """The same keys (images, manifests, snapshots, pointers), the same
    image bytes and the same pointers but for the base URL."""
    jax_store, port_store = buckets
    keys = jax_store.list("")
    assert keys == port_store.list("") and len(keys) > 30
    for key in keys:
        a, b = jax_store.read_bytes(key), port_store.read_bytes(key)
        if key.endswith(".jpg"):
            assert a == b, key
        elif key.endswith(".json"):
            assert json.loads(a.decode().replace(jax_store.base_url, "B")) \
                == json.loads(b.decode().replace(port_store.base_url, "B"))


@pytest.mark.parametrize("holdout", [False, True])
def test_jax_package_reads_the_port_bucket_as_its_own(buckets, holdout):
    """The JAX package's DataFrame of the port's snapshot and manifests
    equals the one of its own bucket, dtypes and row order included."""
    jax_store, port_store = buckets
    reader = jax_s3.ObjectStore(port_store.base_url)
    got = _normalised(reader.load_latest_snapshot_df(holdout),
                      port_store.base_url)
    want = _normalised(jax_store.load_latest_snapshot_df(holdout),
                       jax_store.base_url)
    pd.testing.assert_frame_equal(got, want)
    prefix = jax_store._manifest_prefix(holdout) + "/"
    pd.testing.assert_frame_equal(
        _normalised(reader.read_parquet_prefix(prefix), port_store.base_url),
        _normalised(jax_store.read_parquet_prefix(prefix),
                    jax_store.base_url))


@pytest.mark.parametrize("holdout", [False, True])
def test_port_reads_the_jax_bucket_as_its_own(buckets, holdout):
    jax_store, port_store = buckets
    reader = s3.ObjectStore(jax_store.base_url)
    got = reader.load_latest_snapshot(holdout)
    want = jax_store.load_latest_snapshot_df(holdout).to_dict("records")
    assert got == want
    assert [{**r, "image_path": r["image_path"].replace(
        port_store.base_url, jax_store.base_url)}
        for r in port_store.load_latest_snapshot(holdout)] == want
    assert [type(v) for v in got[0].values()] == [str, float, float, int,
                                                 str, str]


def test_merge_snapshot_keeps_the_last_duplicate_in_pandas_order(buckets):
    """The second snapshot: the first snapshot, then both manifests, each
    (location_id, heading) at its last row; the moved rows' points and
    bytes win."""
    jax_store, port_store = buckets
    rows = port_store.load_latest_snapshot()
    assert len(rows) == 24
    assert len({(r["location_id"], r["heading"]) for r in rows}) == 24
    manifests = port_store.read_parquet_prefix("v1/manifest/")
    moved = manifests[20:23]
    assert rows[-7:-4] == moved and rows[4]["lat"] != moved[0]["lat"]
    df = jax_store.load_latest_snapshot_df()
    assert df["lat"].tolist() == [r["lat"] for r in rows]
    assert port_store.read_bytes(s3.image_key(moved[0]["location_id"],
                                              moved[0]["heading"])) \
        == jax_store.read_bytes(s3.image_key(moved[0]["location_id"],
                                             moved[0]["heading"]))
    assert s3.drop_duplicate_rows(
        [{"a": 1, "b": 0}, {"a": 2, "b": 0}, {"a": 1, "b": 1}], ["a"]) == [
        {"a": 2, "b": 0}, {"a": 1, "b": 1}]


def test_foreign_and_legacy_pointers_resolve_in_both_packages(buckets):
    """A pointer another stack wrote (s3://<bucket>/<prefix>/) and a
    legacy {"key": ...} pointer read the same rows as the store's own."""
    jax_store, port_store = buckets
    want = port_store.load_latest_snapshot()
    pointer_key = "v1/snapshot/_latest.json"
    prefix = port_store.read_json(pointer_key)["s3"][
        len(port_store.base_url) + 1:]
    for pointer in ({"s3": f"s3://cogito-geoguessr/{prefix}"},
                    {"key": prefix + "part-0.parquet"}):
        port_store.write_json(pointer_key, pointer)
        assert port_store.load_latest_snapshot() == want
        df = jax_s3.ObjectStore(port_store.base_url).load_latest_snapshot_df()
        assert df.to_dict("records") == want
    with pytest.raises(FileNotFoundError):
        s3.ObjectStore(port_store.base_url + "/none").load_latest_snapshot()


def test_ingest_local_folder_matches_jax(tmp_path, clock, blobs):
    src = tmp_path / "imgs"
    src.mkdir()
    for (lat, lon), b in zip(_points(3, seed=4), blobs):
        for h in (0, 90, 180, 270):
            (src / f"streetview_{lat}_{lon}_heading_{h}.jpg").write_bytes(b)
    (src / "notes.txt").write_text("skipped")
    (src / "streetview_1.0_2.0_heading_1234.jpg").write_bytes(blobs[0])
    stores = []
    for mod, name in ((jax_s3, "jax"), (s3, "port")):
        clock.n = 0
        store = mod.ObjectStore(_url(tmp_path, name))
        assert store.ingest_local_folder(str(src), threads=2,
                                         holdout=True) == 12
        empty = tmp_path / "no_images"
        empty.mkdir(exist_ok=True)
        assert store.ingest_local_folder(str(empty), threads=2) == 0
        stores.append(store)
    a, b = stores
    assert a.list("") == b.list("")
    assert b.read_parquet(b.list("holdout_dataset/manifest/")[0]) == [
        {**r, "image_path": r["image_path"].replace(a.base_url, b.base_url)}
        for r in a.read_parquet(a.list("holdout_dataset/manifest/")[0])
        .to_dict("records")]


# ---------------------------------------------------------------------------
# what the store serves
# ---------------------------------------------------------------------------


def test_download_random_panorama_matches_jax(tmp_path, clock, blobs):
    """Four-heading groups in location_id order, the draw of
    default_rng(seed), heading=XXX.jpg files, and the point of the group's
    first snapshot row (a location whose rows came in heading order 180,
    0, 90, 270, its 180 row at a point 2e-8 degree away)."""
    store = s3.ObjectStore(_url(tmp_path, "b"))
    pts = _points(6, seed=5)
    lat, lon = pts[0]
    odd = [(lat + 2e-8, lon, 180, blobs[2])] + [
        (lat, lon, h, blobs[k]) for k, h in ((0, 0), (1, 90), (3, 270))]
    store.write_manifest(store.upload_images(
        odd + _items(pts[1:5], blobs) + _items(pts[5:], blobs, (0, 90, 180)),
        threads=4), holdout=True)
    store.merge_snapshot(holdout=True)
    jax_store = jax_s3.ObjectStore(store.base_url)
    seen = set()
    for seed in range(32):
        p, la, lo = store.download_random_panorama(str(tmp_path / "p"),
                                                   seed=seed)
        q, jla, jlo = jax_store.download_random_panorama(str(tmp_path / "q"),
                                                         seed=seed)
        assert (la, lo) == (jla, jlo)
        assert [os.path.basename(x) for x in p] == [
            os.path.basename(x) for x in q] == [
            f"heading={h:03d}.jpg" for h in (0, 90, 180, 270)]
        for x, y in zip(p, q):
            assert open(x, "rb").read() == open(y, "rb").read()
        seen.add(la)
    assert lat + 2e-8 in seen and len(seen) == 5


def test_build_sqlite_from_snapshot_writes_the_jax_rows(buckets, tmp_path):
    jax_store, port_store = buckets
    tel = []
    a, b = str(tmp_path / "jax.sqlite"), str(tmp_path / "port.sqlite")
    assert jax_store.build_sqlite_from_snapshot(a, fetch_threads=4,
                                                window=7) == 24
    assert port_store.build_sqlite_from_snapshot(
        b, fetch_threads=4, window=7, publish=True, log_fn=tel.append) == 24
    rows = []
    for path in (a, b):
        conn = sqlite3.connect(path)
        rows.append(conn.execute(
            "SELECT * FROM samples ORDER BY location_id, heading").fetchall())
        conn.close()
    assert rows[0] == rows[1] and len(rows[0]) == 24
    assert [t["processed"] for t in tel] == [7, 14, 21, 24]
    dl = jax_s3.ObjectStore(port_store.base_url).download_latest_sqlite(
        "raw", str(tmp_path / "dl.sqlite"))
    assert open(dl, "rb").read() == open(b, "rb").read()
    # an image that fails to fetch is left out on both sides
    key = s3.image_key(rows[0][0][0], rows[0][0][3])
    for store in (jax_store, port_store):
        store.fs.rm(store._p(key))
    assert jax_store.build_sqlite_from_snapshot(
        str(tmp_path / "j2.sqlite"), fetch_threads=2) == 23
    assert port_store.build_sqlite_from_snapshot(
        str(tmp_path / "p2.sqlite"), fetch_threads=2) == 23


def test_snapshot_panorama_table_matches_jax(buckets, tmp_path):
    _, port_store = buckets
    jax_store = jax_s3.ObjectStore(port_store.base_url)
    for holdout in (False, True):
        table, fetch = streaming.snapshot_panorama_table(
            port_store, holdout, cache_dir=str(tmp_path / "pc"))
        df, jax_fetch = jax_streaming.snapshot_panorama_table(
            jax_store, holdout, cache_dir=str(tmp_path / "jc"))
        assert [p._asdict() for p in table] == df.to_dict("records")
        assert len({len(p.images) for p in table}) == (2 if holdout else 1)
        for p in table:
            for key in p.images:
                assert fetch(key) == jax_fetch(key) == port_store.read_bytes(
                    key)
    assert sorted(os.listdir(tmp_path / "pc")) == sorted(
        os.listdir(tmp_path / "jc"))


# ---------------------------------------------------------------------------
# the streaming datasets
# ---------------------------------------------------------------------------


@pytest.fixture()
def stream_store(tmp_path, clock, blobs):
    """Five locations (one of two headings), one image deleted, one
    corrupt."""
    store = s3.ObjectStore(_url(tmp_path, "s"))
    pts = _points(5, seed=6)
    store.write_manifest(store.upload_images(
        _items(pts[:4], blobs) + _items(pts[4:], blobs, (0, 90)), threads=4))
    store.merge_snapshot()
    rows = store.load_latest_snapshot()
    store.fs.rm(store._p(s3.image_key(rows[1]["location_id"],
                                      rows[1]["heading"])))
    store.write_bytes(s3.image_key(rows[6]["location_id"], rows[6]["heading"]),
                      b"not a jpeg")
    return store


@pytest.mark.parametrize("decoders", ["same", "port_pil"])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_streams_match_jax(stream_store, tmp_path, monkeypatch, decoders,
                           num_shards):
    """GeoImageStream and PanoramaStream against the JAX ones over every
    shard: the same targets, lengths and black placeholders; pixels bitwise
    where both packages decode alike ("same": both native or both PIL),
    within DECODE_MAX_MEAN_DIFF mean levels where the port decodes by PIL
    and the JAX package by its default."""
    from geoguessr_ai_tpu.data.native import jpeg as jax_jpeg

    from geoguessr_ai_torch.data import pipeline

    if decoders == "same":
        _same_decoder(monkeypatch, jax_streaming, streaming)
    else:
        monkeypatch.setattr(streaming, "decode_jpeg", pipeline._pil_decode)
    exact = decoders == "same" or not jax_jpeg.available()
    jax_store = jax_s3.ObjectStore(stream_store.base_url)
    totals = {"image": 0, "pano": 0}
    for shard in range(num_shards):
        kw = dict(shard=shard, num_shards=num_shards)
        for kind, port_cls, jax_cls in (
                ("image", streaming.GeoImageStream,
                 jax_streaming.GeoImageStream),
                ("pano", streaming.PanoramaStream,
                 jax_streaming.PanoramaStream)):
            ours = port_cls(stream_store, 48,
                            cache_dir=str(tmp_path / f"p{shard}"), **kw)
            theirs = jax_cls(jax_store, 48,
                             cache_dir=str(tmp_path / f"j{shard}"), **kw)
            got, want = list(ours), list(theirs)
            assert len(ours) == len(got) == len(want)
            totals[kind] += len(got)
            for (a, ta), (b, tb) in zip(got, want):
                assert ta == tb
                if exact:
                    np.testing.assert_array_equal(a, b)
                else:
                    assert np.abs(a.astype(np.int16) - b).mean() < \
                        DECODE_MAX_MEAN_DIFF
                # a missing or corrupt view is black on both sides
                black = a.reshape(-1, 48 * 48 * 3).max(axis=1) == 0
                assert (black == (b.reshape(-1, 48 * 48 * 3).max(axis=1)
                                  == 0)).all()
    assert totals == {"image": 18, "pano": 4}
    black_views = sum(int((v.reshape(-1, 48 * 48 * 3).max(axis=1) == 0).sum())
                      for v, _ in streaming.PanoramaStream(
                          stream_store, 48, cache_dir=str(tmp_path / "c")))
    assert black_views == 2
    # the cache: one file a fetched key (the corrupt one too), none for
    # the missing key; the JAX package's file names
    assert len(os.listdir(tmp_path / "c")) == 15
    assert sorted(os.listdir(tmp_path / "p0")) == sorted(
        os.listdir(tmp_path / "j0"))


def test_streams_shard_by_the_process_group(stream_store, tmp_path,
                                            monkeypatch):
    """Without an explicit shard the rank and world size of an initialised
    torch.distributed group pick it (the JAX package reads the process
    index); with none, one shard."""
    import torch.distributed as dist

    whole = streaming.PanoramaStream(stream_store, 16,
                                     cache_dir=str(tmp_path / "c"))
    assert (whole.shard, whole.num_shards, len(whole)) == (0, 1, 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    for cls, n in ((streaming.PanoramaStream, 1),
                   (streaming.GeoImageStream, 6)):
        s = cls(stream_store, 16, cache_dir=str(tmp_path / "c"))
        assert (s.shard, s.num_shards, len(s), len(list(s))) == (1, 3, n, n)


# ---------------------------------------------------------------------------
# the checkpoint registry
# ---------------------------------------------------------------------------


def _checkpoint_dirs(tmp_path):
    out = []
    for i in range(2):
        d = tmp_path / f"ckpt{i}"
        (d / "sub").mkdir(parents=True)
        (d / "state.pt").write_bytes(bytes([i]) * 64)
        (d / "sub" / "meta.json").write_text(json.dumps({"i": i}))
        out.append(str(d))
    return out


def test_registry_round_trip_and_order_match_jax(tmp_path, clock,
                                                 fixtures_dir):
    """Uploads of a file and two directories (newest first in the list;
    index 0 the newest, 1 the one before, past the end the oldest), the
    downloaded files equal to what went up; the JAX package lists and
    downloads the port's registry alike."""
    store = s3.ObjectStore(_url(tmp_path, "reg"))
    with pytest.raises(FileNotFoundError):
        store.download_model_checkpoint(str(tmp_path / "none"))
    single = os.path.join(fixtures_dir, "heading=000.jpg")
    dirs = _checkpoint_dirs(tmp_path)
    bases = [store.upload_model_checkpoint(p) for p in [single] + dirs]
    runs = store.list_model_checkpoints()
    assert runs == [b.split("/")[-1] for b in reversed(bases)]
    assert store.read_json("v1/saved_models/_latest.json") == {
        "run_ts": runs[0][len("run_ts="):], "key": bases[-1]}
    jax_store = jax_s3.ObjectStore(store.base_url)
    assert jax_store.list_model_checkpoints() == runs
    for n, src in ((0, dirs[1]), (1, dirs[0]), (2, None), (9, None)):
        out = store.download_model_checkpoint(str(tmp_path / f"o{n}"), n)
        jout = jax_store.download_model_checkpoint(str(tmp_path / f"j{n}"), n)
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        assert files == sorted(os.path.relpath(os.path.join(d, f), jout)
                               for d, _, fs in os.walk(jout) for f in fs)
        if src is None:
            assert files == ["heading=000.jpg"]
            assert open(os.path.join(out, files[0]), "rb").read() == open(
                single, "rb").read()
        else:
            assert files == ["state.pt", os.path.join("sub", "meta.json")]
            for f in files:
                assert open(os.path.join(out, f), "rb").read() == open(
                    os.path.join(src, f), "rb").read()


def test_upload_checkpoint_tool_publishes_to_the_store(tmp_path, clock,
                                                       capsys):
    from geoguessr_ai_torch.tools import upload_checkpoint

    d = _checkpoint_dirs(tmp_path)[0]
    url = _url(tmp_path, "tool")
    upload_checkpoint.main([d, "--store-url", url])
    key = capsys.readouterr().out.strip()
    assert key == "v1/saved_models/run_ts=20260102T000001"
    assert s3.ObjectStore(url).list_model_checkpoints() == [key.split("/")[-1]]


def test_default_store_is_the_bucket_and_needs_s3fs(tmp_path, monkeypatch):
    """No URL and no GEO_TPU_STORE_URL: s3://{S3_BUCKET} (the JAX
    package's bucket), which raises fsspec's ImportError without s3fs;
    nothing falls back to a local store."""
    from geoguessr_ai_tpu import config as JC

    from geoguessr_ai_torch import config as C

    assert C.S3_BUCKET == JC.S3_BUCKET == os.environ.get(
        "GEO_TPU_S3_BUCKET", "cogito-geoguessr")
    monkeypatch.delenv("GEO_TPU_STORE_URL", raising=False)
    pytest.importorskip("fsspec")
    try:
        import s3fs  # noqa: F401
        pytest.skip("s3fs is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="s3fs"):
        s3.ObjectStore()
    with pytest.raises(ImportError, match="s3fs"):
        s3.download_nth_model_checkpoint(0, str(tmp_path / "x"))
    monkeypatch.setenv("GEO_TPU_STORE_URL", _url(tmp_path, "env") + "/")
    assert s3.ObjectStore().base_url == _url(tmp_path, "env")


# ---------------------------------------------------------------------------
# acquisition
# ---------------------------------------------------------------------------


def test_street_view_urls_and_signatures_match_jax():
    secret = base64.urlsafe_b64encode(bytes(range(20))).decode()
    for lat, lon, heading in ((59.9139, 10.7522, 0.0), (-33.5, 151.25, 271.5),
                              (0.0, -0.0, 359.96)):
        for sec in (None, secret):
            assert sv.build_image_url(lat, lon, heading, "KEY", sec) == \
                jax_sv.build_image_url(lat, lon, heading, "KEY", sec)
            assert sv.build_metadata_url(lat, lon, "KEY", sec) == \
                jax_sv.build_metadata_url(lat, lon, "KEY", sec)
        url = sv.build_image_url(lat, lon, heading, "K", size="320x320",
                                 fov=60)
        assert sv.sign_url(url, secret) == jax_sv.sign_url(url, secret)
    for seed in (0.0, 12.5, 300.0, 359.9):
        assert sv.heading_block(seed) == jax_sv.heading_block(seed)


class _Response:
    def __init__(self, status, body=None, content=b""):
        self.status_code, self.ok = status, 200 <= status < 300
        self._body, self.content = body, content

    def json(self):
        return self._body


class _Session:
    """Answers GETs from a script: a list of responses per URL kind."""

    def __init__(self, meta, images):
        self.script = {"metadata": list(meta), "image": list(images)}
        self.urls = []

    def get(self, url, timeout=None):
        self.urls.append(url)
        return self.script["metadata" if "/metadata?" in url else "image"
                           ].pop(0)


@pytest.mark.parametrize("case", ["ok", "no_imagery", "retry", "meta_403",
                                  "image_403", "image_500"])
def test_fetch_block_matches_jax(case, monkeypatch):
    ok = _Response(200, {"status": "OK", "pano_id": "p", "date": "2020-01"})
    img = [_Response(200, content=bytes([k]) * 8) for k in range(4)]
    meta, images = {
        "ok": ([ok], img),
        "no_imagery": ([_Response(200, {"status": "ZERO_RESULTS"})], []),
        "retry": ([_Response(500), ok], img),
        "meta_403": ([_Response(403)], []),
        "image_403": ([ok], img[:2] + [_Response(403)]),
        "image_500": ([ok], img[:1] + [_Response(500)] + img[2:]),
    }[case]
    for mod in (sv, jax_sv):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    out = []
    for mod in (sv, jax_sv):
        session = _Session(meta, images)
        try:
            got = mod.fetch_block(1.5, 2.5, "KEY", yaw_seed=30.0,
                                  session=session)
        except mod.RateLimitError as e:
            got = ("403", str(e))
        out.append((got, session.urls))
    assert out[0] == out[1]
    assert out[0][0][0] == ("403" if case.endswith("403") else {}
                            if case == "no_imagery" else ok.json())


def _polygons():
    return [np.array([[10.0, 50.0], [12.0, 50.0], [12.0, 52.0], [10.0, 52.0]]),
            np.array([[-5.0, 40.0], [-1.0, 40.0], [-3.0, 43.0]])]


def test_sampling_matches_jax(monkeypatch):
    polys = _polygons()
    for n, density in ((200, 1.0), (50, 0.5), (0, 1.0)):
        a = sampling.sample_points_in_polygons(
            polys, n, density, np.random.default_rng(7))
        b = jax_sampling.sample_points_in_polygons(
            polys, n, density, np.random.default_rng(7))
        np.testing.assert_array_equal(a, b)
    assert sampling.sample_points_in_polygons([], 5).shape == (0, 2)
    pts = np.array([[1.0, 2.0], [1.0000004, 2.0], [1.0, 2.0000006], [3.0, 4.0],
                    [1.0, 2.0]])
    np.testing.assert_array_equal(sampling.dedupe_points(pts),
                                  jax_sampling.dedupe_points(pts))
    assert len(sampling.dedupe_points(pts)) == 3

    def validator(lat, lon):
        if lat > 51.5:
            raise RuntimeError("down")
        return lon > 11.0

    pts = sampling.sample_points_in_polygons(polys, 64,
                                             rng=np.random.default_rng(3))
    np.testing.assert_array_equal(
        sampling.validate_points(pts, validator, threads=3),
        jax_sampling.validate_points(pts, validator, threads=3))
    monkeypatch.setattr(sv, "fetch_metadata",
                        lambda lat, lon, *a, **k: {} if lat > 45 else None)
    monkeypatch.setattr(jax_sv, "fetch_metadata",
                        lambda lat, lon, *a, **k: {} if lat > 45 else None)
    for key in (None, "KEY"):
        a = sampling.sample_sv_points_from_polygons(
            polys, 40, key, rng=np.random.default_rng(9), threads=2)
        b = jax_sampling.sample_sv_points_from_polygons(
            polys, 40, key, rng=np.random.default_rng(9), threads=2)
        np.testing.assert_array_equal(a, b)
        assert (a[:, 1] > 45).all() == bool(key)


def test_ledger_remaining_matches_jax(tmp_path):
    pts = np.array([[10.1234567, 50.7654321], [11.0, 51.0],
                    [12.123456789, 52.987654321], [13.0, 53.0]])
    for i, mod in enumerate((sampling, jax_sampling)):
        ledger = mod.CollectionLedger(str(tmp_path / f"c{i}.txt"),
                                      str(tmp_path / f"f{i}.txt"))
        np.testing.assert_array_equal(ledger.remaining(pts), pts)
        ledger.record(50.765432, 10.123457, ok=True)  # rounded to 6
        ledger.record(52.987654321, 12.123456789, ok=False)  # exact
    for i in range(2):
        assert (tmp_path / f"c{i}.txt").read_text() == "50.765432,10.123457\n"
    a = sampling.CollectionLedger(str(tmp_path / "c0.txt"),
                                  str(tmp_path / "f0.txt")).remaining(pts)
    b = jax_sampling.CollectionLedger(str(tmp_path / "c1.txt"),
                                      str(tmp_path / "f1.txt")).remaining(pts)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, pts[[1, 3]])


def _fake_fetch(blobs, error, fail_lats=(), limit_lats=()):
    def fetch(lat, lon, api_key, secret=None, yaw_seed=0.0, session=None):
        if lat in limit_lats:
            raise error("403")
        if lat in fail_lats:
            return {}, []
        return {"status": "OK"}, [((yaw_seed + k * 90.0) % 360.0, blobs[k])
                                  for k in range(4)]

    return fetch


def test_collect_points_leaves_the_jax_store_and_ledger(tmp_path, clock,
                                                        blobs):
    """Seven points, batch_size 2, one failing and the sixth rate-limited:
    both raise after flushing, with the same images, manifests and ledger
    files; a second run over the same points collects only the rest."""
    pts = np.array([[lon, lat] for lat, lon in _points(7, seed=8)])
    fail, limit = pts[2, 1], pts[5, 1]
    stores, results = [], []
    for mod, smod, svmod, name in ((jax_collect, jax_s3, jax_sv, "jax"),
                                   (collect, s3, sv, "port")):
        clock.n = 0
        store = smod.ObjectStore(_url(tmp_path, name))
        ledger = mod.CollectionLedger(str(tmp_path / f"{name}_ok.txt"),
                                      str(tmp_path / f"{name}_bad.txt"))
        with pytest.raises(svmod.RateLimitError):
            mod.collect_points(pts, store, "KEY", ledger=ledger, batch_size=2,
                               seed=3, fetch_fn=_fake_fetch(
                                   blobs, svmod.RateLimitError, (fail,),
                                   (limit,)))
        results.append(mod.collect_points(
            pts, store, "KEY", ledger=ledger, batch_size=2, seed=4,
            fetch_fn=_fake_fetch(blobs, svmod.RateLimitError, (fail,))))
        stores.append(store)
    assert results[0] == results[1] == {"collected": 2, "failed": 0,
                                        "batches": 1}
    a, b = stores
    keys = a.list("")
    assert keys == b.list("") and len([k for k in keys
                                       if k.endswith(".parquet")]) == 3
    for key in keys:
        if key.endswith(".jpg"):
            assert a.read_bytes(key) == b.read_bytes(key)
        else:
            assert b.read_parquet(key) == [
                {**r, "image_path": r["image_path"].replace(a.base_url,
                                                            b.base_url)}
                for r in a.read_parquet(key).to_dict("records")]
    for kind in ("ok", "bad"):
        assert (tmp_path / f"jax_{kind}.txt").read_text() == (
            tmp_path / f"port_{kind}.txt").read_text()
    assert len((tmp_path / "port_ok.txt").read_text().splitlines()) == 6
    assert len((tmp_path / "port_bad.txt").read_text().splitlines()) == 1


# ---------------------------------------------------------------------------
# the port's entry points on the store
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self, *a, **k):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    def summary(self, key, value):
        pass

    def finish(self):
        pass

    def losses(self):
        return [m["train/loss"] for _, m in self.rows if "train/loss" in m]


def _train_store(tmp_path, blobs, n_train, n_holdout):
    store = s3.ObjectStore(_url(tmp_path, "train"))
    pts = _points(n_train + n_holdout, seed=9)
    items = _items(pts[:n_train], blobs)
    store.write_manifest(store.upload_images(items[:-1], threads=4))
    store.merge_snapshot()
    if n_holdout:
        store.write_manifest(store.upload_images(
            _items(pts[n_train:], blobs), threads=4), holdout=True)
        store.merge_snapshot(holdout=True)
    return store


def _cfg(**fields):
    from geoguessr_ai_torch import config as C

    return C.TrainConfig(
        model=C.ModelConfig(backbone=C.BackboneConfig(image_size=64,
                                                      embed_dim=80)),
        **{"batch_size": 4, "num_epochs": 1, "log_every_steps": 1, "seed": 0,
           **fields})


@pytest.fixture()
def on_the_store(tmp_path, clock, monkeypatch):
    """The port's entry points at test_tiny widths on a file:// store
    (GEO_TPU_STORE_URL), checkpoints and the fetch cache in the test's
    directory."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.train import coordinator

    _tiny_backbone(monkeypatch)
    monkeypatch.setenv("GEO_TPU_STORE_URL", _url(tmp_path, "train"))
    monkeypatch.setattr(C, "CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(C, "CENTROID_TABLE_PATH", str(tmp_path / "t.npz"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tempfile.tempdir)
    _tiny_table().save(str(tmp_path / "t.npz"))
    monkeypatch.chdir(tmp_path)
    recorders = []
    monkeypatch.setattr(coordinator, "MetricsLogger",
                        lambda **kw: recorders.append(_Recorder()) or
                        recorders[-1])
    return recorders


def test_main_streaming_trains_as_train_on_the_built_sqlite(
        on_the_store, tmp_path, blobs):
    """main_streaming on 8 training panoramas (one of three views) and 4
    holdout ones, 2 steps of 4: the step losses and the validation loss
    bitwise those of train() on the SQLites that build_sqlite_from_snapshot
    builds from the same snapshots; last and best under CHECKPOINT_DIR;
    the fetch cache one file a key of both snapshots."""
    from geoguessr_ai_torch.data.sqlite_dataset import (
        load_sqlite_panorama_dataset,
    )
    from geoguessr_ai_torch.train import coordinator

    store = _train_store(tmp_path, blobs, 8, 4)
    summary = coordinator.main_streaming(_cfg(), device="cpu")
    streamed = on_the_store[-1].losses()
    dbs = [str(tmp_path / f"{n}.sqlite") for n in ("train", "hold")]
    for db, holdout in zip(dbs, (False, True)):
        store.build_sqlite_from_snapshot(db, holdout=holdout, fetch_threads=2)
    direct = coordinator.train(
        _cfg(), load_sqlite_panorama_dataset(dbs[0]),
        load_sqlite_panorama_dataset(dbs[1]), _tiny_table(),
        checkpoint_dir=str(tmp_path / "direct"), device="cpu")
    assert len(streamed) == 2 and streamed == on_the_store[-1].losses()
    assert summary["val_loss"] == direct["val_loss"]
    assert np.isfinite(summary["val_loss"])
    names = os.listdir(tmp_path / "ckpt")
    assert {"last", "best"} <= set(names)
    keys = [s3.image_key(r["location_id"], r["heading"])
            for h in (False, True) for r in store.load_latest_snapshot(h)]
    assert sorted(os.listdir(tmp_path / ".s3cache")) == sorted(
        hashlib.sha1(k.encode()).hexdigest() for k in keys)
    assert len(keys) == 47


def test_main_streaming_splits_nine_tenths_without_a_holdout(
        on_the_store, tmp_path, blobs, monkeypatch):
    """No holdout snapshot: the first int(0.9 n) panoramas train and the
    rest validate whatever cfg.val_fraction says; the fetch function and
    CHECKPOINT_DIR go to train()."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.train import coordinator

    _train_store(tmp_path, blobs, 10, 0)
    calls = []
    monkeypatch.setattr(coordinator, "train",
                        lambda *a, **k: calls.append((a, k)) or {})
    cfg = _cfg(val_fraction=0.5)
    coordinator.main_streaming(cfg, device="cpu")
    (args, kw), = calls
    got_cfg, pano_train, pano_val, table = args
    assert got_cfg is cfg and len(pano_train) == 9 and len(pano_val) == 1
    assert [p.location_id for p in pano_train + pano_val] == sorted(
        p.location_id for p in pano_train + pano_val)
    assert kw["checkpoint_dir"] == C.CHECKPOINT_DIR
    assert kw["device"] == "cpu" and table.num_cells == 8
    blob = kw["fetch_fn"](pano_val[0].images[0])
    assert blob in blobs


def test_run_benchmark_serves_the_registry_checkpoint(on_the_store, tmp_path,
                                                      blobs, monkeypatch,
                                                      fixtures_dir):
    """A store directory (<run>/best) uploaded to the registry:
    run_benchmark(clip_checkpoint_index=0) gives the records of
    run_benchmark(checkpoint=<run>/best); with a newer upload, index 1
    serves the older one again."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.train.checkpoints import (
        CheckpointConfig,
        CheckpointStore,
    )
    from geoguessr_ai_torch.train.state import create_train_state
    from test_torch_port_train_loop import _fixture_sqlite, _tiny_engine

    table = _tiny_table()
    for i, seed in enumerate((3, 4)):
        model = _tiny_engine(table, seed=seed).model.float()
        state = create_train_state(model, OptimizerConfig(), 1)
        CheckpointStore(CheckpointConfig(str(tmp_path / f"run{i}"))
                        ).save_epoch(state, 0, 1.0, None,
                                     extra={"global_step": 1})
    db = str(tmp_path / "d.sqlite")
    _fixture_sqlite(db, fixtures_dir, 30)
    built, engine_cls = [], serving.ServingEngine
    # test_torch_port_train_loop._tiny_engine's TinyViT
    tiny = TinyViTConfig(image_size=64, embed_dims=(16, 32, 64, 80),
                         depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 5),
                         window_sizes=(2, 2, 4, 2), dtype=torch.float32)

    def tiny_engine(**kw):
        built.append(kw)
        return engine_cls(centroid_table=table, device="cpu",
                          backbone_config=tiny, checkpoint=kw["checkpoint"])

    monkeypatch.setattr(serving, "ServingEngine", tiny_engine)
    store = s3.ObjectStore()

    def bench(**kw):
        out = str(tmp_path / f"out{len(built)}.json")
        rb.run_benchmark(num_samples=3, sqlite_path=db, output_path=out,
                         batch_size=2, device="cpu", **kw)
        return json.load(open(out))

    best0 = str(tmp_path / "run0" / "best")
    store.upload_model_checkpoint(best0)
    want = bench(checkpoint=best0)
    assert bench(clip_checkpoint_index=0) == want
    downloaded = built[-1]["checkpoint"]
    assert downloaded == os.path.join(tempfile.tempdir, "geo_tpu_ckpt")
    assert open(os.path.join(downloaded, "state.pt"), "rb").read() == open(
        os.path.join(best0, "state.pt"), "rb").read()
    store.upload_model_checkpoint(str(tmp_path / "run1" / "best"))
    other = bench(clip_checkpoint_index=0)
    assert other != want
    assert other == bench(checkpoint=str(tmp_path / "run1" / "best"))
    assert bench(clip_checkpoint_index=1) == want


def test_inference_falls_back_to_a_random_store_panorama(
        on_the_store, tmp_path, blobs, monkeypatch, capsys):
    """No images and no fixture panorama: a random holdout panorama of
    the store, downloaded into the temp directory, is what is served."""

    store = _train_store(tmp_path, blobs, 2, 1)
    served = []
    monkeypatch.setattr(inference, "fixture_panorama", lambda: [])
    monkeypatch.setattr(inference, "run_inference",
                        lambda paths, **kw: served.append(paths) or (
                            1.0, 2.0, [0], [1.0]))
    inference.main(["--device", "cpu"])
    assert capsys.readouterr().out.split() == ["1.000000", "2.000000"]
    paths, = served
    assert paths == [os.path.join(tempfile.tempdir, "geo_tpu_pano",
                                  f"heading={h:03d}.jpg")
                     for h in (0, 90, 180, 270)]
    loc = store.load_latest_snapshot(holdout=True)[0]["location_id"]
    for p, h in zip(paths, (0, 90, 180, 270)):
        assert open(p, "rb").read() == store.read_bytes(s3.image_key(loc, h))
    # given images, or the fixture, the store is not asked
    monkeypatch.delenv("GEO_TPU_STORE_URL")
    inference.main(["--device", "cpu", paths[0]])
    assert served[-1] == [paths[0]]
