"""The PyTorch port's guess path as a whole, held against the JAX package.

A narrow TinyViT at image_size 512 with the default windows engages every
attention kernel branch of the default config on the JAX side (stage 1:
N=256 fused block, stage 2: N=1024 no-proj fused block, stage 3: N=256
qkv kernel).  Its flax variables go across with ``from_jax_variables``
into the port's ``ServingEngine`` on the CPU; the four fixture views,
decoded once by the port, go through both, in f32.  Also here: the
MicroBatcher, the CLI, the device rule and the import rule.
"""

import ast
import glob
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NARROW = dict(image_size=512, embed_dims=(32, 64, 64, 96), depths=(1, 1, 1, 1),
              num_heads=(1, 2, 2, 3))


def _randomise(variables, seed=0):
    """Seeded random values for the leaves flax initialises to constants
    (biases, norm scales, attention biases, BN statistics)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v)
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.normal(1.0, 0.1, v.shape).astype(np.float32)
        if "'kernel'" in name and "cell_layer" not in name:
            return v
        if "'kernel'" in name:  # the cell layer: spread its logits out
            return rng.normal(0, 0.3, v.shape).astype(np.float32)
        return rng.normal(0, 0.1, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def slice_pair(fixtures_dir):
    """(jax outputs, port engine, decoded views) for the narrow model."""
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models.super_guessr import (
        decode_predictions as jax_decode,
    )
    from geoguessr_ai_tpu.models.tinyvit import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.models.tinyvit import TinyViTConfig as JaxConfig
    from geoguessr_ai_tpu.ops.preprocess import fused_preprocess as jax_pre

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.models.convert import from_jax_variables
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    jcfg = JaxConfig(dtype=jnp.float32, **NARROW)
    model = JaxSuperGuessr(num_cells=table.num_cells,
                           backbone=JaxTinyViT(jcfg), panorama=True,
                           embed_dim=jcfg.embed_dim)
    dummy = jnp.zeros((1, 4, 512, 512, 3), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), dummy)
    variables = _randomise(jax.tree_util.tree_map(np.asarray, variables))

    paths = sorted(glob.glob(os.path.join(fixtures_dir, "heading=*.jpg")))
    views = np.stack([decode_jpeg(open(p, "rb").read(), 512) for p in paths])

    @jax.jit
    def serve(variables, u8, centroids):
        pixels = jax_pre(u8, C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD, 512,
                         dtype=jnp.float32)
        emb, logits = model.apply(variables, pixel_values=pixels)
        _, _, lnglat, top = jax_decode(logits, centroids, 5)
        return emb, lnglat, top.values, top.indices

    want = [np.asarray(a) for a in serve(variables, jnp.asarray(views[None]),
                                         jnp.asarray(table.centroids))]
    engine = ServingEngine(
        device="cpu", centroid_table=table,
        state_dict=from_jax_variables(variables),
        backbone_config=TinyViTConfig(dtype=torch.float32, **NARROW))
    return want, engine, views, paths


def test_slice_matches_jax_on_the_fixture_panorama(slice_pair, monkeypatch):
    from geoguessr_ai_torch.ops import window_attention as wa

    (emb, lnglat, top_vals, top_idx), engine, views, _ = slice_pair
    calls = []
    for op in ("fused_block_attention", "fused_block_attention_noproj",
               "window_attention_qkv"):
        real = getattr(wa, op)
        monkeypatch.setattr(wa, op, lambda *a, _r=real, _n=op, **k: (
            calls.append(_n), _r(*a, **k))[1])
    got = engine.predict_batch(views[None])[0]
    # stage 1 -> K1's op, stage 2 -> K2's, stage 3 -> K3's, once each
    assert calls == ["fused_block_attention", "fused_block_attention_noproj",
                     "window_attention_qkv"]
    np.testing.assert_allclose(got.embedding, emb[0], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got.top_probs, top_vals[0], atol=1e-5)
    assert got.top_ids[0] == int(top_idx[0, 0])
    assert got.top_ids == top_idx[0].tolist()
    assert abs(got.lat - float(lnglat[0, 1])) < 1e-4
    assert abs(got.lon - float(lnglat[0, 0])) < 1e-4


def test_inference_result_reads_centroids_as_lng_lat(slice_pair):
    _, engine, views, paths = slice_pair
    r = engine.predict_images(paths)
    lng, lat = engine.table.centroids[r.top_ids[0]]
    assert (r.lat, r.lon) == (float(lat), float(lng))
    assert r.top_countries[0] == str(engine.table.country[r.top_ids[0]])
    assert r.embedding.shape == (4, 96)
    # one image is replicated across the four views
    one = engine.predict_images(paths[:1])
    np.testing.assert_allclose(one.embedding[3], one.embedding[0])


def test_view_mask_fuses_only_real_views(slice_pair):
    _, engine, views, _ = slice_pair
    both = np.stack([views, views])
    mask = np.array([[1, 1, 1, 1], [1, 0, 0, 0]], np.float32)
    got = engine.predict_batch(both, view_mask=mask)
    lone = engine.predict_batch(np.repeat(views[:1], 4, axis=0)[None])[0]
    np.testing.assert_allclose(got[1].top_probs, lone.top_probs, rtol=1e-4)
    assert got[0].top_ids == engine.predict_batch(views[None])[0].top_ids


def test_cli_main_prints_lat_lon(slice_pair, monkeypatch, capsys):
    from geoguessr_ai_torch import inference

    _, engine, _, paths = slice_pair
    monkeypatch.setattr(inference, "_get_engine",
                        lambda *a, **k: engine)
    inference.main(["--device", "cpu"])  # no images: the fixture panorama
    lat, lon = map(float, capsys.readouterr().out.split())
    want = engine.predict_images(paths)
    assert abs(lat - want.lat) < 1e-5 and abs(lon - want.lon) < 1e-5
    assert inference.fixture_panorama() == [
        os.path.join(REPO, "tests", "fixtures", os.path.basename(p))
        for p in paths]


class _FakeEngine:
    """Records the rows (first pixel of each) of every batch it is given;
    answers each row with that pixel."""

    image_size = 8

    def __init__(self):
        self.batches = []

    def predict_batch(self, views, view_mask=None):
        assert view_mask.shape == views.shape[:2]
        rows = [int(v[0, 0, 0, 0]) for v in views]
        self.batches.append(rows)
        return rows


def test_micro_batcher_buckets_and_pads_with_the_last_row():
    from geoguessr_ai_torch.serving.engine import MicroBatcher

    engine = _FakeEngine()
    mb = MicroBatcher(engine, max_batch=8, buckets=(1, 4, 8), linger_ms=200)
    results = [None] * 5

    def ask(i):
        views = np.full((4, 8, 8, 3), i, np.uint8)
        results[i] = mb.predict(views, timeout=30)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert results == list(range(5))
    # 5 arrivals inside the linger window -> one batch, padded to bucket 8
    # by repeating its last row
    (rows,) = engine.batches
    assert len(rows) == 8 and sorted(rows[:5]) == list(range(5))
    assert rows[5:] == [rows[4]] * 3
    assert mb.batch_sizes == {8: 1}
    with pytest.raises(ValueError):
        MicroBatcher(engine, max_batch=32)
    mb.warmup()
    assert [len(b) for b in engine.batches[1:]] == [1, 4, 8]


def test_micro_batcher_rolling_linger_coalesces_staggered_arrivals():
    """Arrivals 40 ms apart, spanning 200 ms, stay in one batch: each
    arrival extends the 100 ms linger window."""
    from geoguessr_ai_torch.serving.engine import MicroBatcher

    assert (MicroBatcher(_FakeEngine()).linger_s,
            MicroBatcher(_FakeEngine()).buckets) == (0.025, [1, 4, 8, 16])
    engine = _FakeEngine()
    mb = MicroBatcher(engine, linger_ms=100)
    threads = []
    for i in range(6):
        t = threading.Thread(target=mb.predict,
                             args=(np.full((4, 8, 8, 3), i, np.uint8),))
        t.start()
        threads.append(t)
        time.sleep(0.040)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert [len(b) for b in engine.batches] == [8]


def test_micro_batcher_delivers_engine_failures():
    from geoguessr_ai_torch.serving.engine import MicroBatcher

    class Broken(_FakeEngine):
        def predict_batch(self, views, view_mask=None):
            raise RuntimeError("boom")

    mb = MicroBatcher(Broken(), linger_ms=0)
    with pytest.raises(RuntimeError, match="boom"):
        mb.predict(np.zeros((4, 8, 8, 3), np.uint8), timeout=30)


def test_entry_points_default_to_cuda_and_refuse_without_it():
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.models.proto_refiner import ProtoRefiner, PrototypeBank
    from geoguessr_ai_torch.serving.engine import ServingEngine

    if torch.cuda.is_available():
        assert C.resolve_device(None) == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine()
    bank = PrototypeBank(np.zeros((2, 1, 4), np.float32),
                         np.zeros((2, 1, 2), np.float32),
                         np.ones((2, 1), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ProtoRefiner(bank)
    assert C.resolve_device("cpu") == torch.device("cpu")


def test_unported_options_raise():
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    # the CLIP backbone serves (tests/test_torch_port_clip.py), with its
    # int8 GEMMs too; a config of the other backbone does not
    engine = ServingEngine(backbone="clip", device="cpu",
                           backbone_config=CLIPVisionConfig.test_tiny(
                               quantize_gemms=True))
    assert engine is not None
    with pytest.raises(ValueError, match="CLIPVisionConfig"):
        ServingEngine(backbone="clip", device="cpu",
                      backbone_config=TinyViTConfig(**NARROW))
    # hierarchical fusion serves: tests/test_torch_port_guess_path.py


def _port_sources():
    files = glob.glob(os.path.join(REPO, "geoguessr_ai_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_no_jax_flax_or_the_jax_package():
    # nor what the card's machine lacks: regex (the BPE scanner is
    # stdlib), pandas, rasterio and pyproj
    banned = ("jax", "flax", "optax", "geoguessr_ai_tpu", "regex", "pandas",
              "rasterio", "pyproj")
    files = _port_sources()
    assert len(files) > 15
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"geoguessr_ai_torch/train/coordinator.py",
            "geoguessr_ai_torch/train/state.py",
            "geoguessr_ai_torch/train/steps.py",
            "geoguessr_ai_torch/utils/logging.py",
            "geoguessr_ai_torch/models/clip_vit.py",
            "geoguessr_ai_torch/ops/clip_attention.py",
            "geoguessr_ai_torch/ops/mbconv.py",
            "geoguessr_ai_torch/data/embed_builder.py",
            "geoguessr_ai_torch/data/sqlite_dataset.py",
            "geoguessr_ai_torch/ops/experimental/smem_probe.py",
            "geoguessr_ai_torch/tools/exp_r4_vmem.py",
            "geoguessr_ai_torch/models/positional.py",
            "geoguessr_ai_torch/models/torch_convert.py",
            "geoguessr_ai_torch/train/checkpoints.py",
            "geoguessr_ai_torch/eval/metrics.py",
            "geoguessr_ai_torch/run_benchmark.py",
            "geoguessr_ai_torch/serving/api.py",
            "geoguessr_ai_torch/train/train_eval_loop.py",
            "geoguessr_ai_torch/utils/profiling.py",
            "geoguessr_ai_torch/data/native/jpeg.py",
            "geoguessr_ai_torch/models/clip_text.py",
            "geoguessr_ai_torch/train/pretrain_clip.py",
            "geoguessr_ai_torch/train/captions.py",
            "geoguessr_ai_torch/train/clip_bpe.py",
            "geoguessr_ai_torch/train/finetune_tinyvit.py",
            "geoguessr_ai_torch/geocells/manager.py",
            "geoguessr_ai_torch/tools/build_centroid_table.py",
            "geoguessr_ai_torch/tools/build_prototype_bank.py",
            "geoguessr_ai_torch/geo/polygon.py",
            "geoguessr_ai_torch/data/preprocessing.py"} <= rel
    # the one exception, as in the JAX package: the Parquet writer imports
    # pandas inside itself
    pandas_ok = ("geoguessr_ai_torch/train/finetune_tinyvit.py",
                 "extract_embeddings_parquet")
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        allowed = set()
        if os.path.relpath(path, REPO) == pandas_ok[0]:
            fns = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                   and f.name == pandas_ok[1]]
            assert len(fns) == 1
            allowed = {id(n) for n in ast.walk(fns[0])}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name == "pandas" and id(node) in allowed:
                    continue
                assert name.split(".")[0] not in banned, (
                    f"{os.path.relpath(path, REPO)}:{node.lineno} imports "
                    f"{name}")


def test_serving_engine_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'geoguessr_ai_tpu', 'pandas', 'orbax',\n"
        "          'fastapi', 'regex', 'optax', 'rasterio', 'pyproj'):\n"
        "    sys.modules[m] = None\n"
        "import geoguessr_ai_torch.serving.engine\n"
        "import geoguessr_ai_torch.inference\n"
        "import geoguessr_ai_torch.models.convert\n"
        "import geoguessr_ai_torch.models.proto_refiner\n"
        "import geoguessr_ai_torch.models.clip_vit\n"
        "import geoguessr_ai_torch.ops.clip_attention\n"
        "import geoguessr_ai_torch.profile_forward\n"
        "import geoguessr_ai_torch.ops.mbconv\n"
        "import geoguessr_ai_torch.data.embed_builder\n"
        "import geoguessr_ai_torch.data.sqlite_dataset\n"
        "import geoguessr_ai_torch.models.torch_convert\n"
        "import geoguessr_ai_torch.train.checkpoints\n"
        "import geoguessr_ai_torch.run_benchmark\n"
        "import geoguessr_ai_torch.serving.api\n"
        "import geoguessr_ai_torch.models.clip_text\n"
        "import geoguessr_ai_torch.train.pretrain_clip\n"
        "import geoguessr_ai_torch.train.captions\n"
        "import geoguessr_ai_torch.train.finetune_tinyvit\n"
        "import geoguessr_ai_torch.geocells.manager\n"
        "import geoguessr_ai_torch.tools.build_centroid_table\n"
        "import geoguessr_ai_torch.tools.build_prototype_bank\n"
        "import geoguessr_ai_torch.data.preprocessing\n"
        "from geoguessr_ai_torch.train import clip_bpe\n"
        "ids = clip_bpe.load_default_tokenizer(16)(['x² ½ ٣ İstanbul'])\n"
        "assert ids.shape == (1, 16), ids.shape\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
