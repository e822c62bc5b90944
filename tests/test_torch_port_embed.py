"""The PyTorch port's bulk-embedding path held against the JAX package on
the CPU: the fused MBConv op (K10's plain version), the 4D fused block
(K9's plain version and its gradients), TinyViT with ``fused_mbconv`` and
``fused_block_4d``, and ``build_embedding_sqlite`` with the ``Embedder``.

Inputs are made from numpy seeds; flax weights are carried across with
``from_jax_variables`` (strict load).  Where the JAX function reaches a
Pallas kernel it runs in interpret mode.  Tolerances:

* f32 against f32: F32_ATOL / F32_RTOL, summation order only;
* bf16 against the JAX bf16 path: BF16_REL of the output's range (the two
  frameworks round GELU's intermediate terms at other points, a few bf16
  ulps of 2^-8);
* gradients in f32: GRAD_ATOL / GRAD_RTOL;
* embeddings written by the two builders: EMB_ATOL (f32, the whole
  narrow TinyViT forward).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import tinyvit as jtv
from geoguessr_ai_tpu.ops import mbconv as jmb
from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.models import tinyvit as ttv
from geoguessr_ai_torch.models.convert import from_jax_variables
from geoguessr_ai_torch.ops import mbconv as tmb
from geoguessr_ai_torch.ops import window_attention as twa

F32_ATOL, F32_RTOL = 1e-5, 1e-5
BF16_REL = 2e-2
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
MODEL_ATOL, MODEL_RTOL = 5e-4, 1e-3
EMB_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K10's op: fold_bn and fused_mbconv
# ---------------------------------------------------------------------------


def _mbconv_case(seed, B=2, H=8, W=8, C=16, E=64):
    """x, w1 (C, E), w2 (3, 3, E), w3 (E, C) and the raw BN parameters
    (scale, bias, mean, var) of the three BNs, as numpy f32."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return rng.normal(0, std, shape).astype(np.float32)

    bns = [(rng.uniform(0.5, 1.5, d).astype(np.float32), n(d, std=0.1),
            n(d, std=0.1), rng.uniform(0.5, 2.0, d).astype(np.float32))
           for d in (E, E, C)]
    return n(B, H, W, C), n(C, E, std=0.2), n(3, 3, E, std=0.2), \
        n(E, C, std=0.2), bns


def _folded_args(case, jax_side, dtype=np.float32):
    x, w1, w2, w3, bns = case
    if jax_side:
        fold = [jmb.fold_bn(*map(jnp.asarray, bn)) for bn in bns]
        arr = jnp.asarray
        xx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    else:
        fold = [tmb.fold_bn(*map(_t, bn)) for bn in bns]
        arr = _t
        xx = _t(x).bfloat16() if dtype == "bf16" else _t(x)
    (s1, b1), (s2, b2), (s3, b3) = fold
    return (xx, arr(w1), s1, b1, arr(w2), s2, b2, arr(w3), s3, b3)


def test_fold_bn_matches_jax():
    _, _, _, _, bns = _mbconv_case(0)
    for bn in bns:
        want = jmb.fold_bn(*map(jnp.asarray, bn))
        got = tmb.fold_bn(*map(_t, bn))
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_mbconv_matches_mbconv_xla(dtype, exact):
    case = _mbconv_case(1)
    want = np.asarray(jmb._mbconv_xla(*_folded_args(case, True, dtype),
                                      exact=exact), np.float32)
    with torch.no_grad():
        got = tmb.fused_mbconv(*_folded_args(case, False, dtype),
                               exact_gelu=exact).float().numpy()
    assert got.shape == want.shape == (2, 8, 8, 16)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("tile_h", [2, 4])
def test_fused_mbconv_matches_pallas_interpret(tile_h):
    case = _mbconv_case(2)
    want = np.asarray(jmb._mbconv_pallas(*_folded_args(case, True),
                                         exact=False, tile_h=tile_h,
                                         interpret=True))
    with torch.no_grad():
        got = tmb.fused_mbconv(*_folded_args(case, False)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fused_mbconv_refuses_autograd():
    args = list(_folded_args(_mbconv_case(3), False))
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tmb.fused_mbconv(*args)
    with torch.inference_mode():
        assert tmb.fused_mbconv(*args).shape == (2, 8, 8, 16)


# ---------------------------------------------------------------------------
# K9's op: fused_block_attention_4d
# ---------------------------------------------------------------------------

#: window 16 on a 32x32 map (4 windows per image, N=256), C=64, H=2, hd=32.
FB4D = dict(B=2, H=32, W=32, C=64, heads=2, window=16)


def _fb4d_case(seed, B, H, W, C, heads, window):
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return rng.normal(0, std, shape).astype(np.float32)

    N = window * window
    args = [n(B, H, W, C), rng.uniform(0.5, 1.5, C).astype(np.float32),
            n(C, std=0.1), n(C, 3 * C, std=0.1), n(3 * C, std=0.1),
            n(C, C, std=0.1), n(C, std=0.1), n(heads, N, N, std=0.5)]
    return args, (C // heads) ** -0.5


def test_fb4d_matches_fb4d_xla_and_pallas_interpret():
    c = FB4D
    args, scale = _fb4d_case(4, **c)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jwa._fb4d_xla(*jargs, scale, c["heads"], 1e-5,
                                    c["window"]))
    pallas = np.asarray(jwa._fb4d_pallas(*jargs, scale, c["heads"], 1e-5,
                                         c["window"], interpret=True))
    got = twa.fused_block_attention_4d(*map(_t, args), scale, c["heads"],
                                       c["window"]).detach().numpy()
    assert got.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    np.testing.assert_allclose(got, pallas, atol=2e-4, rtol=2e-4)


def test_fb4d_gradients_match_jax_vjp():
    c = dict(FB4D, B=1)
    args, scale = _fb4d_case(5, **c)
    g = np.random.default_rng(6).normal(0, 1, (1, 32, 32, 64)).astype(
        np.float32)
    def fb4d(*a):
        return jwa.fused_block_attention_4d(*a, scale, c["heads"],
                                            c["window"])

    want = jax.jit(lambda gg, *a: jax.vjp(fb4d, *a)[1](gg))(
        jnp.asarray(g), *[jnp.asarray(a) for a in args])
    leaves = [_t(a).requires_grad_() for a in args]
    out = twa.fused_block_attention_4d(*leaves, scale, c["heads"],
                                       c["window"])
    got = torch.autograd.grad(out, leaves, _t(g))
    for name, a, b in zip(("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv",
                           "w_proj", "b_proj", "bias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# TinyViT with both knobs
# ---------------------------------------------------------------------------

#: Narrow TinyViT at 256 px: stage 0 is a 64x64 map (fused MBConv), stage 1
#: a 32x32 map of four 16x16 windows (the 4D block), hd=32.
NARROW = dict(image_size=256, embed_dims=(32, 64, 64, 96), depths=(1, 1, 1, 1),
              num_heads=(1, 2, 2, 3))
KNOBS = dict(fused_mbconv=True, fused_block_4d=True)


def _randomise(variables, seed):
    """Seeded random leaves, BN variances positive, so that the folded BN
    and zero-initialised biases are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v)
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if v.ndim >= 2 and "attention_biases" not in name:
            fan_in = int(np.prod(v.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32)
        return rng.normal(0, 0.2, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def knob_models():
    jm = jtv.TinyViT(jtv.TinyViTConfig(dtype=jnp.float32, **NARROW, **KNOBS))
    x = np.random.default_rng(7).normal(size=(2, 256, 256, 3)).astype(
        np.float32)
    variables = _randomise(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)), 8)
    pm = ttv.TinyViT(ttv.TinyViTConfig(dtype=torch.float32, **NARROW,
                                       **KNOBS))
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, pm, variables, x


def _count_calls(monkeypatch):
    calls = {"fused_mbconv": 0, "fused_block_attention_4d": 0}
    for mod, name in ((tmb, "fused_mbconv"),
                      (twa, "fused_block_attention_4d")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def test_knob_state_dict_is_the_default_one(knob_models):
    """The knobs add no parameter: the flax tree with both knobs loads
    strictly into the port's default TinyViT and the knob one alike."""
    _, pm, variables, _ = knob_models
    sd = from_jax_variables(variables)
    ttv.TinyViT(ttv.TinyViTConfig(dtype=torch.float32, **NARROW)
                ).load_state_dict(sd, strict=True)
    assert set(sd) == set(pm.state_dict())


def test_tinyvit_with_both_knobs_matches_flax_in_eval(knob_models,
                                                      monkeypatch):
    jm, pm, variables, x = knob_models
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        got = pm(_t(x)).numpy()
    assert calls == {"fused_mbconv": 1, "fused_block_attention_4d": 1}
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)


def test_tinyvit_with_both_knobs_matches_flax_in_train(knob_models,
                                                       monkeypatch):
    """train=True takes the unfused MBConv (batch statistics) and keeps the
    4D block, as flax does; output and updated statistics match."""
    import copy

    jm, pm, variables, x = knob_models
    pm = copy.deepcopy(pm)
    want, upd = jax.jit(lambda v, xx: jm.apply(v, xx, train=True,
                                               mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    calls = _count_calls(monkeypatch)
    got = pm(_t(x), train=True)
    assert calls == {"fused_mbconv": 0, "fused_block_attention_4d": 1}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_ATOL, rtol=MODEL_RTOL)
    stats = from_jax_variables({"params": variables["params"],
                                "batch_stats": upd["batch_stats"]})
    for name, buf in pm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                       atol=MODEL_ATOL, rtol=MODEL_RTOL,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# build_embedding_sqlite with the Embedder
# ---------------------------------------------------------------------------

#: The JAX package's test_tiny TinyViT (64 px) with the fused MBConv.
TINY = dict(image_size=64, embed_dims=(16, 32, 64, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 5), window_sizes=(2, 2, 4, 2),
            fused_mbconv=True)
NUM_ROWS = 10


def _blobs(fixtures_dir):
    out = []
    for h in ("000", "090", "180", "270"):
        with open(os.path.join(fixtures_dir, f"heading={h}.jpg"), "rb") as f:
            out.append(f.read())
    return out


@pytest.fixture(scope="module")
def raw_sqlite(tmp_path_factory, fixtures_dir):
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
    )

    path = str(tmp_path_factory.mktemp("embed") / "raw.sqlite")
    blobs = _blobs(fixtures_dir)
    create_sqlite_from_records(path, [
        {"location_id": f"loc{i // 4}", "lat": 10.0 + i, "lon": -20.0 - i,
         "heading": 90 * (i % 4), "pano_id": f"pano{i}",
         "capture_date": "2024-05", "image": blobs[i % 4]}
        for i in range(NUM_ROWS)])
    return path


@pytest.fixture(scope="module")
def embedders():
    """(the JAX Embedder double, the port's Embedder) on the same weights."""
    from geoguessr_ai_tpu.config import TINYVIT_NORM_MEAN, TINYVIT_NORM_STD
    from geoguessr_ai_tpu.data.embed_builder import Embedder as JaxEmbedder
    from geoguessr_ai_tpu.ops.preprocess import fused_preprocess

    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import Embedder

    jcfg = jtv.TinyViTConfig(dtype=jnp.float32, **TINY)
    module = jtv.TinyViT(jcfg)
    variables = _randomise(jax.jit(module.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3))), 9)

    class _JaxTinyEmbedder(JaxEmbedder):
        def __init__(self):
            self.image_size = jcfg.image_size
            self.embed_dim = jcfg.embed_dim
            self.variables = variables

            def embed(v, images_u8):
                x = fused_preprocess(images_u8, TINYVIT_NORM_MEAN,
                                     TINYVIT_NORM_STD, jcfg.image_size,
                                     dtype=jnp.float32)
                return module.apply(v, x)

            self._embed = jax.jit(embed)

    port = Embedder(BackboneConfig.tinyvit(), device="cpu",
                    model_config=ttv.TinyViTConfig(dtype=torch.float32,
                                                   **TINY),
                    state_dict=from_jax_variables(variables))
    return _JaxTinyEmbedder(), port


def _cfg(**kw):
    from geoguessr_ai_torch.config import EmbedBuildConfig

    return EmbedBuildConfig(**{"batch_size": 4, "fetch_threads": 2,
                               "quant_mode": "none", **kw})


def _by_key(rows):
    return {(r.location_id, int(r.heading)): r for r in rows}


def test_build_embedding_sqlite_matches_jax(raw_sqlite, embedders, tmp_path,
                                           monkeypatch):
    """Same rows, columns and embeddings as the JAX builder on the same
    weights, with 10 rows in batches of 4 (the last one padded); the JAX
    reader reads the port's file.  Both builders decode with the port's
    PIL decoder (the JAX package's native libjpeg resize is not what this
    holds)."""
    from geoguessr_ai_tpu.config import EmbedBuildConfig as JaxCfg
    from geoguessr_ai_tpu.data import embed_builder as jeb
    from geoguessr_ai_tpu.data.sqlite_dataset import (
        read_embeddings as jax_read,
    )

    from geoguessr_ai_torch.data import pipeline
    from geoguessr_ai_torch.data.embed_builder import build_embedding_sqlite
    from geoguessr_ai_torch.data.sqlite_dataset import read_embeddings

    monkeypatch.setattr(jeb, "decode_jpeg", pipeline.decode_jpeg)
    jemb, port = embedders
    out_j, out_p = str(tmp_path / "jax.sqlite"), str(tmp_path / "port.sqlite")
    assert jeb.build_embedding_sqlite(
        raw_sqlite, out_j, JaxCfg(batch_size=4, fetch_threads=2,
                                  quant_mode="none"), embedder=jemb) == 10
    telemetry = []
    assert build_embedding_sqlite(raw_sqlite, out_p, _cfg(), embedder=port,
                                  log_fn=telemetry.append) == 10
    assert telemetry[-1]["processed"] == 10
    assert {"mode", "processed", "total", "throughput_img_per_s",
            "phase"} <= set(telemetry[0])

    want = jax_read(out_j)
    got = _by_key(read_embeddings(out_p))
    assert len(got) == len(want) == NUM_ROWS
    for _, w in want.iterrows():
        g = got[(w["location_id"], int(w["heading"]))]
        for col in ("lat", "lon", "capture_date", "pano_id", "batch_date",
                    "embedding_dim"):
            a, b = getattr(g, col), w[col]
            if a is None:  # NULL: pandas reads None, or NaN in a float column
                assert b is None or b != b, (col, b)
            else:
                assert a == b, (col, a, b)
        assert g.embedding.shape == (80,)
        np.testing.assert_allclose(g.embedding, w["embedding"],
                                   atol=EMB_ATOL)
    # the JAX reader on the port's file
    back = jax_read(out_p)
    assert len(back) == NUM_ROWS
    for _, w in back.iterrows():
        np.testing.assert_array_equal(
            w["embedding"], got[(w["location_id"], int(w["heading"]))]
            .embedding)


def test_streaming_predecoded_and_padding_agree(raw_sqlite, embedders,
                                               tmp_path):
    """Streaming and predecoded builds write the same embeddings, and a
    row's embedding does not depend on the padded batch it rode in."""
    from geoguessr_ai_torch.data.embed_builder import build_embedding_sqlite
    from geoguessr_ai_torch.data.sqlite_dataset import read_embeddings

    _, port = embedders
    outs = {}
    for name, kw, cfg in (("stream", {}, _cfg()),
                          ("pre", {"predecoded": True}, _cfg()),
                          ("one_batch", {}, _cfg(batch_size=16))):
        path = str(tmp_path / f"{name}.sqlite")
        assert build_embedding_sqlite(raw_sqlite, path, cfg, embedder=port,
                                      **kw) == NUM_ROWS
        outs[name] = _by_key(read_embeddings(path))
    for key, row in outs["stream"].items():
        np.testing.assert_allclose(outs["pre"][key].embedding, row.embedding,
                                   atol=1e-6)
        np.testing.assert_allclose(outs["one_batch"][key].embedding,
                                   row.embedding, atol=1e-5)


def test_resume_skips_done_rows(raw_sqlite, embedders, tmp_path):
    import sqlite3

    from geoguessr_ai_torch.data.embed_builder import build_embedding_sqlite

    _, port = embedders
    out = str(tmp_path / "resume.sqlite")
    assert build_embedding_sqlite(raw_sqlite, out, _cfg(), embedder=port,
                                  limit=5) == 5
    assert build_embedding_sqlite(raw_sqlite, out, _cfg(),
                                  embedder=port) == NUM_ROWS - 5
    with sqlite3.connect(out) as c:
        assert c.execute("SELECT COUNT(*) FROM samples").fetchone()[0] == \
            NUM_ROWS
    assert build_embedding_sqlite(raw_sqlite, out, _cfg(), embedder=port) == 0


@pytest.mark.parametrize("predecoded", [False, True])
def test_producer_error_is_reraised(embedders, tmp_path, fixtures_dir,
                                    predecoded):
    """A blob that does not decode fails the build instead of hanging it."""
    from geoguessr_ai_torch.data.embed_builder import build_embedding_sqlite
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
    )

    src = str(tmp_path / "corrupt.sqlite")
    blob = _blobs(fixtures_dir)[0]
    create_sqlite_from_records(src, [
        {"location_id": f"c{i}", "lat": 0.0, "lon": 0.0, "heading": 0,
         "image": b"not a jpeg" if i == 5 else blob} for i in range(7)])
    _, port = embedders
    with pytest.raises(RuntimeError, match="producer failed") as info:
        build_embedding_sqlite(src, str(tmp_path / "out.sqlite"), _cfg(),
                               embedder=port, predecoded=predecoded)
    assert info.value.__cause__ is not None


def test_unported_embed_options_raise(raw_sqlite, tmp_path):
    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        build_embedding_sqlite,
    )

    # quant_mode="static" is ported (tests/test_torch_port_quant.py)
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig

    static = Embedder(BackboneConfig.tinyvit(), quant_mode="static",
                      device="cpu", model_config=TinyViTConfig(
                          image_size=64, embed_dims=(16, 32, 64, 80),
                          depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 5),
                          window_sizes=(2, 2, 4, 2)))
    assert static.model.config.quant_mode == "static"
    with pytest.raises(NotImplementedError, match="item 11"):
        Embedder(BackboneConfig.tinyvit(), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        build_embedding_sqlite(raw_sqlite, str(tmp_path / "o.sqlite"),
                               _cfg(data_parallel=8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Embedder(BackboneConfig.tinyvit(), model_config=ttv.TinyViTConfig(
                **NARROW))


def test_embed_build_config_mirrors_jax_defaults():
    import dataclasses

    from geoguessr_ai_tpu.config import EmbedBuildConfig as JaxCfg

    from geoguessr_ai_torch.config import EmbedBuildConfig

    jcfg, pcfg = JaxCfg(), EmbedBuildConfig()
    assert [f.name for f in dataclasses.fields(pcfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(pcfg):
        if f.name != "backbone":
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert pcfg.backbone.name == jcfg.backbone.name == "tinyvit"
