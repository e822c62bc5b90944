"""The port's int8 path held against the JAX package on the CPU.

``ops/quant.py`` function for function; TinyViT's quant modes and sites at
``test_tiny`` (calibrate, static, dynamic, the train sites, the int8 conv
emitter, a stage subset) with the per-site scales carried by
``models.convert``; the static ``Embedder`` at full width against the JAX
static ``Embedder``; CLIP's ``quantize_gemms``.  Inputs come from numpy
seeds and go through both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import tinyvit as jtv
from geoguessr_ai_tpu.ops import quant as JQ

from geoguessr_ai_torch.models import tinyvit as ttv
from geoguessr_ai_torch.models.convert import (
    from_jax_variables,
    to_jax_variables,
)
from geoguessr_ai_torch.ops import quant as TQ

#: TinyViT test_tiny: windows of 4-16 tokens, so every attention takes the
#: plain branch with its qkv and proj GEMM sites.
TINY = dict(image_size=64, embed_dims=(16, 32, 64, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 5), window_sizes=(2, 2, 4, 2))


def _np(x):
    return np.asarray(jax.device_get(x))


def _ulp(x, dtype):
    """One unit in the last place of ``dtype`` at |x| (f32 numpy)."""
    mant = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - mant)


def _within_one_ulp(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = _ulp(np.maximum(np.abs(got), np.abs(want)), dtype)
    return bool((np.abs(got - want) <= tol).all())


def _cosine(a, b):
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((64, 32), None), ((64, 32), 1),
                                        ((3, 3, 8, 16), 3), ((5, 7), 0)])
def test_quantize_symmetric_matches_jax(shape, axis):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    x.flat[3] = 0.0  # a zero and an exact half step stay exact
    jq, js = JQ.quantize_symmetric(jnp.asarray(x), axis=axis)
    tq, ts = TQ.quantize_symmetric(torch.from_numpy(x), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def test_round_half_to_even_and_division_match_jax():
    """x / scale at exact halves rounds to even in both packages."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 300.0, -300.0],
                 np.float32)
    amax = np.float32(127.0)
    j = JQ.fake_quant_static(jnp.asarray(x), jnp.asarray(amax))
    t = TQ.fake_quant_static(torch.from_numpy(x), torch.tensor(amax))
    np.testing.assert_array_equal(t.numpy(), _np(j))
    np.testing.assert_array_equal(t.numpy()[:5], [0, 2, 2, -0, -2])


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_matmul_matches_jax(per_row, out_dtype, with_bias):
    """Equal int8 operands and int32 sums; the output within one ulp of
    the out dtype."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (40, 72)).astype(np.float32)
    w = rng.normal(0, 0.1, (72, 24)).astype(np.float32)
    b = rng.normal(0, 0.1, (24,)).astype(np.float32) if with_bias else None
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    j = JQ.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                       None if b is None else jnp.asarray(b), jdt, per_row)
    t = TQ.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       None if b is None else torch.from_numpy(b), tdt,
                       per_row)
    assert t.dtype == tdt and t.shape == (40, 24)
    assert _within_one_ulp(t.float().numpy(), _np(j.astype(jnp.float32)),
                           tdt)
    # the int32 sums themselves
    xs = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12) / 127.0
    xq = np.clip(np.round(x / xs.astype(np.float32)), -127, 127).astype(
        np.int8)
    wq, _ = TQ.quantize_symmetric(torch.from_numpy(w), axis=1)
    want = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq.numpy()),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(
        TQ._int_mm(torch.from_numpy(xq), wq).numpy(), _np(want))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_int8_static_matmul_and_einsums_match_jax(out_dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 9, 48)).astype(np.float32)
    w = rng.normal(0, 0.1, (48, 16)).astype(np.float32)
    b = rng.normal(0, 0.1, (16,)).astype(np.float32)
    amax = np.float32(2.5)  # some activations clip at +-127
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    cases = [
        (JQ.int8_static_einsum_nc_cd(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(amax), jnp.asarray(b), jdt),
         TQ.int8_static_einsum_nc_cd(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.tensor(amax), torch.from_numpy(b),
                                     tdt)),
        (JQ.int8_static_matmul(jnp.asarray(x[0]), jnp.asarray(w),
                               jnp.asarray(amax), None, jdt),
         TQ.int8_static_matmul(torch.from_numpy(x[0]), torch.from_numpy(w),
                               torch.tensor(amax), None, tdt)),
        (JQ.int8_einsum_nc_cd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              jdt),
         TQ.int8_einsum_nc_cd(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), tdt)),
    ]
    for j, t in cases:
        assert t.shape == j.shape and t.dtype == tdt
        assert _within_one_ulp(t.float().numpy(), _np(j.astype(jnp.float32)),
                               tdt)


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 2, 3, 8), (1, 1, 16, 24),
                                               (3, 1, 8, 8)])
def test_int8_static_conv_matches_jax(k, stride, cin, cout):
    """The im2col int8 conv against XLA's int8 conv; the stem's K = 27."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 12, 10, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    amax = np.float32(np.abs(x).max())
    j = JQ.int8_static_conv(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(amax), stride=stride, padding=k // 2,
                            out_dtype=jnp.float32)
    t = TQ.int8_static_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.tensor(amax), stride=stride,
                            padding=k // 2, out_dtype=torch.float32)
    assert t.shape == j.shape
    assert _within_one_ulp(t.numpy(), _np(j), torch.float32)


def test_fake_quant_static_ste_is_the_primal_with_a_straight_gradient():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 5, 7)).astype(np.float32)
    amax = np.float32(1.7)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        j = JQ.fake_quant_static(jnp.asarray(x, dt_j), jnp.asarray(amax))
        t = TQ.fake_quant_static(torch.from_numpy(x).to(dt_t),
                                 torch.tensor(amax))
        assert t.dtype == dt_t
        np.testing.assert_array_equal(t.float().numpy(),
                                      _np(j.astype(jnp.float32)))
    xt = torch.from_numpy(x).requires_grad_()
    ste = TQ.fake_quant_static_ste(xt, torch.tensor(amax))
    assert torch.equal(ste.detach(), TQ.fake_quant_static(xt.detach(),
                                                          torch.tensor(amax)))
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    (got,) = torch.autograd.grad(ste, xt, g)
    _, vjp = jax.vjp(lambda v: JQ.fake_quant_static_ste(v, jnp.asarray(amax)),
                     jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), _np(vjp(jnp.asarray(g.numpy()))[0]))
    np.testing.assert_array_equal(got.numpy(), g.numpy())


def test_calibrate_act_stats_accumulates_the_running_max():
    seen = []

    def apply_calibrate(variables, x):
        seen.append(dict(variables.get("act_stats", {})))
        prev = variables.get("act_stats", {}).get("a", torch.tensor(0.0))
        return None, {"act_stats": {"a": torch.maximum(prev, x.abs().max())}}

    stats = TQ.calibrate_act_stats(apply_calibrate, {"params": {}},
                                   [torch.tensor([1.0, -3.0]),
                                    torch.tensor([2.0]),
                                    torch.tensor([-5.0])])
    assert float(stats["a"]) == 5.0
    assert seen[0] == {} and float(seen[1]["a"]) == 3.0


# ---------------------------------------------------------------------------
# TinyViT's quant modes and sites at test_tiny
# ---------------------------------------------------------------------------


def _randomised_variables(jm, x, seed=0):
    # only the tree's paths and shapes are read (every value is drawn
    # below), so the init is traced abstractly, not run
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(v)
    out = []
    for path, a in leaves:
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            out.append(rng.uniform(0.5, 1.5, a.shape).astype(np.float32))
        elif a.ndim >= 2 and "attention_biases" not in name:
            fan_in = int(np.prod(a.shape[:-1]))
            out.append(rng.normal(0, fan_in ** -0.5, a.shape).astype(
                np.float32))
        else:
            out.append(rng.normal(0, 0.2, a.shape).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _tiny_input(seed=1, n=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 64, 64, 3)).astype(np.float32)


def _models(**fields):
    jm = jtv.TinyViT(jtv.TinyViTConfig(dtype=jnp.float32, **TINY, **fields))
    pm = ttv.TinyViT(ttv.TinyViTConfig(dtype=torch.float32, **TINY, **fields))
    return jm, pm


def _flax_calibrate(variables, x, **fields):
    jm, _ = _models(quant_mode="calibrate", **fields)
    out, mut = jax.jit(lambda v, xx: jm.apply(v, xx, mutable=["act_stats"]))(
        variables, jnp.asarray(x))
    return _np(out), jax.tree_util.tree_map(np.asarray, mut["act_stats"])


@pytest.mark.parametrize("emitter", [False, True])
def test_calibrate_records_the_flax_act_stats(emitter, monkeypatch):
    """A calibrate forward leaves the output as the plain forward has it
    and records each site's abs-max as flax does (same paths, rtol 1e-6)."""
    monkeypatch.setattr(jtv, "CONV_INT8_EMITTER", emitter)
    monkeypatch.setattr(ttv, "CONV_INT8_EMITTER", emitter)
    x = _tiny_input()
    jm0, _ = _models()
    variables = _randomised_variables(jm0, x)
    want_out, want_stats = _flax_calibrate(variables, x)
    _, pm = _models(quant_mode="calibrate")
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    _, plain = _models()
    plain.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
        base = plain(torch.from_numpy(x))
    assert torch.equal(got, base)
    np.testing.assert_allclose(got.numpy(), want_out, rtol=1e-4, atol=1e-4)
    back = to_jax_variables({f"act_stats.{k}": v
                             for k, v in pm.act_stats.items()})["act_stats"]
    want_leaves = jax.tree_util.tree_flatten_with_path(want_stats)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got_leaves) == len(want_leaves) > 0
    for path, w in want_leaves:
        np.testing.assert_allclose(got_leaves[path], w, rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


#: (name, TinyViTConfig quant fields, CONV_INT8_EMITTER)
QUANT_CASES = {
    "static_prod": (dict(quant_mode="static",
                         quant_sites=ttv.PROD_QUANT_SITES), False),
    "static_all_sites": (dict(quant_mode="static"), False),
    "static_train_sites": (dict(quant_mode="static",
                                quant_sites=ttv.TRAIN_QUANT_SITES), False),
    # stage 0 only: a later int8 site would re-quantize the emitter's
    # differences away
    "static_emitter": (dict(quant_mode="static", quant_stages=(0,)), True),
    "static_stage_subset": (dict(quant_mode="static", quant_stages=(1, 3)),
                            False),
    "dynamic": (dict(quant_mode="dynamic"), False),
    "quantize_gemms": (dict(quantize_gemms=True, quant_stages=(0, 2)),
                       False),
}


@pytest.fixture(scope="module")
def quant_reference():
    """The input and randomised variables every QUANT_CASES case shares,
    and flax's calibrated scales of them by CONV_INT8_EMITTER value
    (filled by the first case that needs them), built once a module."""
    x = _tiny_input(seed=2)
    jm0, _ = _models()
    return {"x": x, "variables": _randomised_variables(jm0, x, seed=3),
            "scales": {}}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quant_forward_matches_flax(case, monkeypatch, quant_reference):
    """The static forward from flax's calibrated scales (carried by
    ``from_jax_variables``), and the dynamic one, against flax: cosine >=
    0.9999 per image."""
    fields, emitter = QUANT_CASES[case]
    monkeypatch.setattr(jtv, "CONV_INT8_EMITTER", emitter)
    monkeypatch.setattr(ttv, "CONV_INT8_EMITTER", emitter)
    # the flag is read at trace time: no trace of an equal module may be
    # reused from another case
    jax.clear_caches()
    convs = []
    monkeypatch.setattr(TQ, "int8_static_conv",
                        lambda *a, real=TQ.int8_static_conv, **k:
                        convs.append(1) or real(*a, **k))
    x, variables = quant_reference["x"], quant_reference["variables"]
    if fields.get("quant_mode") == "static":
        scales = quant_reference["scales"]
        if emitter not in scales:  # the emitter changes the calibrated sites
            scales[emitter] = _flax_calibrate(variables, x)[1]
        variables = {**variables, "act_scales": scales[emitter]}
    jm, pm = _models(**fields)
    want = _np(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    cos = _cosine(got, want)
    err = float(np.abs(got - want).max())
    assert cos.min() >= 0.9999, (cos, err)
    assert bool(convs) == emitter  # stem, stage-0 conv1: the int8 conv
    # the int8 path moved the output away from the plain forward
    with torch.no_grad():
        _, plain = _models()
        plain.load_state_dict(from_jax_variables(
            {k: v for k, v in variables.items() if k != "act_scales"}))
        assert not np.array_equal(got, plain(torch.from_numpy(x)).numpy())


def test_static_reads_and_round_trips_the_act_scales():
    x = _tiny_input(seed=4)
    jm0, _ = _models()
    variables = _randomised_variables(jm0, x, seed=5)
    _, stats = _flax_calibrate(variables, x)
    sd = from_jax_variables({**variables, "act_scales": stats})
    _, pm = _models(quant_mode="static", quant_sites=ttv.PROD_QUANT_SITES)
    pm.load_state_dict(sd, strict=True)
    assert pm.act_scales and all(k.endswith("amax") for k in pm.act_scales)
    back = to_jax_variables(pm.state_dict())
    assert jax.tree_util.tree_structure(back["act_scales"]) == \
        jax.tree_util.tree_structure(stats)
    _, empty = _models(quant_mode="static")
    with pytest.raises(KeyError, match="act_scales"):
        empty(torch.from_numpy(x))


@pytest.mark.parametrize("sites,engages", [(ttv.PROD_QUANT_SITES, True),
                                           (("conv", "fc1"), False)])
def test_fused_mbconv_gate_follows_the_conv_sites(sites, engages,
                                                  monkeypatch):
    """K10 (``fused_mbconv``) engages with the static prod sites, and not
    while a conv site quantizes or in calibration, as the JAX gate."""
    from geoguessr_ai_torch.ops import mbconv

    calls = []
    real = mbconv.fused_mbconv
    monkeypatch.setattr(mbconv, "fused_mbconv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(_tiny_input(seed=6))
    _, pm = _models(quant_mode="static", quant_sites=sites,
                    fused_mbconv=True)
    _, cal = _models(quant_mode="calibrate", fused_mbconv=True)
    with torch.no_grad():
        cal(x)
        assert not calls
        pm.act_scales = cal.act_stats
        pm(x)
    assert bool(calls) == engages


def test_int8_sites_keep_f32_weights_through_cast():
    _, pm = _models(quant_mode="static", quant_sites=("fc1", "conv"),
                    quant_stages=(1, 2))
    pm.config = dataclasses.replace(pm.config, dtype=torch.bfloat16)
    pm.cast_weights_()
    assert pm.stage1_block0.mlp.fc1.weight.dtype == torch.float32
    assert pm.stage1_block0.mlp.fc2.weight.dtype == torch.bfloat16
    assert pm.downsample0.conv1.conv.weight.dtype == torch.float32
    assert pm.downsample0.conv2.conv.weight.dtype == torch.bfloat16  # dw
    assert pm.stage3_block0.mlp.fc1.weight.dtype == torch.bfloat16  # stage
    assert pm.stage0_block0.conv1.conv.weight.dtype == torch.bfloat16


def test_scan_stage_refuses_quantization():
    with pytest.raises(ValueError, match="act_scales"):
        ttv.TinyViT(ttv.TinyViTConfig(**TINY, scan_stages=(2,),
                                      quant_mode="static"))


# ---------------------------------------------------------------------------
# The static Embedder
# ---------------------------------------------------------------------------


def _fixture_images(n, size):
    import glob
    import os

    from geoguessr_ai_torch.data.pipeline import decode_jpeg

    paths = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                          "fixtures", "heading=*.jpg")))
    return np.stack([decode_jpeg(open(paths[i % len(paths)], "rb").read(),
                                 size) for i in range(n)])


def test_static_embedder_matches_the_jax_static_embedder(monkeypatch):
    """Full width (the JAX static Embedder builds TinyViT-21M-512), B=2,
    one call each: the same scales after calibration (rtol 1e-4) and
    embeddings at cosine >= 0.999."""
    from geoguessr_ai_tpu.config import BackboneConfig as JBC
    from geoguessr_ai_tpu.data.embed_builder import Embedder as JEmbedder

    from geoguessr_ai_torch.config import BackboneConfig
    from geoguessr_ai_torch.data.embed_builder import Embedder

    images = _fixture_images(2, 512)
    variables = _randomised_variables(
        jtv.TinyViT(jtv.TinyViTConfig.tiny_vit_21m_512()), images[:1] / 255.0,
        seed=7)
    # the JAX Embedder's constructor draws weights (an eager full-width
    # init) that the test replaces at once: it is handed these instead
    with monkeypatch.context() as m:
        m.setattr(jtv.TinyViT, "init", lambda self, *a, **k: variables)
        jemb = JEmbedder(JBC(), quant_mode="static")
    jemb.variables = variables
    want = np.asarray(jemb(images))
    temb = Embedder(BackboneConfig.tinyvit(), quant_mode="static",
                    device="cpu",
                    state_dict=from_jax_variables(jemb.variables))
    got = temb(images)
    assert got.shape == want.shape == (2, 576) and np.isfinite(got).all()
    scales = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jemb._act_scales))[0]
    back = dict(jax.tree_util.tree_flatten_with_path(to_jax_variables(
        {f"act_scales.{k}": v for k, v in temb.model.act_scales.items()}
    )["act_scales"])[0])
    assert len(back) == len(scales) > 0
    for path, w in scales:
        np.testing.assert_allclose(back[path], w, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert _cosine(got, want).min() >= 0.999
    temb.load_params(temb._host_state)  # recalibrates at the next call
    assert not temb.model.act_scales


def test_build_embedding_sqlite_runs_with_the_default_config(tmp_path):
    """``EmbedBuildConfig()`` (quant_mode "static") at a small batch,
    through a narrow static Embedder on the CPU: every row finite."""
    from geoguessr_ai_torch.config import BackboneConfig, EmbedBuildConfig
    from geoguessr_ai_torch.data.embed_builder import (
        Embedder,
        build_embedding_sqlite,
    )
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
        read_embeddings,
    )

    cfg = EmbedBuildConfig(batch_size=4, fetch_threads=2)
    assert cfg.quant_mode == "static"
    import glob
    import os

    paths = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                          "fixtures", "heading=*.jpg")))
    src = str(tmp_path / "src.sqlite")
    create_sqlite_from_records(src, ({
        "location_id": f"loc{i}", "lat": 1.0 * i, "lon": 2.0, "heading": 90 * (i % 4),
        "image": open(paths[i % len(paths)], "rb").read()} for i in range(6)))
    emb = Embedder(BackboneConfig.tinyvit(), quant_mode=cfg.quant_mode,
                   device="cpu", model_config=ttv.TinyViTConfig(**TINY))
    assert emb.model.config.quant_mode == "static"
    assert emb.model.config.quant_sites == ttv.PROD_QUANT_SITES
    out = str(tmp_path / "out.sqlite")
    assert build_embedding_sqlite(src, out, cfg, embedder=emb) == 6
    rows = read_embeddings(out)
    assert len(rows) == 6
    assert all(np.isfinite(r.embedding).all() and r.embedding.shape == (80,)
               for r in rows)
    assert emb.model.act_scales


# ---------------------------------------------------------------------------
# CLIP quantize_gemms
# ---------------------------------------------------------------------------


def test_clip_quantize_gemms_matches_flax():
    from geoguessr_ai_tpu.models.clip_vit import CLIPVisionConfig as JCfg
    from geoguessr_ai_tpu.models.clip_vit import CLIPVisionTower as JTower

    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig, \
        CLIPVisionTower

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    jcfg = JCfg.test_tiny(dtype=jnp.float32, quantize_gemms=True)
    jm = JTower(jcfg)
    variables = _randomised_variables(jm, x, seed=9)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    pm = CLIPVisionTower(CLIPVisionConfig.test_tiny(dtype=torch.float32,
                                                    quantize_gemms=True))
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, w in ((got.pooler_output, want.pooler_output),
                 (got.last_hidden_state, want.last_hidden_state)):
        assert _cosine(g.numpy(), _np(w)).min() >= 0.9999
    plain = CLIPVisionTower(CLIPVisionConfig.test_tiny(dtype=torch.float32))
    plain.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        base = plain(torch.from_numpy(x)).pooler_output
    assert not torch.equal(base, got.pooler_output)
    assert _cosine(base.numpy(), got.pooler_output.numpy()).min() >= 0.99
