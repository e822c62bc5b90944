"""The PyTorch port's ops (geoguessr_ai_torch) held against the JAX package.

Inputs come from numpy with a fixed seed and go through both functions;
comparisons are in f32 on the CPU, where each port op takes its plain
PyTorch version.  The K1/K2 Pallas kernels run in interpret mode; K3's
Pallas function has no interpret mode, so its XLA composition is the
reference.  The CUDA kernels are held against the plain versions on the
card in tests/test_torch_port_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoguessr_ai_torch.ops import window_attention as wa

# atol/rtol of the f32 attention comparisons (as tests/test_window_attention.py):
# the two frameworks sum the N-long softmax and p.v in different orders.
ATOL, RTOL = 2e-4, 2e-3


def _attn_inputs(W, N, C, H, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(0, 1, (W, N, C)).astype(f),
        ln_scale=rng.normal(1, 0.1, (C,)).astype(f),
        ln_bias=rng.normal(0, 0.1, (C,)).astype(f),
        w_qkv=rng.normal(0, 0.1, (C, 3 * C)).astype(f),
        b_qkv=rng.normal(0, 0.1, (3 * C,)).astype(f),
        w_proj=rng.normal(0, 0.1, (C, C)).astype(f),
        b_proj=rng.normal(0, 0.1, (C,)).astype(f),
        bias=rng.normal(0, 0.5, (H, N, N)).astype(f),
    )


def _t(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


_K1_KEYS = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
            "bias")
_K2_KEYS = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "bias")

#: (W, N, C, H): the Pallas tests' shape (hd=16) and a TinyViT-like hd=32.
SHAPES = [(6, 128, 32, 2), (2, 128, 64, 2)]


@pytest.mark.parametrize("W,N,C,H", SHAPES)
def test_fused_block_attention_matches_pallas_interpret(W, N, C, H):
    """K1: port plain path vs _fused_block_pallas (interpret) and
    _fused_block_xla."""
    from geoguessr_ai_tpu.ops.window_attention import (
        _fused_block_pallas,
        _fused_block_xla,
    )

    a = _attn_inputs(W, N, C, H)
    scale = (C // H) ** -0.5
    ja = [_j(a)[k] for k in _K1_KEYS]
    want_pallas = np.asarray(_fused_block_pallas(
        *ja, scale, H, 1e-5, block_w=2, interpret=True))
    want_xla = np.asarray(_fused_block_xla(*ja, scale, H, 1e-5))
    got = wa.fused_block_attention(*[_t(a)[k] for k in _K1_KEYS], scale, H)
    assert got.shape == (W, N, C)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("W,N,C,H", SHAPES)
def test_fused_block_attention_noproj_matches_pallas_interpret(W, N, C, H):
    """K2: port plain path vs _fb_s2_pallas (interpret) and _fb_s2_xla."""
    from geoguessr_ai_tpu.ops.window_attention import _fb_s2_pallas, _fb_s2_xla

    a = _attn_inputs(W, N, C, H, seed=1)
    scale = (C // H) ** -0.5
    ja = [_j(a)[k] for k in _K2_KEYS]
    want_pallas = np.asarray(_fb_s2_pallas(*ja, scale, H, 1e-5,
                                           interpret=True))
    want_xla = np.asarray(_fb_s2_xla(*ja, scale, H, 1e-5))
    got = wa.fused_block_attention_noproj(*[_t(a)[k] for k in _K2_KEYS],
                                          scale, H)
    assert got.shape == (W, N, C)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("W,N,C,H", SHAPES + [(3, 256, 96, 3)])
def test_window_attention_qkv_matches_jax(W, N, C, H):
    """K3: port plain path vs _attention_qkv_fused_xla (the Pallas
    function has no interpret mode)."""
    from geoguessr_ai_tpu.ops.window_attention import _attention_qkv_fused_xla

    rng = np.random.default_rng(2)
    qkv = rng.normal(0, 1, (W, N, 3 * C)).astype(np.float32)
    bias = rng.normal(0, 0.5, (H, N, N)).astype(np.float32)
    scale = (C // H) ** -0.5
    want = np.asarray(_attention_qkv_fused_xla(
        jnp.asarray(qkv), jnp.asarray(bias), scale, H))
    got = wa.window_attention_qkv(torch.from_numpy(qkv),
                                  torch.from_numpy(bias), scale, H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_qkv_layout_is_interleaved_per_head():
    """Head h reads q|k|v from channels [h*3hd, (h+1)*3hd), not from a
    q|k|v block split of the 3D channels."""
    W, N, H, hd = 1, 128, 2, 32
    D = H * hd
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (W, N, 3 * D)).astype(np.float32))
    bias = torch.zeros(H, N, N)
    scale = hd ** -0.5
    got = wa.window_attention_qkv(qkv, bias, scale, H)
    for h in range(H):
        c0 = h * 3 * hd
        q, k, v = (qkv[0, :, c0 + s * hd:c0 + (s + 1) * hd] for s in range(3))
        want = torch.softmax(q @ k.T * scale, dim=-1) @ v
        torch.testing.assert_close(got[0, :, h * hd:(h + 1) * hd], want,
                                   atol=1e-5, rtol=1e-5)
    q, k, v = qkv[0].split(D, dim=-1)  # the q|k|v block reading
    block = torch.softmax(q[:, :hd] @ k[:, :hd].T * scale, dim=-1) @ v[:, :hd]
    assert (got[0, :, :hd] - block).abs().max() > 0.1


def test_layer_norm_uses_eps_1e5_and_f32_statistics():
    """Rows of near-constant bf16 values: eps 1e-5 dominates the variance,
    and the statistics are taken in f32 from the bf16 input."""
    rng = np.random.default_rng(4)
    base = rng.normal(0, 1, (4, 1)).astype(np.float32)
    x = torch.from_numpy(base + rng.normal(0, 3e-3, (4, 64)).astype(np.float32))
    x = x.to(torch.bfloat16)
    g = torch.ones(64)
    b = torch.zeros(64)
    got = wa._layer_norm_f32(x, g, b, 1e-5)
    assert got.dtype == torch.bfloat16
    xf = x.float().numpy().astype(np.float64)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    want = (xf - mu) / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)
    other = (xf - mu) / np.sqrt(var + 1e-6)
    assert np.abs(got.float().numpy() - other).max() > 0.1


def test_kernel_wrappers_take_only_cuda_tensors():
    """A wrapper never falls back: a CPU tensor is refused before any
    build or launch, and the launch counters do not move."""
    a = _t(_attn_inputs(2, 128, 64, 2))
    before = dict(wa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        wa._fused_block_cuda(*[a[k] for k in _K1_KEYS], 0.18, 2, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        wa._fb_s2_cuda(*[a[k] for k in _K2_KEYS], 0.18, 2, 1e-5)
    qkv = torch.zeros(2, 128, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        wa._attention_qkv_fused_cuda(qkv, a["bias"], 0.18, 2)
    assert wa.LAUNCHES == before


def test_build_target_tracks_source_and_flags(tmp_path, monkeypatch):
    """A library is rebuilt when its source changes: its file name carries
    a hash of the sources and the nvcc flags."""
    from geoguessr_ai_torch.ops import _build

    for name in _build.SIGNATURES:
        assert (_build.CSRC / f"{name}.cu").exists()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in ("attention_qkv.cu", "common.cuh"):
        (csrc / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    t0 = _build._target("attention_qkv")
    (csrc / "common.cuh").write_bytes(b"// edited\n" + (csrc / "common.cuh").read_bytes())
    t1 = _build._target("attention_qkv")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    t2 = _build._target("attention_qkv")
    assert len({t0, t1, t2}) == 3
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# Host and small device ops
# ---------------------------------------------------------------------------


def test_fused_preprocess_matches_jax():
    from geoguessr_ai_tpu.config import TINYVIT_NORM_MEAN, TINYVIT_NORM_STD
    from geoguessr_ai_tpu.ops.preprocess import fused_preprocess as jax_pre

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    assert C.TINYVIT_NORM_MEAN == TINYVIT_NORM_MEAN
    assert C.TINYVIT_NORM_STD == TINYVIT_NORM_STD
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(jax_pre(jnp.asarray(u8), TINYVIT_NORM_MEAN,
                              TINYVIT_NORM_STD, 64, dtype=jnp.float32))
    got = fused_preprocess(torch.from_numpy(u8), C.TINYVIT_NORM_MEAN,
                           C.TINYVIT_NORM_STD, 64, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    got_bf16 = fused_preprocess(torch.from_numpy(u8), C.TINYVIT_NORM_MEAN,
                                C.TINYVIT_NORM_STD, 64)
    assert got_bf16.dtype == torch.bfloat16


def test_fused_preprocess_resize_is_not_ported():
    """The resize branch, once refused here, against jax.image.resize:
    upscaling 32 x 48 and downscaling 80 x 96 (antialiased) to 64, with and
    without antialias, in f32 and as bf16."""
    from geoguessr_ai_tpu.ops.preprocess import fused_preprocess as jax_pre

    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    rng = np.random.default_rng(6)
    for h, w in ((32, 48), (80, 96)):
        u8 = rng.integers(0, 256, (2, 3, h, w, 3), dtype=np.uint8)
        for antialias in (False, True):  # True last: bf16 below uses it
            want = np.asarray(jax_pre(jnp.asarray(u8), (0.5,) * 3, (0.5,) * 3,
                                      64, dtype=jnp.float32,
                                      antialias=antialias))
            got = fused_preprocess(torch.from_numpy(u8), (0.5,) * 3,
                                   (0.5,) * 3, 64, dtype=torch.float32,
                                   antialias=antialias)
            assert got.shape == (2, 3, 64, 64, 3)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        bf16 = fused_preprocess(torch.from_numpy(u8), (0.5,) * 3, (0.5,) * 3,
                                64)
        assert bf16.dtype == torch.bfloat16
        np.testing.assert_allclose(bf16.float().numpy(), want, atol=1e-2)


def test_decode_jpeg_is_byte_equal_to_jax_pil_decode(fixtures_dir):
    """The port's PIL decode against the JAX package's, and each package's
    ``decode_jpeg`` (native libjpeg first, PIL where it is absent) against
    the other's."""
    from geoguessr_ai_tpu.data import pipeline as jax_pipeline

    from geoguessr_ai_torch.data import pipeline

    path = os.path.join(fixtures_dir, "heading=000.jpg")
    with open(path, "rb") as f:
        blob = f.read()
    for size in (512, 96):  # straight decode, and the bilinear resize
        got = pipeline._pil_decode(blob, size)
        want = jax_pipeline._pil_decode(blob, size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pipeline.decode_jpeg(blob, size),
                                      jax_pipeline.decode_jpeg(blob, size))


def test_haversine_matches_jax():
    from geoguessr_ai_tpu.geo.core import haversine as jax_haversine

    from geoguessr_ai_torch.geo.core import haversine

    rng = np.random.default_rng(6)
    pts = np.stack([rng.uniform(-180, 180, 64), rng.uniform(-90, 90, 64)],
                   -1).astype(np.float32)
    other = np.roll(pts, 1, axis=0)
    want = np.asarray(jax_haversine(jnp.asarray(pts), jnp.asarray(other)))
    got = haversine(torch.from_numpy(pts), torch.from_numpy(other)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    oslo_trondheim = haversine(torch.tensor([10.7522, 59.9139]),
                               torch.tensor([10.3951, 63.4305]))
    assert abs(float(oslo_trondheim) - 392.0) < 2.0


def test_decode_predictions_matches_jax_at_12647_cells():
    """argmax and the 12647-wide top-k; centroids come back (lng, lat)."""
    from geoguessr_ai_tpu.models.super_guessr import (
        decode_predictions as jax_decode,
    )

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.models.super_guessr import decode_predictions

    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    assert table.num_cells == 12647
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 3, (3, table.num_cells)).astype(np.float32)
    j_probs, j_preds, j_ll, j_top = jax_decode(
        jnp.asarray(logits), jnp.asarray(table.centroids), 5)
    probs, preds, ll, top = decode_predictions(
        torch.from_numpy(logits), torch.from_numpy(table.centroids), 5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs), atol=1e-7,
                               rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(j_preds))
    np.testing.assert_array_equal(ll.numpy(), np.asarray(j_ll))
    np.testing.assert_array_equal(top.indices.numpy(),
                                  np.asarray(j_top.indices))
    np.testing.assert_allclose(top.values.numpy(), np.asarray(j_top.values),
                               atol=1e-7, rtol=1e-5)
    np.testing.assert_array_equal(ll.numpy(),
                                  table.centroids[logits.argmax(-1)])


def _synthetic_bank(rng, cells=40, P=3, D=16):
    emb = rng.normal(0, 1, (cells, P, D)).astype(np.float32)
    coords = np.stack([rng.uniform(-20, 20, (cells, P)),
                       rng.uniform(40, 60, (cells, P))], -1).astype(np.float32)
    mask = (rng.uniform(size=(cells, P)) > 0.3).astype(np.float32)
    mask[0] = 0.0  # one cell without prototypes
    return emb, coords, mask


def test_refine_matches_jax():
    from geoguessr_ai_tpu.models.proto_refiner import refine as jax_refine

    from geoguessr_ai_torch.models.proto_refiner import refine

    rng = np.random.default_rng(8)
    emb, coords, mask = _synthetic_bank(rng)
    B, K = 12, 5
    ids = np.stack([rng.choice(40, K, replace=False) for _ in range(B)])
    ids[0, 0] = 0
    ids = ids.astype(np.int32)
    probs = rng.dirichlet(np.ones(K), B).astype(np.float32)
    query = (emb[ids[:, 1], 0] + rng.normal(0, 0.3, (B, 16))).astype(np.float32)
    init = np.stack([rng.uniform(-20, 20, B), rng.uniform(40, 60, B)],
                    -1).astype(np.float32)
    changed = {}
    for max_km in (1000.0, 300.0):
        want = jax_refine(*map(jnp.asarray, (emb, coords, mask, query, ids,
                                             probs, init)),
                          max_refinement_km=max_km)
        got = refine(*map(torch.from_numpy, (emb, coords, mask, query,
                                             ids.astype(np.int64), probs,
                                             init)),
                     max_refinement_km=max_km)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        changed[max_km] = int(got[2].sum())
    # the data exercises both outcomes of the refinement and of its gate
    assert 0 < changed[1000.0] < B and changed[300.0] < changed[1000.0]


def test_proto_refiner_and_try_refine(tmp_path, monkeypatch):
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.models import proto_refiner as pr
    from geoguessr_ai_torch.serving.engine import InferenceResult

    rng = np.random.default_rng(9)
    emb, coords, mask = _synthetic_bank(rng)
    bank = pr.PrototypeBank(emb, coords, mask)
    bank.save(str(tmp_path / "prototype_bank.npz"))
    loaded = pr.PrototypeBank.load(str(tmp_path / "prototype_bank.npz"))
    np.testing.assert_array_equal(loaded.embeddings, emb)

    refiner = pr.ProtoRefiner(loaded, device="cpu")
    ids = np.array([[3, 4, 5, 6, 7]])
    c, cells, changed = refiner(emb[4, :1], ids, np.full((1, 5), 0.2),
                                coords[4, :1])
    assert cells.shape == (1,) and c.shape == (1, 2)

    result = InferenceResult(lat=float(coords[4, 0, 1]),
                             lon=float(coords[4, 0, 0]), top_ids=[3, 4, 5],
                             top_probs=[0.4, 0.35, 0.25], top_countries=[],
                             top_admin1=[],
                             embedding=np.repeat(emb[4, :1], 4, axis=0))
    monkeypatch.setattr(C, "GEOCELL_DIR", str(tmp_path / "missing"))
    assert pr.try_refine(result, device="cpu") is None
    monkeypatch.setattr(C, "GEOCELL_DIR", str(tmp_path))
    lat, lon = pr.try_refine(result, device="cpu")
    assert np.isfinite([lat, lon]).all()
