"""The PyTorch port's CLIP guess path held against the JAX package.

Inputs come from numpy with a fixed seed and go through both functions on
the CPU, where each port op takes its plain PyTorch version:

* K6's and K11's plain versions against the Pallas kernels in interpret
  mode and against their XLA compositions, in f32 and bf16;
* both autograd ops' input gradients against ``jax.vjp`` of the JAX ops;
* one encoder layer and the whole ``CLIPVisionTower`` against flax, with
  weights carried by ``from_jax_variables``;
* the slice as a whole: the port's ``ServingEngine(backbone="clip")``
  against the JAX SuperGuessr over the CLIP embedding and
  ``decode_predictions`` at 12647 cells, on the four fixture views.

Shapes are narrow (``test_tiny``: D=64, H=2, hd=32, N=17; and hd=64 cases
with N=37 and N=50, the head dim the CUDA kernels take).  The kernels
themselves are held against the plain versions on the card in
tests/test_torch_port_cuda.py.
"""

import dataclasses
import functools
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import clip_vit as jcv
from geoguessr_ai_tpu.ops import clip_attention as jca

from geoguessr_ai_torch.models import clip_vit as tcv
from geoguessr_ai_torch.models.convert import (
    from_jax_variables,
    to_jax_variables,
)
from geoguessr_ai_torch.ops import clip_attention as ca

#: f32: the two frameworks sum the N-long softmax and p.v in other orders.
F32_ATOL, F32_RTOL = 1e-5, 1e-4
#: bf16, max |port - jax| / max |jax|: both round q.k^T's inputs, p and the
#: output to bf16 at the same points; a sum in another order can flip one
#: rounding, one bf16 ulp (2^-8) of the range at most.
BF16_REL = 2 ** -8

#: (B, N, D, H, head_block): test_tiny's hd=32; hd=64 at N=37 (84 px,
#: patch 14) and at N=50 (ViT-B/32's sequence), head blocks 2 and 4.
ATTN_CASES = [
    (2, 17, 64, 2, 2),
    (2, 37, 128, 2, 2),
    (2, 50, 256, 4, 2),
    (2, 50, 256, 4, 4),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _qkv_w(B, N, D, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (B, N, 3 * D)).astype(np.float32)
    w = rng.normal(0, D ** -0.5, (D, D)).astype(np.float32)
    return qkv, w


def _both(a, dtype):
    """The same numpy array as a JAX and a torch array of one dtype."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= BF16_REL, rel


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,N,D,H,hb", ATTN_CASES)
def test_flash_plain_matches_pallas_interpret_and_xla(B, N, D, H, hb, dtype):
    """K6: the port's plain version against _flash_pallas (interpret) and
    _flash_xla."""
    qkv, _ = _qkv_w(B, N, D)
    jq, tq = _both(qkv, dtype)
    scale = (D // H) ** -0.5
    got = ca._flash_plain(tq, scale, H)
    assert got.dtype == tq.dtype and got.shape == (B, N, D)
    _close(got, _np(jca._flash_pallas(jq, scale, H, hb, interpret=True)),
           dtype)
    _close(got, _np(jca._flash_xla(jq, scale, H)), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,N,D,H,hb", [ATTN_CASES[1], ATTN_CASES[3]])
def test_flash_proj_plain_matches_pallas_interpret_and_xla(B, N, D, H, hb,
                                                           dtype):
    """K11: the port's plain version against _flash_proj_pallas (interpret)
    and _flash_proj_xla."""
    qkv, w = _qkv_w(B, N, D, seed=1)
    jq, tq = _both(qkv, dtype)
    jw, tw = _both(w, dtype)
    scale = (D // H) ** -0.5
    got = ca._flash_proj_plain(tq, tw, scale, H)
    assert got.dtype == tq.dtype and got.shape == (B, N, D)
    _close(got, _np(jca._flash_proj_pallas(jq, jw, scale, H, hb,
                                           interpret=True)), dtype)
    _close(got, _np(jca._flash_proj_xla(jq, jw, scale, H)), dtype)


#: Gradients, max |port - jax| / max |jax|: f32 to summation order; bf16
#: also rounds the cotangents of p and of the GEMMs at other points.
GRAD_REL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["clip_attention", "clip_attention_proj"])
def test_op_gradients_match_jax_vjp(op, dtype):
    B, N, D, H = 2, 37, 128, 2
    qkv, w = _qkv_w(B, N, D, seed=2)
    g = np.random.default_rng(3).normal(0, 1, (B, N, D)).astype(np.float32)
    scale = (D // H) ** -0.5
    jq, tq = _both(qkv, dtype)
    jw, tw = _both(w, dtype)
    jg, tg = _both(g, dtype)
    if op == "clip_attention":
        jargs, targs = (jq,), [tq.requires_grad_()]
        jfn = lambda t: jca.clip_attention(t, scale, H, 2)  # noqa: E731
    else:
        jargs, targs = (jq, jw), [tq.requires_grad_(), tw.requires_grad_()]
        jfn = lambda t, u: jca.clip_attention_proj(t, u, scale, H, 2)  # noqa: E731
    out, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jg)
    got_out = getattr(ca, op)(*targs, scale, H, 2)
    _close(got_out, _np(out), dtype)
    got = torch.autograd.grad(got_out, targs, tg)
    for a, b in zip(got, want):
        assert a.dtype == targs[0].dtype
        b = _np(b)
        rel = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert rel <= GRAD_REL[dtype], rel


# ---------------------------------------------------------------------------
# Modules against flax.
# ---------------------------------------------------------------------------

#: test_tiny (hd=32) and a narrow hd=64 tower at 84 px (N=37).
TINY = dict(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128)
NARROW64 = dict(image_size=84, patch_size=14, hidden_size=128, num_layers=2,
                num_heads=2, mlp_dim=256)
#: module outputs in f32: summation order through two layers.
MODULE_ATOL, MODULE_RTOL = 1e-4, 1e-4
#: bf16 module outputs, max |port - jax| / max |jax|: every eager op of the
#: port rounds its output to bf16 where XLA may keep a fused chain (quick
#: GELU, GEMM + bias) in f32, a few bf16 ulps of the range.
MODULE_BF16_REL = 2e-2
#: bf16 embeddings: the cosine of the port's to flax's.
MODULE_BF16_COSINE = 0.9999


def _randomise(variables, seed=0):
    """Seeded random values for every leaf (biases and norm parameters
    included, which flax initialises to constants)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v)
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            # DenseGeneral: query/key/value (D, H, hd), out (H, hd, D)
            fan_in = (v.shape[0] * v.shape[1] if "'out'" in name
                      else v.shape[0] if v.ndim == 3
                      else v.size // v.shape[-1])
            return rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.normal(1.0, 0.1, v.shape).astype(np.float32)
        return rng.normal(0, 0.1, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _jax_cfg(dtype, **kw):
    return jcv.CLIPVisionConfig(dtype=DTYPES[dtype][1], **kw)


def _port_cfg(dtype, **kw):
    return tcv.CLIPVisionConfig(dtype=DTYPES[dtype][2], **kw)


def _flax_vars(module, x, seed=0):
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), x)
    return _randomise(jax.tree_util.tree_map(np.asarray, variables), seed)


@functools.lru_cache(maxsize=None)
def _tiny_tower_variables():
    """One seeded flax init of the test_tiny tower, shared read-only by the
    tests below (its f32 parameters do not depend on dtype or
    pallas_fuse_proj)."""
    jmod = jcv.CLIPVisionTower(_jax_cfg("f32", **TINY))
    return _flax_vars(jmod, jnp.zeros((1, 56, 56, 3)), seed=1)


@functools.lru_cache(maxsize=None)
def _narrow_layer_variables():
    """One seeded flax init of a NARROW64 encoder layer, shared read-only."""
    jmod = jcv.CLIPEncoderLayer(_jax_cfg("f32", **NARROW64))
    return _flax_vars(jmod, jnp.zeros((1, 37, 128)))


@pytest.mark.parametrize("fuse_proj", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encoder_layer_matches_flax(dtype, fuse_proj):
    kw = dict(NARROW64, pallas_fuse_proj=fuse_proj)
    jcfg, tcfg = _jax_cfg(dtype, **kw), _port_cfg(dtype, **kw)
    x = np.random.default_rng(4).normal(0, 1, (2, 37, 128)).astype(np.float32)
    jx, tx = _both(x, dtype)
    jmod = jcv.CLIPEncoderLayer(jcfg)
    variables = _narrow_layer_variables()
    want = _np(jax.jit(jmod.apply)(variables, jx))
    layer = tcv.CLIPEncoderLayer(tcfg)
    layer.load_state_dict(from_jax_variables(variables), strict=True)
    got = layer(tx, tcfg.dtype)
    assert got.dtype == tcfg.dtype
    got = got.detach().float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=MODULE_ATOL,
                                   rtol=MODULE_RTOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= MODULE_BF16_REL


def _cosines(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("fuse_proj", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vision_tower_matches_flax(dtype, fuse_proj):
    """last_hidden_state, the pooled CLS token and the mean-token
    embedding of test_tiny, with weights carried across strictly."""
    kw = dict(TINY, pallas_fuse_proj=fuse_proj)
    jcfg, tcfg = _jax_cfg(dtype, **kw), _port_cfg(dtype, **kw)
    px = np.random.default_rng(5).normal(0, 1, (2, 56, 56, 3)).astype(
        np.float32)
    jx, tx = _both(px, dtype)
    jmod = jcv.CLIPVisionTower(jcfg)
    variables = _tiny_tower_variables()

    @jax.jit
    def run(variables, x):
        out = jmod.apply(variables, x)
        return (out.last_hidden_state, out.pooler_output,
                jcv.clip_mean_token_embedding(out))

    want = [_np(a) for a in run(variables, jx)]
    tower = tcv.CLIPVisionTower(tcfg)
    tower.load_state_dict(from_jax_variables(variables), strict=True)
    out = tower(tx)
    got = [out.last_hidden_state, out.pooler_output,
           tcv.clip_mean_token_embedding(out)]
    assert got[0].dtype == tcfg.dtype and got[0].shape == (2, 17, 64)
    assert got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        if dtype == "f32":
            np.testing.assert_allclose(g, w, atol=MODULE_ATOL,
                                       rtol=MODULE_RTOL)
        else:
            assert np.abs(g - w).max() / np.abs(w).max() <= MODULE_BF16_REL
    if dtype == "bf16":
        assert _cosines(got[2].detach().numpy(), want[2]).min() \
            >= MODULE_BF16_COSINE


def test_quick_gelu_matches_jax():
    x = np.random.default_rng(6).normal(0, 3, (64,)).astype(np.float32)
    np.testing.assert_allclose(tcv.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jcv.quick_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_convert_carries_the_clip_tree_both_ways():
    """from_jax_variables -> to_jax_variables is the identity on the flax
    CLIP tree, leaf by leaf, DenseGeneral shapes included."""
    variables = _tiny_tower_variables()
    sd = from_jax_variables(variables)
    assert sd["layer0.self_attn.query.weight"].shape == (64, 64)
    assert sd["layer1.self_attn.out.bias"].shape == (64,)
    assert sd["position_embedding"].shape == (17, 64)
    assert sd["patch_embedding.weight"].shape == (64, 3, 14, 14)
    back = to_jax_variables(sd, num_heads=2)
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(v))
    with pytest.raises(ValueError, match="num_heads"):
        to_jax_variables(sd)


@pytest.mark.parametrize("option", ["pallas_attention", "quantize_gemms"])
def test_unported_clip_options_raise(option):
    """pallas_attention=False is not ported and raises; quantize_gemms is
    ported (tests/test_torch_port_quant.py) and builds."""
    value = option == "quantize_gemms"
    cfg = tcv.CLIPVisionConfig.test_tiny(**{option: value})
    if option == "quantize_gemms":
        tower = tcv.CLIPVisionTower(cfg).cast_weights_()
        assert tower.layer0.mlp_fc1.weight.dtype == torch.float32
        assert tower.layer0.self_attn.query.weight.dtype == torch.bfloat16
        return
    with pytest.raises(NotImplementedError, match=option):
        tcv.CLIPVisionTower(cfg)


def test_presets_and_backbones_match_the_jax_package():
    from geoguessr_ai_tpu import config as JC

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.train.coordinator import build_backbone

    for name in ("vit_l_14_336", "vit_b_32_224", "test_tiny"):
        j, t = getattr(jcv.CLIPVisionConfig, name)(), \
            getattr(tcv.CLIPVisionConfig, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.seq_len == j.seq_len
    assert tcv.CLIPVisionConfig().seq_len == 577
    for name in ("tinyvit", "clip", "clip_b32"):
        assert dataclasses.asdict(getattr(C.BackboneConfig, name)()) == \
            dataclasses.asdict(getattr(JC.BackboneConfig, name)())
    assert (C.CLIP_EMBED_DIM, C.CLIP_IMAGE_SIZE, C.CLIP_NORM_MEAN,
            C.CLIP_NORM_STD) == (JC.CLIP_EMBED_DIM, JC.CLIP_IMAGE_SIZE,
                                 JC.CLIP_NORM_MEAN, JC.CLIP_NORM_STD)
    for name, (size, dim, layers) in {"clip": (336, 1024, 24),
                                      "clip_b32": (224, 768, 12)}.items():
        with torch.device("meta"):  # the modules' shapes, no allocation
            bb, mean, std, image_size = build_backbone(
                getattr(C.BackboneConfig, name)())
        assert isinstance(bb, tcv.CLIPEmbed)
        assert (bb.config.image_size, bb.config.hidden_size,
                bb.config.num_layers, image_size) == (size, dim, layers, size)
        assert bb.config.dtype == torch.bfloat16
        assert (mean, std) == (C.CLIP_NORM_MEAN, C.CLIP_NORM_STD)


def test_clip_training_is_refused_until_its_slice():
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.config import BackboneConfig, ModelConfig, TrainConfig
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.train.coordinator import create_state, train

    cfg = TrainConfig(model=ModelConfig(backbone=BackboneConfig.clip(),
                                        embed_dim=1024))
    with pytest.raises(NotImplementedError, match="post_layernorm"):
        create_state(cfg, 10, 1, device="cpu")
    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    with pytest.raises(NotImplementedError, match="post_layernorm"):
        train(cfg, [], [], table, device="cpu")


def test_init_gives_the_clip_embeddings_flax_scale():
    from geoguessr_ai_torch.models.super_guessr import init_parameters_

    tower = tcv.CLIPEmbed(tcv.CLIPVisionConfig(
        image_size=224, patch_size=32, hidden_size=768, num_layers=1,
        num_heads=12, mlp_dim=3072, dtype=torch.float32))
    init_parameters_(tower, seed=0)
    for p in (tower.class_embedding, tower.position_embedding):
        assert abs(float(p.detach().std()) - 0.02) < 0.004
    assert abs(float(tower.layer0.mlp_fc1.weight.std()) - 768 ** -0.5) < 1e-3


# ---------------------------------------------------------------------------
# The slice as a whole.
# ---------------------------------------------------------------------------


class _JaxClipEmbed(jcv.CLIPVisionTower):
    """The JAX package's ``_ClipEmbed`` (train/coordinator.py) for any
    config: the tower's mean-token embedding."""

    def __call__(self, pixel_values, train: bool = False):
        return jcv.clip_mean_token_embedding(super().__call__(pixel_values))


@pytest.fixture(scope="module")
def clip_slice(fixtures_dir):
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models.super_guessr import (
        decode_predictions as jax_decode,
    )
    from geoguessr_ai_tpu.ops.preprocess import fused_preprocess as jax_pre

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.geocells.manager import CentroidTable

    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    jcfg = jcv.CLIPVisionConfig.test_tiny(dtype=jnp.float32)
    model = JaxSuperGuessr(num_cells=table.num_cells,
                           backbone=_JaxClipEmbed(jcfg), panorama=True,
                           embed_dim=jcfg.hidden_size)
    size = jcfg.image_size
    # the shared tower init under SuperGuessr's "backbone"; a cell layer
    # whose logits spread enough to separate the top-5
    rng = np.random.default_rng(7)
    variables = {"params": {
        "backbone": _tiny_tower_variables()["params"],
        "cell_layer": {
            "kernel": rng.normal(0, 0.3, (jcfg.hidden_size, table.num_cells)
                                 ).astype(np.float32),
            "bias": rng.normal(0, 0.1, (table.num_cells,)).astype(np.float32),
        }}}

    paths = sorted(glob.glob(os.path.join(fixtures_dir, "heading=*.jpg")))
    views = np.stack([decode_jpeg(open(p, "rb").read(), size) for p in paths])

    @jax.jit
    def serve(variables, u8, centroids):
        pixels = jax_pre(u8, C.CLIP_NORM_MEAN, C.CLIP_NORM_STD, size,
                         dtype=jnp.float32)
        emb, logits = model.apply(variables, pixel_values=pixels)
        _, _, lnglat, top = jax_decode(logits, centroids, 5)
        return emb, lnglat, top.values, top.indices

    want = [np.asarray(a) for a in serve(variables, jnp.asarray(views[None]),
                                         jnp.asarray(table.centroids))]
    return want, variables, table, views, paths


@pytest.mark.parametrize("fuse_proj", [False, True])
def test_clip_slice_matches_jax_on_the_fixture_panorama(clip_slice, fuse_proj):
    from geoguessr_ai_torch.serving.engine import ServingEngine

    (emb, lnglat, top_vals, top_idx), variables, table, views, _ = clip_slice
    engine = ServingEngine(
        backbone="clip", device="cpu", centroid_table=table,
        state_dict=from_jax_variables(variables),
        backbone_config=tcv.CLIPVisionConfig.test_tiny(
            dtype=torch.float32, pallas_fuse_proj=fuse_proj))
    assert engine.image_size == 56 and table.num_cells == 12647
    got = engine.predict_batch(views[None])[0]
    np.testing.assert_allclose(got.embedding, emb[0], atol=MODULE_ATOL,
                               rtol=MODULE_RTOL)
    np.testing.assert_allclose(got.top_probs, top_vals[0], atol=1e-5)
    assert got.top_ids == top_idx[0].tolist()
    assert abs(got.lat - float(lnglat[0, 1])) < 1e-4
    assert abs(got.lon - float(lnglat[0, 0])) < 1e-4


def test_clip_cli_serves_through_the_engine(clip_slice, monkeypatch, capsys):
    from geoguessr_ai_torch import inference
    from geoguessr_ai_torch.serving.engine import ServingEngine

    _, variables, table, _, paths = clip_slice
    built = []

    def engine(backbone, device, centroid_table):
        built.append((backbone, device))
        return ServingEngine(
            backbone=backbone, device=device, centroid_table=table,
            state_dict=from_jax_variables(variables),
            backbone_config=tcv.CLIPVisionConfig.test_tiny(
                dtype=torch.float32))

    monkeypatch.setattr(inference, "_get_engine", engine)
    inference.main(["--backbone", "clip", "--device", "cpu"] + paths)
    lat, lon = map(float, capsys.readouterr().out.split())
    assert built == [("clip", "cpu")]
    want = clip_slice[0][1][0]
    assert abs(lat - float(want[1])) < 1e-4 and abs(lon - float(want[0])) < 1e-4


def test_clip_engine_defaults_to_cuda_and_refuses_without_it():
    from geoguessr_ai_torch.serving.engine import ServingEngine

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(backbone="clip")
    with pytest.raises(ValueError, match="unknown backbone"):
        ServingEngine(backbone="clip_b32", device="cpu")
