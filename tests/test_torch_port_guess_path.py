"""The rest of the port's guess path held against the JAX package on the
CPU: the device resize, the positional table, hierarchical view fusion,
member-bank refinement, the checkpoint converters and loader, the SQLite
panorama table, the benchmark's metrics and entry point, and the HTTP
handlers.  Inputs are seeded numpy; widths are narrow (TinyViT
``test_tiny``, fusion at D = 64 with 16 heads of 4).
"""

import ast
import dataclasses
import glob
import os
import sqlite3
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leaves_equal(want, got, path=""):
    """Two nested dicts of arrays, the same keys and bitwise-equal leaves
    (dtype included)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), path
        for k in want:
            _leaves_equal(want[k], got[k], f"{path}/{k}")
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def _table(n=12, seed=3):
    from geoguessr_ai_torch.geocells.manager import CentroidTable

    rng = np.random.default_rng(seed)
    return CentroidTable(
        centroids=np.stack([rng.uniform(-170, 170, n), rng.uniform(-60, 70, n)],
                           -1).astype(np.float32),
        country=np.array([f"C{i}" for i in range(n)]),
        admin1=np.array([f"A{i}" for i in range(n)]),
        cell_id=np.array([str(i) for i in range(n)]))


# ---------------------------------------------------------------------------
# the device resize and the positional table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,out", [(480, 640, 512), (400, 300, 336),
                                     (512, 700, 336)])
def test_fused_preprocess_resize_matches_jax_image_resize(h, w, out):
    from geoguessr_ai_tpu.ops.preprocess import fused_preprocess as jax_pre

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    u8 = np.random.default_rng(h + w).integers(0, 256, (1, h, w, 3),
                                               dtype=np.uint8)
    # mean 0 / std 1 compares the resized [0, 1] values themselves
    for mean, std in (((0.0,) * 3, (1.0,) * 3),
                      (C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD)):
        want = np.asarray(jax_pre(jnp.asarray(u8), mean, std, out,
                                  dtype=jnp.float32))
        got = fused_preprocess(torch.from_numpy(u8), mean, std, out,
                               dtype=torch.float32).numpy()
        assert got.shape == want.shape == (1, out, out, 3)
        assert np.abs(got - want).max() <= (1e-5 if mean[0] == 0 else 5e-5)


def test_sinusoidal_table_matches_jax():
    """Within 1e-6 over the first 16 positions (fusion reads V <= 4).  XLA's
    f32 exp is not correctly rounded: a few div_term entries differ from
    torch's by one ulp, so an angle p * div_term differs by up to two f32
    epsilons (2.4e-7) of p, 6.1e-5 at position 999 of a 576-wide table."""
    from geoguessr_ai_tpu.models.positional import sinusoidal_table as jax_table

    from geoguessr_ai_torch.models.positional import sinusoidal_table

    table = jax.jit(jax_table, static_argnums=(0, 1))
    for max_len, d in ((1000, 576), (16, 64), (7, 5)):
        want = np.asarray(table(max_len, d))
        got = sinusoidal_table(max_len, d).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got[:16], want[:16], atol=1e-6, rtol=0)
        pos = np.arange(max_len)[:, None]
        assert (np.abs(got - want) <= 1e-6 + pos * 2.4e-7).all()


# ---------------------------------------------------------------------------
# hierarchical view fusion against flax
# ---------------------------------------------------------------------------

FUSION_D = 64
FUSION_CELLS = 24


def _fusion_pair(dtype, hierarchical=True, seed=0):
    """(flax SuperGuessr, its variables, the port's SuperGuessr with the
    same weights) in embedding mode."""
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr

    from geoguessr_ai_torch.models.convert import (
        from_jax_variables,
        to_jax_variables,
    )
    from geoguessr_ai_torch.models.super_guessr import SuperGuessr

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JaxSuperGuessr(num_cells=FUSION_CELLS, backbone=None, panorama=True,
                        hierarchical=hierarchical, embed_dim=FUSION_D,
                        num_attention_heads=16, dtype=jdt)
    pm = SuperGuessr(FUSION_CELLS, None, embed_dim=FUSION_D,
                     hierarchical=hierarchical, num_attention_heads=16,
                     dtype=dtype)
    # flax's tree (the port's names are flax's), seeded values
    v = to_jax_variables(pm.state_dict(), num_heads=16)
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.3, np.shape(a)).astype(np.float32), v)
    pm.load_state_dict(from_jax_variables(v), strict=True)
    return jm, v, pm.eval()


def _fusion_inputs(V, masked, seed=1):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (3, V, FUSION_D)).astype(np.float32)
    if not masked:
        return emb, None
    mask = np.ones((3, V), np.float32)
    mask[1, 1:] = 0.0  # one real view
    mask[2] = 0.0  # every view masked
    return emb, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["token0", "masked"])
def test_hierarchical_super_guessr_matches_flax(dtype, V, masked):
    """With a mask: the mean of the real views' attention outputs (the
    MicroBatcher path); without: token 0 (predict_images).  bf16: flax
    projects, scales q by 1 / sqrt(hd) and takes q.k in bf16."""
    jm, v, pm = _fusion_pair(dtype)
    emb, mask = _fusion_inputs(V, masked)
    apply = jax.jit(lambda v, e, m: jm.apply(v, embedding=e, view_mask=m)[1])
    want = apply(v, jnp.asarray(emb),
                 None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        _, got = pm(embedding=torch.from_numpy(emb),
                    view_mask=None if mask is None else torch.from_numpy(mask))
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if dtype == torch.float32:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
    else:
        for g, w in zip(got, want):
            assert _cosine(g, w) >= 0.999


def test_hierarchical_all_masked_row_gets_uniform_weights():
    """Masked keys take finfo(dtype).min, not -inf: a row whose views are
    all masked stays finite, with uniform weights, as flax's."""
    from geoguessr_ai_torch.models.super_guessr import ViewSelfAttention

    for dtype in (torch.float32, torch.bfloat16):
        attn = ViewSelfAttention(FUSION_D, 16, dtype=dtype, dropout_rate=0.0)
        x = torch.randn(1, 4, FUSION_D, generator=torch.Generator().manual_seed(0))
        none = torch.zeros(1, 4, dtype=torch.bool)
        with torch.no_grad():
            out = attn(x, none).float()
            # uniform weights: every query reads the mean of the values
            v = attn._proj(attn.value, x.to(dtype))
            want = attn._proj(attn.out, v.mean(dim=1, keepdim=True).to(dtype)
                              .expand_as(v)).float()
        assert torch.isfinite(out).all()
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(out, want, atol=tol, rtol=tol)


def test_hierarchical_masks_views_before_the_positional_encoding():
    """A masked view's embedding is zeroed before the positional table is
    added: whatever it holds, the logits do not move."""
    _, _, pm = _fusion_pair(torch.float32)
    emb, mask = _fusion_inputs(4, True)
    other = emb.copy()
    other[1, 1:] += 5.0
    with torch.no_grad():
        a = pm(embedding=torch.from_numpy(emb),
               view_mask=torch.from_numpy(mask))[1]
        b = pm(embedding=torch.from_numpy(other),
               view_mask=torch.from_numpy(mask))[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cast_weights_and_the_cached_table_keep_the_bits():
    """The engine stores the attention's projections in the compute dtype
    once and the table is built once: the logits do not move by a bit, the
    table is no state-dict entry and it follows the module's device."""
    from geoguessr_ai_torch.models.positional import sinusoidal_table

    _, _, pm = _fusion_pair(torch.bfloat16)
    emb, mask = _fusion_inputs(4, True)
    args = dict(embedding=torch.from_numpy(emb),
                view_mask=torch.from_numpy(mask))
    with torch.no_grad():
        before = pm(**args)[1]
        pm.self_attn.cast_weights_()
        after = pm(**args)[1]
    assert pm.self_attn.query.weight.dtype == torch.bfloat16
    assert pm.self_attn.out.bias.dtype == torch.bfloat16
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    assert not any(k.startswith("pos_encoder") for k in pm.state_dict())
    torch.testing.assert_close(pm.pos_encoder.table,
                               sinusoidal_table(1000, FUSION_D),
                               rtol=0, atol=0)
    assert pm.to("meta").pos_encoder.table.device.type == "meta"


def test_hierarchical_dropout_draws_from_the_generator():
    _, _, pm = _fusion_pair(torch.float32)
    emb = torch.from_numpy(_fusion_inputs(4, False)[0])
    pm.train()
    a = pm(embedding=emb, train=True,
           generator=torch.Generator().manual_seed(5))[1]
    b = pm(embedding=emb, train=True,
           generator=torch.Generator().manual_seed(5))[1]
    c = pm(embedding=emb, train=False)[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="Generator"):
        pm(embedding=emb, train=True)


def test_mean_fusion_and_single_image_embedding_modes_match_flax():
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr

    from geoguessr_ai_torch.models.convert import from_jax_variables
    from geoguessr_ai_torch.models.super_guessr import SuperGuessr

    emb, mask = _fusion_inputs(4, True)
    _, v, pm = _fusion_pair(torch.float32, hierarchical=False)
    jm = JaxSuperGuessr(num_cells=FUSION_CELLS, embed_dim=FUSION_D,
                        dtype=jnp.float32)
    want = np.asarray(jm.apply(v, embedding=jnp.asarray(emb),
                               view_mask=jnp.asarray(mask))[1])
    got = pm(embedding=torch.from_numpy(emb),
             view_mask=torch.from_numpy(mask))[1].detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    single = JaxSuperGuessr(num_cells=FUSION_CELLS, panorama=False,
                            embed_dim=FUSION_D)
    want = np.asarray(single.apply(v, embedding=jnp.asarray(emb[:, 0]))[1])
    pm1 = SuperGuessr(FUSION_CELLS, None, embed_dim=FUSION_D, panorama=False)
    pm1.load_state_dict(from_jax_variables(v))
    got = pm1(embedding=torch.from_numpy(emb[:, 0]))[1].detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# member-bank refinement
# ---------------------------------------------------------------------------


def _member_case(seed, projected):
    """A prototype bank, a member bank (float16 members when projected)
    and a batch whose nearest members beat the runner-up by a margin."""
    from geoguessr_ai_torch.models.proto_refiner import make_projection

    rng = np.random.default_rng(seed)
    cells, P, M, D = 30, 3, 6, 32
    Dr = 16 if projected else D
    emb = rng.normal(0, 1, (cells, P, D)).astype(np.float32)
    coords = np.stack([rng.uniform(-20, 20, (cells, P)),
                       rng.uniform(40, 60, (cells, P))], -1).astype(np.float32)
    mask = (rng.uniform(size=(cells, P)) > 0.2).astype(np.float32)
    mask[0] = 0.0  # a cell without prototypes
    proj = make_projection(D, Dr, seed=seed) if projected else None
    members = rng.normal(0, 1, (cells, P, M, Dr)).astype(
        np.float16 if projected else np.float32)
    # members lie within half a degree of their prototype
    mcoords = (coords[:, :, None, :]
               + rng.uniform(-0.5, 0.5, (cells, P, M, 2))).astype(np.float32)
    mmask = (rng.uniform(size=(cells, P, M)) > 0.3).astype(np.float32)
    mmask[1:6, :] = 0.0  # clusters without stored members
    B, K = 10, 5
    ids = np.stack([rng.choice(cells, K, replace=False)
                    for _ in range(B)]).astype(np.int32)
    ids[0, 0], ids[1, 0] = 0, 2
    probs = rng.dirichlet(np.ones(K), B).astype(np.float32)
    query = (emb[ids[:, 1], 0] + rng.normal(0, 0.3, (B, D))).astype(np.float32)
    init = np.stack([rng.uniform(-20, 20, B), rng.uniform(40, 60, B)],
                    -1).astype(np.float32)
    return (emb, coords, mask, query, ids, probs, init,
            members, mcoords, mmask, proj)


def _member_margin(case):
    """The smallest relative gap between the nearest and the second
    nearest stored member over every candidate's best prototype."""
    emb, _, mask, query, ids, *_, members, _, mmask, proj = case
    q = query if proj is None else query.astype(np.float64) @ proj
    d = np.linalg.norm(emb[ids] - query[:, None, None], axis=-1)
    d = np.where(mask[ids] > 0, d, np.inf)
    best_p = d.argmin(-1)
    gaps = []
    for b in range(ids.shape[0]):
        for k in range(ids.shape[1]):
            sel = mmask[ids[b, k], best_p[b, k]] > 0
            if sel.sum() < 2:
                continue
            md2 = ((members[ids[b, k], best_p[b, k]].astype(np.float64)
                    - q[b]) ** 2).sum(-1)[sel]
            lo, nxt = np.sort(md2)[:2]
            gaps.append((nxt - lo) / nxt)
    return min(gaps)


@pytest.mark.parametrize("projected", [False, True],
                         ids=["f32_members", "f16_projected"])
def test_refine_with_member_bank_matches_jax(projected):
    from geoguessr_ai_tpu.models.proto_refiner import refine as jax_refine

    from geoguessr_ai_torch.models.proto_refiner import refine

    case = _member_case(11 + projected, projected)
    # nearest members separated by >= 1e-3 of the distance: far above f32's
    # summation-order differences, so the argmin cannot tie
    assert _member_margin(case) >= 1e-3
    emb, coords, mask, query, ids, probs, init, members, mc, mm, proj = case
    kw = dict(member_emb=members, member_coords=mc, member_mask=mm,
              projection=proj)
    changed = {}
    jax_refine = jax.jit(jax_refine, static_argnames=("max_refinement_km",))
    for max_km in (1000.0, 300.0):
        want = jax_refine(*map(jnp.asarray, (emb, coords, mask, query, ids,
                                             probs, init)),
                          max_refinement_km=max_km,
                          **{k: None if a is None else jnp.asarray(a)
                             for k, a in kw.items()})
        got = refine(*map(torch.from_numpy, (emb, coords, mask, query,
                                             ids.astype(np.int64), probs,
                                             init)),
                     max_refinement_km=max_km,
                     **{k: None if a is None else torch.from_numpy(a)
                        for k, a in kw.items()})
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-6, rtol=0)
        changed[max_km] = int(got[2].sum())
        if max_km == 1000.0:
            # the member stage moved guesses off the prototype centroids
            plain = refine(*map(torch.from_numpy, (emb, coords, mask, query,
                                                   ids.astype(np.int64),
                                                   probs, init)),
                           max_refinement_km=max_km)
            assert not np.allclose(plain[0].numpy(), got[0].numpy())
    assert 0 < changed[1000.0] < ids.shape[0]


def test_project_f32_ignores_the_tf32_switch():
    from geoguessr_ai_torch.models.proto_refiner import project_f32

    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (4, 96)).astype(np.float32)
    p = rng.normal(0, 1, (96, 16)).astype(np.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = project_f32(torch.from_numpy(q), torch.from_numpy(p)).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    want = q.astype(np.float64) @ p.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_make_projection_is_bitwise_the_jax_packages():
    from geoguessr_ai_tpu.models.proto_refiner import (
        make_projection as jax_projection,
    )

    from geoguessr_ai_torch.models.proto_refiner import make_projection

    for d, r, seed in ((576, 64, 0), (64, 16, 3)):
        want, got = jax_projection(d, r, seed), make_projection(d, r, seed)
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    assert make_projection(64, 64) is None and make_projection(64, 80) is None


def test_member_bank_save_load_and_proto_refiner(tmp_path, monkeypatch):
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.models import proto_refiner as pr
    from geoguessr_ai_torch.serving.engine import InferenceResult

    case = _member_case(13, True)
    emb, coords, mask, query, ids, probs, init, members, mc, mm, proj = case
    pr.PrototypeBank(emb, coords, mask).save(str(tmp_path / "prototype_bank.npz"))
    pr.MemberBank(members, mc, mm, proj).save(
        str(tmp_path / "prototype_member_bank.npz"))
    loaded = pr.MemberBank.load(str(tmp_path / "prototype_member_bank.npz"))
    assert loaded.embeddings.dtype == np.float16
    np.testing.assert_array_equal(loaded.projection, proj)
    pr.MemberBank(members, mc, mm).save(str(tmp_path / "no_proj.npz"))
    assert pr.MemberBank.load(str(tmp_path / "no_proj.npz")).projection is None

    refiner = pr.ProtoRefiner(pr.PrototypeBank(emb, coords, mask),
                              member_bank=loaded, device="cpu")
    got = refiner(query, ids, probs, init)
    want = pr.refine(*map(torch.from_numpy, (emb, coords, mask, query,
                                             ids.astype(np.int64), probs,
                                             init)),
                     member_emb=torch.from_numpy(members),
                     member_coords=torch.from_numpy(mc),
                     member_mask=torch.from_numpy(mm),
                     projection=torch.from_numpy(proj))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())

    # try_refine reads the member bank beside the prototype bank
    result = InferenceResult(lat=float(init[0, 1]), lon=float(init[0, 0]),
                             top_ids=ids[0].tolist(),
                             top_probs=probs[0].tolist(), top_countries=[],
                             top_admin1=[], embedding=np.repeat(
                                 query[:1], 4, axis=0))
    monkeypatch.setattr(C, "GEOCELL_DIR", str(tmp_path))
    pr._default_refiner.cache_clear()
    lat, lon = pr.try_refine(result, device="cpu")
    assert (lon, lat) == tuple(float(x) for x in got[0][0])
    pr._default_refiner.cache_clear()


def test_build_prototype_bank_is_bitwise_the_jax_packages():
    import pandas as pd

    from geoguessr_ai_tpu.models.proto_refiner import (
        build_prototype_bank as jax_build,
    )

    from geoguessr_ai_torch.models.proto_refiner import build_prototype_bank

    rng = np.random.default_rng(4)
    n_images, D = 60, 16
    embs = {i: rng.normal(0, 1, D).astype(np.float32)
            for i in range(n_images) if i % 7}  # some rows lack embeddings
    crd = {i: (float(rng.uniform(-20, 20)), float(rng.uniform(40, 60)))
           for i in range(n_images) if i % 5}
    rows = []
    for c in range(6):
        for k in range(c % 4 + (2 if c == 3 else 0)):  # cell 3: 5 clusters
            idx = rng.choice(n_images, rng.integers(1, 6), replace=False)
            rows.append({"geocell_index": c, "cluster_id": k,
                         "count": int(rng.integers(1, 40)),
                         "indices": (str([int(i) for i in idx]) if k % 2
                                     else [int(i) for i in idx]),
                         "centroid_lat": float(rng.uniform(40, 60)),
                         "centroid_lng": float(rng.uniform(-20, 20))})
    rows.append({"geocell_index": 5, "cluster_id": 9, "count": 1,
                 "indices": [7, 14], "centroid_lat": 45.0,
                 "centroid_lng": 3.0})  # no member has an embedding
    want = jax_build(pd.DataFrame(rows), embs, crd, 8, D, max_protos=4)
    got = build_prototype_bank(rows, embs, crd, 8, D, max_protos=4)
    for name in ("embeddings", "coords", "mask"):
        _leaves_equal(getattr(want, name), getattr(got, name), name)
    # cell 3 keeps the largest four of its five clusters
    assert (got.coords[3] != 0).all(-1).sum() == 4


# ---------------------------------------------------------------------------
# checkpoint converters, leaf for leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["test_tiny", "tiny_vit_21m_512"])
def test_tinyvit_converters_are_bitwise_the_jax_packages(preset):
    from geoguessr_ai_tpu.models import torch_convert as jtc
    from geoguessr_ai_tpu.models.tinyvit import TinyViTConfig as JaxConfig
    from geoguessr_ai_tpu.models.torch_tinyvit_ref import (
        synthetic_timm_state_dict,
    )

    from geoguessr_ai_torch.models import torch_convert as ptc
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig

    jcfg, pcfg = getattr(JaxConfig, preset)(), getattr(TinyViTConfig, preset)()
    sd = synthetic_timm_state_dict(jcfg, seed=2)
    want = jtc.tinyvit_from_timm(sd, jcfg)
    got = ptc.tinyvit_from_timm(sd, pcfg)
    _leaves_equal(want, got)
    _leaves_equal(jtc.tinyvit_to_timm(want, jcfg),
                  ptc.tinyvit_to_timm(got, pcfg))
    _leaves_equal(sd, ptc.tinyvit_to_timm(got, pcfg))


def _hf_clip_state_dict(cfg, seed=0, prefix="vision_model."):
    """Random HF CLIPVisionModel entries: the keys clip_vision_from_hf
    reads, at ``cfg``'s shapes."""
    rng = np.random.default_rng(seed)
    D, F = cfg.hidden_size, cfg.mlp_dim

    def r(*shape):
        return rng.normal(0, 0.05, shape).astype(np.float32)

    sd = {"embeddings.patch_embedding.weight": r(D, 3, cfg.patch_size,
                                                 cfg.patch_size),
          "embeddings.class_embedding": r(D),
          "embeddings.position_embedding.weight": r(cfg.seq_len, D)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = 1 + r(D), r(D)
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}."
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}self_attn.{p}.weight"] = r(D, D)
            sd[f"{pre}self_attn.{p}.bias"] = r(D)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{pre}{ln}.weight"], sd[f"{pre}{ln}.bias"] = 1 + r(D), r(D)
        sd[f"{pre}mlp.fc1.weight"], sd[f"{pre}mlp.fc1.bias"] = r(F, D), r(F)
        sd[f"{pre}mlp.fc2.weight"], sd[f"{pre}mlp.fc2.bias"] = r(D, F), r(D)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["vision_model.", ""])
def test_clip_converter_is_bitwise_the_jax_packages(prefix):
    from geoguessr_ai_tpu.models.clip_vit import CLIPVisionConfig as JaxConfig
    from geoguessr_ai_tpu.models.torch_convert import (
        clip_vision_from_hf as jax_convert,
    )

    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.models.torch_convert import clip_vision_from_hf

    pcfg = CLIPVisionConfig.test_tiny()
    sd = _hf_clip_state_dict(pcfg, prefix=prefix)
    _leaves_equal(jax_convert(sd, JaxConfig.test_tiny()),
                  clip_vision_from_hf(sd, pcfg))


def test_head_converters_are_bitwise_the_jax_packages():
    from geoguessr_ai_tpu.models import torch_convert as jtc

    from geoguessr_ai_torch.models import torch_convert as ptc

    rng = np.random.default_rng(7)
    D, H, n = 64, 16, 10
    sd = {"cell_layer.weight": rng.normal(size=(n, D)).astype(np.float32),
          "cell_layer.bias": rng.normal(size=n).astype(np.float32),
          "self_attn.in_proj_weight": rng.normal(size=(3 * D, D)).astype(
              np.float32),
          "self_attn.in_proj_bias": rng.normal(size=3 * D).astype(np.float32),
          "self_attn.out_proj.weight": rng.normal(size=(D, D)).astype(
              np.float32),
          "self_attn.out_proj.bias": rng.normal(size=D).astype(np.float32)}
    for cells in (None, n, n + 1):  # n + 1: the cell layer is filtered out
        want = jtc.super_guessr_head_from_reference(sd, cells, H)
        got = ptc.super_guessr_head_from_reference(sd, cells, H)
        _leaves_equal(want, got)
        assert ("cell_layer" in got) == (cells != n + 1)
    head = ptc.super_guessr_head_from_reference(sd, n, H)
    _leaves_equal(jtc.super_guessr_head_to_reference(head, H),
                  ptc.super_guessr_head_to_reference(head, H))
    _leaves_equal(sd, ptc.super_guessr_head_to_reference(head, H))


# ---------------------------------------------------------------------------
# serving a .pt written by the JAX package's exporters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A hierarchical test_tiny SuperGuessr in the JAX package (f32,
    randomised), written to a reference .pt by its exporters (the layout of
    tools/export_checkpoint.py), and its logits on seeded views."""
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models.tinyvit import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.models.tinyvit import TinyViTConfig as JaxConfig
    from geoguessr_ai_tpu.models.torch_convert import (
        super_guessr_head_to_reference,
        tinyvit_to_timm,
    )

    from geoguessr_ai_torch import config as C

    from geoguessr_ai_torch.models.convert import to_jax_variables
    from geoguessr_ai_torch.models.super_guessr import SuperGuessr
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    table = _table()
    # the plain attention (the kernels are held elsewhere): what is tested
    # here is the checkpoint's way into the port
    jcfg = JaxConfig.test_tiny(dtype=jnp.float32, pallas_attention_stages=(),
                               fused_block_stages=(),
                               fused_block_noproj_stages=())
    model = JaxSuperGuessr(num_cells=table.num_cells, backbone=JaxTinyViT(jcfg),
                           hierarchical=True, embed_dim=jcfg.embed_dim,
                           dtype=jnp.float32)
    # the flax tree's layout without a flax init: the port model's names
    # and shapes are flax's (models/convert.py)
    shapes = SuperGuessr(table.num_cells, TinyViT(TinyViTConfig.test_tiny()),
                         embed_dim=jcfg.embed_dim, hierarchical=True)
    v = to_jax_variables(shapes.state_dict(),
                         num_heads=C.NUM_ATTENTION_HEADS)
    rng = np.random.default_rng(1)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
        return rng.normal(0.0 if "'scale'" not in name else 1.0,
                          0.05 if "kernel" in name else 0.1,
                          np.shape(a)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, v)
    sd = super_guessr_head_to_reference(v["params"], C.NUM_ATTENTION_HEADS)
    bb = tinyvit_to_timm({"params": v["params"]["backbone"],
                          "batch_stats": v["batch_stats"]["backbone"]}, jcfg)
    sd.update({f"base_model.backbone.{k}": a for k, a in bb.items()})
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(a)
                                     for k, a in sd.items()}}, path)
    u8 = np.random.default_rng(2).integers(0, 256, (2, 4, 64, 64, 3),
                                           dtype=np.uint8)
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    pixels = (u8.astype(np.float32) / 255.0 - np.asarray(C.TINYVIT_NORM_MEAN,
                                                         np.float32)) \
        / np.asarray(C.TINYVIT_NORM_STD, np.float32)
    logits = {m: np.asarray(jax.jit(lambda v, x, mm: model.apply(
        v, pixel_values=x, view_mask=mm)[1])(
            v, jnp.asarray(pixels), None if m is None else jnp.asarray(mask)))
        for m in (None, "mask")}
    return path, table, u8, mask, logits


def _tiny_engine(table, **kw):
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    return ServingEngine(device="cpu", centroid_table=table,
                         backbone_config=TinyViTConfig.test_tiny(
                             dtype=torch.float32), **kw)


def test_engine_serves_a_pt_written_by_the_jax_exporters(exported):
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    path, table, u8, mask, logits = exported
    engine = _tiny_engine(table, checkpoint=path, hierarchical=True)
    assert engine.loaded == {"head": 2, "backbone": True}
    pixels = fused_preprocess(torch.from_numpy(u8), C.TINYVIT_NORM_MEAN,
                              C.TINYVIT_NORM_STD, 64, dtype=torch.float32)
    with torch.no_grad():
        for m, want in logits.items():
            got = engine.model(pixels, view_mask=None if m is None
                               else torch.from_numpy(mask))[1].numpy()
            for g, w in zip(got, want):
                assert _cosine(g, w) >= 0.9999
            top = engine.predict_batch(u8, None if m is None else mask)
            assert [r.top_ids[0] for r in top] == want.argmax(-1).tolist()


def test_engine_checkpoint_filters_the_head_and_skips_a_bad_backbone(
        exported, tmp_path, caplog):
    from geoguessr_ai_torch.train.checkpoints import load_torch_checkpoint

    path, table, *_ = exported
    sd = load_torch_checkpoint(path)
    # a mean-fusion engine takes the cell layer and the backbone only
    engine = _tiny_engine(table, checkpoint=path)
    assert engine.loaded == {"head": 1, "backbone": True}
    np.testing.assert_array_equal(
        engine.model.cell_layer.weight.detach().numpy(),
        sd["cell_layer.weight"])
    # a table of another size: the cell layer keeps its seeded weights
    seeded = _tiny_engine(_table(13))
    other = _tiny_engine(_table(13), checkpoint=path)
    assert other.loaded == {"head": 0, "backbone": True}
    np.testing.assert_array_equal(
        other.model.cell_layer.weight.detach().numpy(),
        seeded.model.cell_layer.weight.detach().numpy())
    # a backbone whose conversion misses a key is skipped with a warning,
    # as in JAX; so is one without the optional head norm: none of its
    # entries load
    seeded = _tiny_engine(table)
    for drop, warning in (("patch_embed.conv1.conv.weight",
                           "backbone conversion skipped"),
                          ("head.norm.weight", "lacks 2 entries")):
        broken = {k: torch.from_numpy(v) for k, v in sd.items()
                  if not k.endswith(drop)}
        broken_path = str(tmp_path / "broken.pt")
        torch.save(broken, broken_path)  # a bare state dict, not wrapped
        caplog.clear()
        with caplog.at_level("WARNING", logger="geoguessr_ai_torch"):
            e = _tiny_engine(table, checkpoint=broken_path)
        assert e.loaded == {"head": 1, "backbone": False}
        assert warning in caplog.text
        _backbone_is_seeded(e, seeded)


def _backbone_is_seeded(engine, seeded):
    want = seeded.model.backbone.state_dict()
    got = engine.model.backbone.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_engine_skips_a_backbone_of_another_width(tmp_path, caplog):
    """A checkpoint of a TinyViT whose third stage is narrower converts
    without a KeyError, and most of its entries fit: the engine still loads
    none of them (the JAX engine takes the whole tree or none), and the
    head, whose width matches, loads."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.models.convert import to_jax_variables
    from geoguessr_ai_torch.models.super_guessr import (
        SuperGuessr,
        init_parameters_,
    )
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig
    from geoguessr_ai_torch.models.torch_convert import (
        super_guessr_head_to_reference,
        tinyvit_to_timm,
    )

    table = _table()
    other = dataclasses.replace(TinyViTConfig.test_tiny(dtype=torch.float32),
                                embed_dims=(16, 32, 48, 80))
    model = SuperGuessr(table.num_cells, TinyViT(other),
                        embed_dim=other.embed_dim)
    init_parameters_(model, seed=7)
    v = to_jax_variables(model.state_dict(), num_heads=C.NUM_ATTENTION_HEADS)
    sd = super_guessr_head_to_reference(v["params"], C.NUM_ATTENTION_HEADS)
    bb = tinyvit_to_timm({"params": v["params"]["backbone"],
                          "batch_stats": v["batch_stats"]["backbone"]}, other)
    sd.update({f"base_model.backbone.{k}": a for k, a in bb.items()})
    path = str(tmp_path / "other.pt")
    torch.save({k: torch.from_numpy(a) for k, a in sd.items()}, path)
    with caplog.at_level("WARNING", logger="geoguessr_ai_torch"):
        engine = _tiny_engine(table, checkpoint=path)
    assert engine.loaded == {"head": 1, "backbone": False}
    assert "another shape" in caplog.text
    _backbone_is_seeded(engine, _tiny_engine(table))
    np.testing.assert_array_equal(
        engine.model.cell_layer.weight.detach().numpy(),
        sd["cell_layer.weight"])


def test_load_torch_checkpoint_unpickles_no_code(tmp_path):
    """Only tensors and plain containers load: a pickled object of another
    type is refused before it is built."""
    import pickle

    from geoguessr_ai_torch.train.checkpoints import load_torch_checkpoint

    path = str(tmp_path / "x.pt")
    torch.save({"model_state_dict": {"w": torch.ones(2)}, "step": 3}, path)
    assert list(load_torch_checkpoint(path)) == ["w"]
    torch.save({"w": torch.ones(2), "obj": _Unsafe()}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_torch_checkpoint(path)


class _Unsafe:
    pass


def test_clip_engine_loads_an_hf_vision_checkpoint(tmp_path):
    from geoguessr_ai_torch.models.clip_vit import CLIPVisionConfig
    from geoguessr_ai_torch.serving.engine import ServingEngine

    cfg = CLIPVisionConfig.test_tiny(dtype=torch.float32)
    sd = _hf_clip_state_dict(cfg, prefix="base_model.vision_model.")
    path = str(tmp_path / "clip.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    engine = ServingEngine(backbone="clip", device="cpu", checkpoint=path,
                           centroid_table=_table(), backbone_config=cfg)
    assert engine.loaded == {"head": 0, "backbone": True}
    np.testing.assert_array_equal(
        engine.model.backbone.position_embedding.detach().numpy(),
        sd["base_model.vision_model.embeddings.position_embedding.weight"])


def test_predict_batch_resizes_views_on_the_device(exported):
    """Views decoded at another size reach the model resized by
    fused_preprocess, the JAX engine's path."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.ops.preprocess import fused_preprocess

    path, table, u8, mask, _ = exported
    engine = _tiny_engine(table, checkpoint=path, hierarchical=True)
    big = np.repeat(np.repeat(u8, 3, axis=2), 2, axis=3)  # 192 x 128
    got = engine.predict_batch(big, mask)
    pixels = fused_preprocess(torch.from_numpy(big), C.TINYVIT_NORM_MEAN,
                              C.TINYVIT_NORM_STD, 64, dtype=torch.float32)
    with torch.no_grad():
        emb, _ = engine.model(pixels, view_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(np.stack([r.embedding for r in got]),
                               emb.numpy(), rtol=1e-6, atol=1e-6)


def test_cli_finds_the_checkpoints_centroid_sidecar(exported, tmp_path,
                                                    monkeypatch, caplog):
    from geoguessr_ai_torch import inference

    path, table, *_ = exported
    ckpt = str(tmp_path / "m.pt")
    os.link(path, ckpt)
    assert inference.checkpoint_centroid_table(None, None) is None
    with caplog.at_level("WARNING", logger="geoguessr_ai_torch"):
        assert inference.checkpoint_centroid_table(ckpt, None) is None
    assert "without a matching centroid table" in caplog.text
    table.save(ckpt + "_centroids.npz")
    assert inference.checkpoint_centroid_table(ckpt, None) == \
        ckpt + "_centroids.npz"
    assert inference.checkpoint_centroid_table(ckpt, "t.npz") == "t.npz"

    built = []
    monkeypatch.setattr(inference, "_get_engine",
                        lambda *a, **k: built.append((a, k))
                        or _tiny_engine(table))
    inference.main(["--device", "cpu", "--checkpoint", ckpt])
    assert built == [(("tinyvit", "cpu", None), {"checkpoint": ckpt})]


# ---------------------------------------------------------------------------
# the SQLite panorama table, the metrics and the benchmark
# ---------------------------------------------------------------------------


def _fixture_sqlite(path, fixtures_dir, n_locations=30, seed=0):
    from geoguessr_ai_torch.data.sqlite_dataset import (
        create_sqlite_from_records,
    )

    blobs = [open(p, "rb").read() for p in sorted(
        glob.glob(os.path.join(fixtures_dir, "heading=*.jpg")))]
    rng = np.random.default_rng(seed)
    recs = []
    for i in rng.permutation(n_locations):  # out of location order
        lat, lon = rng.uniform(-60, 70), rng.uniform(-170, 170)
        views = 4 if i % 5 else 2  # some panoramas have two views
        for h in rng.permutation(views):
            recs.append({"location_id": f"loc{i:03d}", "lat": lat,
                         "lon": lon, "heading": int(90 * h),
                         "image": blobs[h]})
    create_sqlite_from_records(path, recs)
    return path


def test_panorama_table_and_split_match_jax(fixtures_dir, tmp_path):
    from geoguessr_ai_tpu.data import sqlite_dataset as jsd

    from geoguessr_ai_torch.data import sqlite_dataset as psd

    path = _fixture_sqlite(str(tmp_path / "d.sqlite"), fixtures_dir)
    want = jsd.load_sqlite_panorama_dataset(path)
    got = psd.load_sqlite_panorama_dataset(path)
    assert len(got) == len(want) == 30
    for w, g in zip(want.itertuples(index=False), got):
        assert (g.location_id, g.lat, g.lon, g.headings, g.images) == (
            w.location_id, w.lat, w.lon, w.headings, w.images)
    for f in (0.1, 0.25, 0.5):
        jt, jv = jsd.split_train_val(want, f)
        pt, pv = psd.split_train_val(got, f)
        assert [r.location_id for r in pt] == jt["location_id"].tolist()
        assert [r.location_id for r in pv] == jv["location_id"].tolist()
    # a row without a blob is left out; dict rows are read as well
    rows = [dict(location_id="b", lat=1.0, lon=2.0, heading=90, image=b"y"),
            dict(location_id="b", lat=1.0, lon=2.0, heading=0, image=None),
            dict(location_id="a", lat=3.0, lon=4.0, heading=0, image=b"x")]
    import pandas as pd

    want = jsd.build_panorama_table(pd.DataFrame(rows))
    got = psd.build_panorama_table(rows)
    assert [tuple(r) for r in got] == [
        tuple(r) for r in want.itertuples(index=False)]
    with pytest.raises(ValueError, match="missing columns"):
        psd.build_panorama_table([dict(location_id="a", lat=1.0)])


def test_benchmark_metrics_match_jax():
    from geoguessr_ai_tpu.eval import metrics as jm

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.eval import metrics as pm

    assert C.EARTH_RADIUS_BENCH_M == 6371000.0
    rng = np.random.default_rng(0)
    pts = rng.uniform((-90, -180, -90, -180), (90, 180, 90, 180), (50, 4))
    want = jm.haversine_km_np(*pts.T)
    got = pm.haversine_km_np(*pts.T)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pm.geoguessr_score_np(got),
                                  jm.geoguessr_score_np(want))
    recs = [{"distance_km": float(d), "score": float(s), "top1_prob": 0.1 * i}
            for i, (d, s) in enumerate(zip(got, pm.geoguessr_score_np(got)))]
    assert pm.summarize_results(recs) == jm.summarize_results(recs)
    empty = pm.summarize_results([])
    assert empty["num_samples"] == 0 and np.isnan(empty["avg_score"])


def test_run_benchmark_records_are_the_engines_predictions(
        exported, fixtures_dir, tmp_path, monkeypatch):
    import json

    import pandas as pd  # noqa: F401  (the JAX dataset reader needs it)

    from geoguessr_ai_tpu.data import sqlite_dataset as jsd

    from geoguessr_ai_torch import run_benchmark as rb
    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.data.sqlite_dataset import (
        load_sqlite_panorama_dataset,
    )

    path, table, *_ = exported
    db = _fixture_sqlite(str(tmp_path / "d.sqlite"), fixtures_dir,
                         n_locations=40)
    # the JAX script's sample: rng.choice over the last 10 %, in order
    _, test = jsd.split_train_val(jsd.load_sqlite_panorama_dataset(db), 0.1)
    idx = np.random.default_rng(5).choice(len(test), 3, replace=False)
    want_ids = test.iloc[sorted(idx)]["location_id"].tolist()
    sample = rb.sample_panoramas(load_sqlite_panorama_dataset(db), 3, seed=5)
    assert [p.location_id for p in sample] == want_ids

    from geoguessr_ai_torch.serving import engine as serving

    engine = _tiny_engine(table, checkpoint=path, hierarchical=True)
    built = []
    monkeypatch.setattr(serving, "ServingEngine",
                        lambda **kw: built.append(kw) or engine)
    out = str(tmp_path / "out" / "results.json")
    summary = rb.run_benchmark(num_samples=3, sqlite_path=db, output_path=out,
                               batch_size=2, seed=5, checkpoint=path,
                               device="cpu")
    assert built == [dict(backbone="tinyvit", checkpoint=path,
                          centroid_table=None, device="cpu")]
    records = json.load(open(out))
    assert records[-1] == summary and summary["num_samples"] == 3
    assert np.isfinite(summary["avg_distance_km"])
    for rec, pano in zip(records[:-1], sample):
        views = np.zeros((1, 4, 64, 64, 3), np.uint8)
        mask = np.zeros((1, 4), np.float32)
        for v, blob in enumerate(pano.images):
            views[0, v], mask[0, v] = decode_jpeg(blob, 64), 1.0
        r = engine.predict_batch(views, mask)[0]
        assert rec["location_id"] == pano.location_id
        assert (rec["pred_lat"], rec["pred_lon"]) == (r.lat, r.lon)
        assert [t["geocell_index"] for t in rec["top5"]] == r.top_ids
        assert rec["top1_prob"] == pytest.approx(r.top_probs[0], rel=1e-6)
        assert abs(rec["gt_lat"] - pano.lat) < 1e-4


# ---------------------------------------------------------------------------
# the HTTP handlers
# ---------------------------------------------------------------------------


class _FakeResult:
    lat, lon = 59.9, 10.7
    top_ids, top_probs = [1, 2], [0.6, 0.2]
    top_countries, top_admin1 = ["Norway", "Sweden"], ["Oslo", "Stockholm"]
    embedding = np.zeros(8)


class _FakeEngine:
    image_size = 64

    class table:
        num_cells = 42

    def __init__(self):
        self.rows = 0
        self.lock = threading.Lock()

    def predict_batch(self, views, view_mask=None):
        with self.lock:
            self.rows += views.shape[0]
        return [_FakeResult() for _ in range(views.shape[0])]


def test_api_handlers_submit_predict_cache_404_and_alias(fixtures_dir):
    from geoguessr_ai_torch.serving.api import ApiError, GuessApi

    eng = _FakeEngine()
    api = GuessApi(engine=eng)
    assert api.health() == {"status": "ok"}
    assert "/submit_image/" in api.root()["endpoints"]
    assert api.model_info("m") == {"model_id": "m", "backbone": "tinyvit",
                                   "num_cells": 42, "image_size": 64}
    blob = open(os.path.join(fixtures_dir, "heading=000.jpg"), "rb").read()
    with pytest.raises(ApiError) as e:
        api.submit_image([blob, blob])
    assert e.value.status == 400
    sid = api.submit_image([blob])["submission_id"]
    pred = api.prediction(sid)
    assert pred["lat"] == 59.9 and pred["top"][0]["country"] == "Norway"
    api.warmup_thread.join()
    rows = eng.rows
    assert api.prediction(sid) is pred  # cached: no second device predict
    assert api.predicition(sid) is pred  # the reference's alias
    assert eng.rows == rows
    assert api.image(sid) == blob
    for handler in (api.prediction, api.predicition, api.image):
        with pytest.raises(ApiError) as e:
            handler(999)
        assert e.value.status == 404
    bad = api.submit_image([b"not a jpeg"])["submission_id"]
    with pytest.raises(ApiError) as e:
        api.prediction(bad)
    assert e.value.status == 400


def test_api_concurrent_polls_of_one_submission_predict_once(fixtures_dir):
    from geoguessr_ai_torch.serving.api import GuessApi

    eng = _FakeEngine()
    api = GuessApi(engine=eng)
    api.get_batcher()
    api.warmup_thread.join()
    warm = eng.rows
    blob = open(os.path.join(fixtures_dir, "heading=000.jpg"), "rb").read()
    sids = [api.submit_image([blob] * 4)["submission_id"] for _ in range(3)]
    polls = [threading.Thread(target=api.prediction, args=(s,))
             for s in sids for _ in range(3)]
    for t in polls:
        t.start()
    for t in polls:
        t.join()
    batcher = api.get_batcher()
    padded = sum(b * n for b, n in batcher.batch_sizes.items())
    assert eng.rows - warm == padded  # every row the batcher dispatched
    assert all(api.submissions[s]["result"] is not None for s in sids)
    assert api.get_batcher() is batcher  # built once


def test_api_store_evicts_completed_submissions_first():
    from geoguessr_ai_torch.serving import api as api_mod

    api = api_mod.GuessApi(engine=_FakeEngine())
    for i in range(api_mod.MAX_SUBMISSIONS):
        sid = api.submit_image([b"x"])["submission_id"]
        if i < 5:
            api.submissions[sid]["result"] = {}
    api.submit_image([b"x"])
    assert len(api.submissions) == api_mod.MAX_SUBMISSIONS
    assert 1 not in api.submissions and 6 in api.submissions


def test_create_app_needs_fastapi():
    from geoguessr_ai_torch.serving.api import create_app

    try:
        import fastapi  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="fastapi is not installed"):
            create_app(engine=_FakeEngine())
        return
    app = create_app(engine=_FakeEngine())
    assert app.state.api.health() == {"status": "ok"}


# ---------------------------------------------------------------------------
# what stays deferred, and the import rule
# ---------------------------------------------------------------------------


def test_deferred_parts_raise_citing_their_roadmap_item(tmp_path):
    from geoguessr_ai_torch import run_benchmark as rb
    from geoguessr_ai_torch.config import ModelConfig, TrainConfig
    from geoguessr_ai_torch.train import coordinator

    orbax_dir = tmp_path / "best"
    orbax_dir.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        _tiny_engine(_table(), checkpoint=str(orbax_dir))
    with pytest.raises(NotImplementedError, match="registry.*item 8"):
        rb.run_benchmark(clip_checkpoint_index=0, sqlite_path="unused")
    # since the train slice, both models build; train() refuses the
    # single-image one (tests/test_torch_port_train_loop.py)
    from geoguessr_ai_torch.models.tinyvit import TinyViTConfig

    for model in (ModelConfig(hierarchical=True), ModelConfig(panorama=False)):
        built, _, _, _ = coordinator.build_model(TrainConfig(model=model), 8,
                                                 TinyViTConfig.test_tiny())
        assert built.hierarchical == model.hierarchical
        assert built.panorama == model.panorama


def test_discover_sqlite_finds_the_newest(tmp_path, monkeypatch):
    from geoguessr_ai_torch.train.coordinator import discover_sqlite

    monkeypatch.delenv("DATASET_SQLITE_PATH", raising=False)
    with pytest.raises(FileNotFoundError):
        discover_sqlite([str(tmp_path)])
    for i, name in enumerate(("dataset_sqlite_a.sqlite",
                              "dataset_sqlite_b.sqlite")):
        p = tmp_path / name
        sqlite3.connect(str(p)).close()
        os.utime(p, (1000 + i, 1000 + i))
    assert discover_sqlite([str(tmp_path)]).endswith("_b.sqlite")
    monkeypatch.setenv("DATASET_SQLITE_PATH", "/elsewhere.sqlite")
    assert discover_sqlite([str(tmp_path)]) == "/elsewhere.sqlite"


def test_discover_sqlite_searches_only_inside_the_repo():
    """By default the search stays inside the checkout: the repo's root and
    its data directory, never the directory around the repo."""
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.train.coordinator import default_sqlite_dirs

    root = os.path.realpath(C.REPO_ROOT)
    assert root == os.path.realpath(REPO)
    dirs = default_sqlite_dirs()
    assert dirs and os.path.dirname(root) not in map(os.path.realpath, dirs)
    for d in dirs:
        d = os.path.realpath(d)
        assert d == root or d.startswith(root + os.sep), d


def test_port_imports_no_pandas_or_orbax_and_fastapi_only_in_create_app():
    files = glob.glob(os.path.join(REPO, "geoguessr_ai_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        allowed = set()
        if path.endswith(os.path.join("serving", "api.py")):
            create_app = next(n for n in tree.body
                              if getattr(n, "name", "") == "create_app")
            allowed = {id(n) for n in ast.walk(create_app)}
        # the Parquet writer imports pandas inside itself, as the JAX one
        pandas_ok = set()
        if path.endswith(os.path.join("train", "finetune_tinyvit.py")):
            writer = next(n for n in tree.body if getattr(n, "name", "")
                          == "extract_embeddings_parquet")
            pandas_ok = {id(n) for n in ast.walk(writer)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root == "pandas" and id(node) in pandas_ok:
                    continue
                assert root not in ("pandas", "orbax"), (path, node.lineno)
                if root == "fastapi":
                    assert id(node) in allowed, (path, node.lineno)
