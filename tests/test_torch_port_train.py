"""The PyTorch port's training path held against the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go through the JAX function
and the port's counterpart, in f32.  The attention backward mirrors (the
plain versions of K4 and K5) are held against the Pallas kernels in
interpret mode and against ``jax.vjp`` of the XLA attention; the three
autograd ops against ``jax.vjp`` of the JAX ops; TinyViT's train mode
against flax ``apply(train=True, mutable=["batch_stats"])``; one whole
``train_step`` against the JAX ``train_step``.  The CUDA kernels are held
against the same plain versions on the card in
tests/test_torch_port_cuda.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_torch.models.convert import from_jax_variables, to_jax_variables
from geoguessr_ai_torch.ops import window_attention as wa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HD = 32


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, rtol, rel_atol, atol=0.0):
    """Leaf by leaf, elementwise |got - want| <= atol + rel_atol *
    max|want leaf| + rtol * |want|."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=atol + rel_atol * scale, err_msg=k)


def _bwd_inputs(W, N, H, seed):
    rng = np.random.default_rng(seed)
    D = H * HD
    return (rng.normal(0, 1, (W, N, 3 * D)).astype(np.float32),
            rng.normal(0, 0.5, (H, N, N)).astype(np.float32),
            rng.normal(0, 1, (W, N, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# The K4 / K5 plain mirrors
# ---------------------------------------------------------------------------

#: f32 attention cotangents, two frameworks, sums in different orders.
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("W,N,H", [(4, 256, 6), (2, 128, 18)])
def test_attention_qkv_bwd_plain_matches_pallas_and_xla_vjp(W, N, H):
    """K4's mirror vs _attention_qkv_bwd_pallas (interpret) and jax.vjp
    of _attention_qkv_fused_xla (the CPU reference of _qkv_bwd)."""
    from geoguessr_ai_tpu.ops import window_attention as jwa

    qkv, bias, g = _bwd_inputs(W, N, H, seed=0)
    scale = HD ** -0.5
    jargs = tuple(map(jnp.asarray, (qkv, bias, g)))
    want_pallas = jwa._attention_qkv_bwd_pallas(*jargs, scale, H,
                                                interpret=True)
    _, vjp = jax.vjp(lambda a, b: jwa._attention_qkv_fused_xla(a, b, scale, H),
                     *jargs[:2])
    want_xla = vjp(jargs[2])
    got = wa._attention_qkv_bwd_plain(*map(torch.from_numpy, (qkv, bias, g)),
                                      scale, H)
    assert got[0].dtype == torch.float32 and got[1].shape == (H, N, N)
    for want in (want_pallas, want_xla):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=BWD_ATOL, rtol=BWD_RTOL)


def test_attention_bwd_merged_plain_matches_pallas_interpret():
    """K5's mirror vs _attention_bwd_merged_pallas(block_q=128) in
    interpret mode (two q-tiles, so dk/dv accumulate across them and
    d_bias across windows), with _attention_qkv_bwd_large's staging."""
    from geoguessr_ai_tpu.ops.window_attention import (
        _attention_bwd_merged_pallas,
    )

    W, N, H = 3, 256, 4
    qkv, bias, g = _bwd_inputs(W, N, H, seed=1)
    scale = HD ** -0.5
    x = jnp.asarray(qkv).reshape(W, N, H, 3, HD)
    q, k, v = (x[:, :, :, i].transpose(0, 2, 1, 3) for i in range(3))
    gh = jnp.asarray(g).reshape(W, N, H, HD).transpose(0, 2, 1, 3)
    dq, dk, dv, db = _attention_bwd_merged_pallas(
        q, k, v, jnp.asarray(bias), gh, scale, block_q=128, interpret=True)
    want = jnp.stack([dq, dk, dv], axis=3).transpose(0, 2, 1, 3, 4)
    got_dqkv, got_db = wa._attention_bwd_merged_plain(
        *map(torch.from_numpy, (qkv, bias, g)), scale, H)
    np.testing.assert_allclose(got_dqkv.numpy(),
                               np.asarray(want).reshape(W, N, 3 * H * HD),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(db), atol=BWD_ATOL,
                               rtol=BWD_RTOL)


def test_backward_mirrors_round_like_their_kernels():
    """In bf16, K4's mirror rounds the bias to bf16 (as the Pallas call
    casts it) and K5's keeps it f32; both return d_qkv in bf16 and d_bias
    in f32."""
    qkv, bias, g = _bwd_inputs(2, 128, 2, seed=2)
    qkv, g = (torch.from_numpy(a).bfloat16() for a in (qkv, g))
    bias = torch.from_numpy(bias)
    scale = HD ** -0.5
    k4 = wa._attention_qkv_bwd_plain(qkv, bias, g, scale, 2)
    k5 = wa._attention_bwd_merged_plain(qkv, bias, g, scale, 2)
    assert k4[0].dtype == k5[0].dtype == torch.bfloat16
    assert k4[1].dtype == k5[1].dtype == torch.float32
    k4_f32_bias = wa._attention_bwd_plain(qkv, bias, g, scale, 2)
    assert torch.equal(k5[1], k4_f32_bias[1])
    assert not torch.equal(k4[1], k5[1])
    torch.testing.assert_close(
        k4[1], wa._attention_bwd_plain(qkv, bias.bfloat16(), g, scale, 2)[1])


# ---------------------------------------------------------------------------
# The autograd ops against jax.vjp of the JAX ops
# ---------------------------------------------------------------------------


def _op_inputs(op, N, C, H, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(0, 1, (2, N, C)).astype(f)
    bias = rng.normal(0, 0.5, (H, N, N)).astype(f)
    if op == "window_attention_qkv":
        return [rng.normal(0, 1, (2, N, 3 * C)).astype(f), bias]
    common = [x, rng.normal(1, 0.1, C).astype(f),
              rng.normal(0, 0.1, C).astype(f),
              rng.normal(0, 0.1, (C, 3 * C)).astype(f),
              rng.normal(0, 0.1, 3 * C).astype(f)]
    if op == "fused_block_attention":
        common += [rng.normal(0, 0.1, (C, C)).astype(f),
                   rng.normal(0, 0.1, C).astype(f)]
    return common + [bias]


@pytest.mark.parametrize("op,N,mirror", [
    ("fused_block_attention", 256, "_attention_qkv_bwd_plain"),
    ("fused_block_attention_noproj", 256, "_attention_qkv_bwd_plain"),
    ("fused_block_attention_noproj", 1024, "_attention_bwd_merged_plain"),
    ("window_attention_qkv", 256, "_attention_qkv_bwd_plain"),
])
def test_autograd_op_gradients_match_jax_vjp(op, N, mirror, monkeypatch):
    """Every input gradient of the port's op vs jax.vjp of the JAX op (its
    custom VJP, on the CPU through XLA); the backward takes K4's mirror
    when H * N^2 * 4 <= 6 MB and K5's above (H=2: N=256 -> K4, N=1024 ->
    K5), as _qkv_bwd chooses."""
    from geoguessr_ai_tpu.ops import window_attention as jwa

    C, H = 2 * HD, 2
    args = _op_inputs(op, N, C, H, seed=3)
    scale = HD ** -0.5
    rng = np.random.default_rng(4)
    gout = rng.normal(0, 1, (2, N, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: getattr(jwa, op)(*a, scale, H),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gout))

    calls = []
    real = getattr(wa, mirror)
    monkeypatch.setattr(wa, mirror, lambda *a: (calls.append(mirror),
                                                 real(*a))[1])
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = getattr(wa, op)(*ts, scale, H)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.from_numpy(gout))
    assert calls == [mirror]
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=f"input {i}")


# ---------------------------------------------------------------------------
# Model train mode
# ---------------------------------------------------------------------------


def _randomise(variables, seed):
    """Seeded values for every leaf (BN variances positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        shape = np.shape(v)  # an array, or the shape struct of one
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) >= 2 and "attention_biases" not in name:
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _tiny_pair(num_cells=8, seed=0, dtype="float32", variables=None,
               depths=None, **fields):
    """(flax SuperGuessr, its variables, the port model loaded with them)
    at TinyViTConfig.test_tiny (with ``depths`` and the TinyViTConfig
    ``fields`` if given) computing in ``dtype``; the variables are seeded
    random ones unless given."""
    from geoguessr_ai_tpu.models import SuperGuessr as JaxSuperGuessr
    from geoguessr_ai_tpu.models import TinyViT as JaxTinyViT
    from geoguessr_ai_tpu.models import TinyViTConfig as JaxConfig

    from geoguessr_ai_torch.models.super_guessr import SuperGuessr
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    jdtype = getattr(jnp, dtype)
    jcfg = JaxConfig.test_tiny(dtype=jdtype)
    if depths is not None:
        jcfg = dataclasses.replace(jcfg, depths=depths)
    jcfg = dataclasses.replace(jcfg, **fields)
    jm = JaxSuperGuessr(num_cells=num_cells, backbone=JaxTinyViT(jcfg),
                        panorama=True, embed_dim=jcfg.embed_dim, dtype=jdtype)
    size = jcfg.image_size
    if variables is None:
        dummy = jnp.zeros((1, 4, size, size, 3), jnp.float32)
        variables = _randomise(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0), dummy), seed)
    shared = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(TinyViTConfig) if f.name != "dtype"}
    pcfg = TinyViTConfig(dtype=getattr(torch, dtype), **shared)
    pm = SuperGuessr(num_cells, TinyViT(pcfg), embed_dim=jcfg.embed_dim)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm


def test_tinyvit_train_forward_and_batch_stats_match_flax():
    """Batch-statistics BatchNorm (flax's fast variance) in the forward and
    the running statistics it leaves behind (momentum 0.9, biased
    variance)."""
    jm, variables, pm = _tiny_pair()
    jtv = jm.backbone
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    bb = {k: v["backbone"] for k, v in variables.items()}
    want, new_state = jax.jit(lambda v, x: jtv.apply(
        v, x, train=True, mutable=["batch_stats"]))(bb, jnp.asarray(x))
    got = pm.backbone(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    stats = to_jax_variables(
        {k: v for k, v in pm.backbone.state_dict().items()
         if k.endswith(("running_mean", "running_var"))})["batch_stats"]
    _assert_trees_close(stats, new_state["batch_stats"], rtol=1e-5,
                        rel_atol=1e-6)
    # eval mode reads the running statistics and leaves them alone
    before = {k: v.clone() for k, v in pm.backbone.state_dict().items()}
    pm.backbone(torch.from_numpy(x))
    after = pm.backbone.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_batch_norm_train_updates_with_the_biased_fast_variance():
    from geoguessr_ai_torch.models.tinyvit import _BN

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(3, 2, (2, 5, 5, 4)).astype(np.float32))
    bn = _BN(4)
    with torch.no_grad():
        y = bn(x, torch.float32, train=True)
    xf = x.numpy().astype(np.float64).reshape(-1, 4)
    mean, var = xf.mean(0), (xf ** 2).mean(0) - xf.mean(0) ** 2
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-5)
    unbiased = xf.var(0, ddof=1)
    assert np.abs(bn.running_var.numpy() - (0.9 + 0.1 * unbiased)).max() > 1e-3
    np.testing.assert_allclose(
        y.numpy().reshape(-1, 4), (xf - mean) / np.sqrt(var + 1e-5),
        atol=1e-4)


def test_drop_path_scales_kept_samples_and_needs_a_generator():
    from geoguessr_ai_torch.models.tinyvit import DropPath

    x = torch.ones(64, 3, 3, 2)
    dp = DropPath(0.25)
    assert dp(x, train=False) is x and DropPath(0.0)(x, True) is x
    with pytest.raises(ValueError, match="Generator"):
        dp(x, train=True)
    y1 = dp(x, True, torch.Generator().manual_seed(0))
    y2 = dp(x, True, torch.Generator().manual_seed(0))
    assert torch.equal(y1, y2)
    per_sample = y1.reshape(64, -1)
    kept = per_sample[:, 0] > 0
    assert torch.all(per_sample[kept] == 1 / 0.75)
    assert torch.all(per_sample[~kept] == 0)
    assert 0 < int(kept.sum()) < 64


def test_drop_path_rates_ramp_linearly_over_the_blocks():
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    m = TinyViT(TinyViTConfig(image_size=64, embed_dims=(16, 32, 64, 80),
                              depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 5),
                              window_sizes=(2, 2, 4, 2), drop_path_rate=0.4))
    rates = [getattr(m, n).drop_path.rate for n in m._order if "block" in n]
    np.testing.assert_allclose(rates, np.linspace(0, 0.4, 5))


def test_bf16_gradients_drift_from_f32_through_batch_statistics_bn():
    """Why chip_smoke.py holds the card's bf16 train step to the plain bf16
    path and not to 0.99 cosine against f32 upstream of stage 3: in bf16,
    the patch_embed gradient of the plain path moves away from the f32 one
    several times further when BatchNorm normalises with the batch
    statistics (train) than with the running ones (eval)."""
    from geoguessr_ai_torch.models.super_guessr import (
        SuperGuessr,
        init_parameters_,
        smoothed_soft_ce,
    )
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    tiny = dict(image_size=64, embed_dims=(16, 32, 64, 80), depths=(1, 1, 2, 1),
                num_heads=(1, 2, 4, 5), window_sizes=(2, 2, 4, 2))
    rng = np.random.default_rng(0)
    centroids = torch.from_numpy(
        rng.uniform([-180, -60], [180, 70], (64, 2)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32))
    coords = torch.tensor([[10.0, 45.0], [-70.0, -20.0]])

    def patch_embed_grad(dtype, train):
        m = SuperGuessr(64, TinyViT(TinyViTConfig(dtype=dtype, **tiny)),
                        embed_dim=tiny["embed_dims"][-1])
        init_parameters_(m, 0)
        _, logits = m(x, train=train)
        params = list(m.backbone.patch_embed.parameters())
        grads = torch.autograd.grad(smoothed_soft_ce(logits, coords, centroids),
                                    params)
        return torch.cat([g.flatten() for g in grads]).double()

    def cosine(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    drift = {train: 1 - cosine(patch_embed_grad(torch.float32, train),
                               patch_embed_grad(torch.bfloat16, train))
             for train in (True, False)}
    assert drift[False] < 2e-3, drift
    assert drift[True] > 3 * drift[False], drift


# ---------------------------------------------------------------------------
# Losses, geodesy, metrics
# ---------------------------------------------------------------------------


def test_geodesy_matches_jax():
    from geoguessr_ai_tpu.geo import core as jgeo

    from geoguessr_ai_torch.geo import core as geo

    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-180, 180, 6), rng.uniform(-90, 90, 6)],
                   -1).astype(np.float32)
    cells = np.stack([rng.uniform(-180, 180, 40), rng.uniform(-90, 90, 40)],
                     -1).astype(np.float32)
    d = geo.haversine_matrix(torch.from_numpy(pts), torch.from_numpy(cells))
    jd = jgeo.haversine_matrix(jnp.asarray(pts), jnp.asarray(cells))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-2)
    dd = d.clone()
    dd[0, 3] = float("nan")
    np.testing.assert_allclose(geo.smooth_labels(dd).numpy(),
                               np.asarray(jgeo.smooth_labels(jnp.asarray(dd))),
                               rtol=1e-5, atol=1e-7)
    # scores run 0..5000: 1e-3 absolute is f32 noise of exp on that range
    np.testing.assert_allclose(geo.geoguessr_score(d).numpy(),
                               np.asarray(jgeo.geoguessr_score(jd)), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(
        geo.nearest_centroid_labels(torch.from_numpy(pts),
                                    torch.from_numpy(cells)).numpy(),
        np.asarray(jgeo.nearest_centroid_labels(jnp.asarray(pts),
                                                jnp.asarray(cells))))


def test_losses_match_jax_at_12647_cells():
    from geoguessr_ai_tpu.models.super_guessr import hard_ce as jax_hard
    from geoguessr_ai_tpu.models.super_guessr import (
        smoothed_soft_ce as jax_soft,
    )

    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.geocells.manager import CentroidTable
    from geoguessr_ai_torch.models.super_guessr import hard_ce, smoothed_soft_ce

    table = CentroidTable.load(C.CENTROID_TABLE_PATH)
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 3, (4, table.num_cells)).astype(np.float32)
    coords = np.stack([rng.uniform(-170, 170, 4), rng.uniform(-60, 60, 4)],
                      -1).astype(np.float32)
    labels = rng.integers(0, table.num_cells, 4)
    want = jax_soft(jnp.asarray(logits), jnp.asarray(coords),
                    jnp.asarray(table.centroids))
    got = smoothed_soft_ce(torch.from_numpy(logits), torch.from_numpy(coords),
                           torch.from_numpy(table.centroids))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        float(hard_ce(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jax_hard(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_metrics_match_jax_with_an_even_batch_median():
    from geoguessr_ai_tpu.train.steps import _metrics as jax_metrics

    from geoguessr_ai_torch.train.steps import _metrics

    rng = np.random.default_rng(9)
    cells = np.stack([rng.uniform(-170, 170, 30), rng.uniform(-60, 60, 30)],
                     -1).astype(np.float32)
    coords = cells[[1, 4, 9, 20]] + rng.normal(0, 2, (4, 2)).astype(np.float32)
    logits = rng.normal(0, 2, (4, 30)).astype(np.float32)
    logits[0, 1] = logits[1, 7] = 20.0  # one right, one near miss
    want = jax_metrics(jnp.asarray(logits), jnp.asarray(coords),
                       jnp.asarray(cells), jnp.float32(1.5),
                       with_distances=True)
    got = _metrics(torch.from_numpy(logits), torch.from_numpy(coords),
                   torch.from_numpy(cells), torch.tensor(1.5),
                   with_distances=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_freeze_mask_matches_jax_by_name():
    from geoguessr_ai_tpu.train.state import backbone_freeze_mask as jax_mask

    from geoguessr_ai_torch.train.state import backbone_freeze_mask

    _, variables, pm = _tiny_pair()
    names = [n for n, _ in pm.named_parameters()]
    for kw in (dict(freeze_all_but_last_stage=True), dict(freeze_base=True),
               {}):
        # the JAX mask, as arrays of each parameter's shape, under the
        # port's names
        want = from_jax_variables({"params": jax.tree_util.tree_map(
            lambda m, p: np.full(np.shape(p), float(m), np.float32),
            jax_mask(variables["params"], **kw), variables["params"])})
        got = backbone_freeze_mask(names, **kw)
        assert set(got) == set(want)
        assert got == {n: bool(want[n].flatten()[0]) for n in want}, kw
    trainable = backbone_freeze_mask(names, freeze_all_but_last_stage=True)
    assert trainable["cell_layer.weight"]
    assert trainable["backbone.stage3_block0.attn.qkv.weight"]
    assert trainable["backbone.downsample2.conv1.bn.weight"]
    assert not trainable["backbone.downsample1.conv1.bn.weight"]
    with pytest.raises(ValueError, match="matched no backbone"):
        backbone_freeze_mask(["backbone.weird.weight"],
                             freeze_all_but_last_stage=True)


def test_cosine_warm_restarts_matches_optax():
    from geoguessr_ai_tpu.train.state import cosine_warm_restarts as jax_sched

    from geoguessr_ai_torch.train.state import cosine_warm_restarts

    for kw in (dict(steps_per_cycle=3), dict(steps_per_cycle=2, t_mult=3,
                                             warmup_steps=4),
               dict(steps_per_cycle=1, num_cycles=3)):
        want = jax_sched(0.1, **kw)
        got = cosine_warm_restarts(0.1, **kw)
        steps = np.arange(60)
        np.testing.assert_allclose([got(int(s)) for s in steps],
                                   [float(want(s)) for s in steps],
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("max_grad_norm", [0.5, 100.0])
def test_adamw_matches_optax_with_a_freeze_mask(max_grad_norm):
    """Three steps on the same gradients: clipping over the trainable
    leaves only (triggered at 0.5, not at 100), bias-corrected moments,
    decoupled decay, no update of frozen leaves."""
    import optax

    from geoguessr_ai_tpu.config import OptimizerConfig as JaxOptCfg
    from geoguessr_ai_tpu.train.state import make_optimizer as jax_make

    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.train.state import make_optimizer

    rng = np.random.default_rng(10)
    shapes = {"a": (3, 4), "b": (5,), "frozen": (2, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    kw = dict(learning_rate=0.05, max_grad_norm=max_grad_norm,
              weight_decay=0.1)
    tx, _ = jax_make(JaxOptCfg(**kw), steps_per_epoch=2, trainable_mask=mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = make_optimizer(tp, OptimizerConfig(**kw), 2, mask)
    for _ in range(3):
        grads = {k: rng.normal(0, 1, s).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in grads.items()})
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])
    assert set(opt.mu) == {"a", "b"}


# ---------------------------------------------------------------------------
# One whole train step against the JAX train_step
# ---------------------------------------------------------------------------

def _jax_train_step(jm, variables, x, coords, cells, opt, grad_accum_steps=1):
    """The JAX train_step on the CPU with the default freeze: (new state,
    metrics, the gradients it hands to apply_gradients)."""
    from geoguessr_ai_tpu.config import OptimizerConfig as JaxOptCfg
    from geoguessr_ai_tpu.train import state as jstate
    from geoguessr_ai_tpu.train import steps as jsteps

    mask = jstate.backbone_freeze_mask(variables["params"],
                                       freeze_all_but_last_stage=True)
    tx, _ = jstate.make_optimizer(JaxOptCfg(**opt), 10, mask)
    captured = {}

    class Capture(jstate.TrainState):
        def apply_gradients(self, *, grads, **kw):
            captured["grads"] = grads  # a value of the same trace
            return super().apply_gradients(grads=grads, **kw)

    js = Capture.create(apply_fn=jm.apply, params=variables["params"], tx=tx,
                        batch_stats=variables["batch_stats"],
                        dropout_rng=jax.random.PRNGKey(0))

    def jax_step(s, batch, c):
        new, metrics = jsteps.train_step(s, batch, c,
                                         grad_accum_steps=grad_accum_steps)
        return new, metrics, captured["grads"]

    return jax.jit(jax_step)(
        js, {"pixel_values": jnp.asarray(x), "coords": jnp.asarray(coords)},
        jnp.asarray(cells))


def _port_train_step(pm, x, coords, cells, opt, grad_accum_steps=1):
    """The port's train_step on the CPU with the default freeze: (new
    state, metrics, the gradients it hands to the optimizer)."""
    from geoguessr_ai_torch.config import OptimizerConfig
    from geoguessr_ai_torch.train import state as tstate
    from geoguessr_ai_torch.train import steps as tsteps

    names = [n for n, _ in pm.named_parameters()]
    state = tstate.create_train_state(
        pm, OptimizerConfig(**opt), 10,
        trainable_mask=tstate.backbone_freeze_mask(
            names, freeze_all_but_last_stage=True))
    grads = {}
    real_step = state.optimizer.step
    state.optimizer.step = lambda p, g: (grads.update(g), real_step(p, g))[1]
    state, met = tsteps.train_step(
        state, {"pixel_values": torch.from_numpy(x),
                "coords": torch.from_numpy(coords)},
        torch.from_numpy(cells), grad_accum_steps=grad_accum_steps)
    return state, met, grads


def _step_inputs(B, num_cells, seed, size=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 4, size, size, 3)).astype(np.float32)
    coords = np.stack([rng.uniform(-170, 170, B), rng.uniform(-60, 60, B)],
                      -1).astype(np.float32)
    cells = np.stack([rng.uniform(-170, 170, num_cells),
                      rng.uniform(-60, 60, num_cells)], -1).astype(np.float32)
    return x, coords, cells


#: Gradients elementwise: rtol relative to the element, plus 1e-4 of the
#: leaf's largest gradient, plus 1e-6 of the global gradient norm (the f32
#: forward and backward sum in different orders; some leaves, e.g. the MLP
#: fc2 biases ahead of a batch-statistics BatchNorm, have an exact gradient
#: of 0 and carry only the cancellation noise of the gradients around them,
#: observed up to 1e-7 of the norm).  With grad_accum_steps=2 both sides
#: round each microbatch's gradient to bf16 and round their sum again, so an
#: element may land two bf16 ulps (2 * 2^-7 relative) apart.
STEP_RTOL = {1: 1e-3, 2: 2.0 ** -6}
STEP_NORM_ATOL = 1e-6


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_train_step_matches_jax_train_step(grad_accum_steps):
    """Loss, every gradient, every updated parameter (as its update),
    batch_stats, grad_norm and param_norm after one step at test_tiny with
    8 cells and the default freeze.  The step runs at eps=1 and lr=0.1, so
    that each update is a smooth function of its gradient (at the default
    eps=1e-8 Adam's first step is sign(g) * lr, which turns f32 noise on a
    vanishing gradient into a full-size difference); AdamW's own arithmetic
    is pinned exactly by test_adamw_matches_optax_with_a_freeze_mask."""
    from geoguessr_ai_tpu.train import state as jstate

    k = grad_accum_steps
    jm, variables, pm = _tiny_pair(seed=11)
    x, coords, cells = _step_inputs(B=4, num_cells=8, seed=12)
    opt = dict(learning_rate=0.1, eps=1.0)
    jnew, jmet, jgrads = _jax_train_step(jm, variables, x, coords, cells, opt,
                                         k)
    state, met, port_grads = _port_train_step(pm, x, coords, cells, opt, k)
    assert state.step == 1 and state.optimizer.count == 1
    mask = jstate.backbone_freeze_mask(variables["params"],
                                       freeze_all_but_last_stage=True)

    for key in ("loss", "grad_norm", "param_norm", "top1", "top5",
                "mean_km", "median_km", "score"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    rtol = STEP_RTOL[k]
    _assert_trees_close(to_jax_variables(port_grads)["params"], jgrads,
                        rtol=rtol, rel_atol=1e-4,
                        atol=STEP_NORM_ATOL * float(jmet["grad_norm"]))
    new = to_jax_variables(pm.state_dict())
    delta = jax.tree_util.tree_map(lambda a, b: a - np.asarray(b),
                                   new["params"], variables["params"])
    want_delta = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), jnew.params,
        variables["params"])
    _assert_trees_close(delta, want_delta, rtol=rtol, rel_atol=0.0,
                        atol=1e-6)
    trainable = _leaves(mask)
    for key, d in _leaves(delta).items():
        assert (np.abs(d).max() > 0) == bool(trainable[key]), key
    _assert_trees_close(new["batch_stats"], jnew.batch_stats, rtol=1e-5,
                        rel_atol=1e-6)


#: The head-major configuration at 512 px with test_tiny's depths and
#: narrow widths of head dim 32: every stage's window has N % 128 == 0
#: (256, 256, 1024, 256), so with QKV_KERNEL_MIN_N raised every attention
#: stage takes window_attention.
HEAD_MAJOR_FIELDS = dict(image_size=512, embed_dims=(32, 64, 64, 96),
                         depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 3),
                         window_sizes=(16, 16, 32, 16),
                         pallas_attention_stages=(1, 2, 3),
                         fused_block_stages=(), fused_block_noproj_stages=())


def test_head_major_train_step_matches_jax_train_step(monkeypatch):
    """One train step of the head-major configuration (QKV_KERNEL_MIN_N
    raised on both packages) against the JAX train_step: loss, grad_norm,
    every gradient and batch_stats, with the tolerances of
    test_train_step_matches_jax_train_step."""
    from geoguessr_ai_tpu.ops import window_attention as jwa

    monkeypatch.setattr(jwa, "QKV_KERNEL_MIN_N", 2048)
    monkeypatch.setattr(wa, "QKV_KERNEL_MIN_N", 2048)
    jm, variables, pm = _tiny_pair(seed=13, **HEAD_MAJOR_FIELDS)
    x, coords, cells = _step_inputs(B=2, num_cells=8, seed=14, size=512)
    opt = dict(learning_rate=0.1, eps=1.0)
    jnew, jmet, jgrads = _jax_train_step(jm, variables, x, coords, cells, opt)
    calls = []
    real = wa.window_attention
    monkeypatch.setattr(wa, "window_attention", lambda *a: (
        calls.append(1), real(*a))[1])
    _, met, port_grads = _port_train_step(pm, x, coords, cells, opt)
    assert len(calls) == 3  # stages 1-3, one block each
    for key in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_trees_close(to_jax_variables(port_grads)["params"], jgrads,
                        rtol=STEP_RTOL[1], rel_atol=1e-4,
                        atol=STEP_NORM_ATOL * float(jmet["grad_norm"]))
    _assert_trees_close(to_jax_variables(pm.state_dict())["batch_stats"],
                        jnew.batch_stats, rtol=1e-5, rel_atol=1e-6)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

#: Four stages with a stage of depth 2, DropPath at a rate that drops
#: samples (its masks must be drawn again the same under recompute).
REMAT_TINY = dict(image_size=64, embed_dims=(16, 32, 64, 80),
                  depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 5),
                  window_sizes=(2, 2, 4, 2), drop_path_rate=0.4,
                  dtype=torch.float32)


def _remat_step(state_dict, **fields):
    """sum(out^2) of a train-mode TinyViT forward from ``state_dict`` with
    DropPath drawn from a seeded generator: (gradients, running statistics,
    the generator's state afterwards)."""
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig

    m = TinyViT(TinyViTConfig(**REMAT_TINY, **fields))
    m.load_state_dict(state_dict)
    x = torch.from_numpy(np.random.default_rng(15).normal(
        0, 1, (8, 64, 64, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(16)
    out = m(x, train=True, generator=gen)
    grads = torch.autograd.grad(out.pow(2).sum(), list(m.parameters()))
    stats = {k: v.clone() for k, v in m.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return grads, stats, gen.get_state()


@pytest.mark.parametrize("fields", [
    dict(remat=True),
    dict(remat=True, remat_policy="dots"),
    dict(remat=True, remat_stages=(0, 2)),
    dict(remat=True, remat_stages=(1, 3), remat_policy="dots"),
], ids=["full", "dots", "full_stages_0_2", "dots_stages_1_3"])
def test_remat_gradients_statistics_and_drop_path_match_remat_off(
        fields, monkeypatch):
    """remat "full" and "dots" (all stages or some) against remat off, in
    f32 on the CPU: the same gradients (the recompute repeats the same
    arithmetic, so to f32 noise of 1e-6), the running statistics moved
    once (equal), DropPath's masks drawn the same under recompute (the
    gradients would differ at rate 0.4 otherwise) and the caller's
    generator advanced only by the forward."""
    from geoguessr_ai_torch.models import tinyvit

    torch.manual_seed(0)
    sd = tinyvit.TinyViT(tinyvit.TinyViTConfig(**REMAT_TINY)).state_dict()
    want = _remat_step(sd)
    calls = []
    real = tinyvit._checkpointed
    monkeypatch.setattr(tinyvit, "_checkpointed", lambda *a: (
        calls.append(a[-1]), real(*a))[1])
    got = _remat_step(sd, **fields)
    stages = fields.get("remat_stages", (0, 1, 2, 3))
    assert calls == [fields.get("remat_policy", "full")] * sum(
        REMAT_TINY["depths"][st] for st in stages)
    for a, b in zip(got[0], want[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert torch.equal(got[2], want[2])


#: Per top-level module, 1 - cosine of its flattened gradient to the f32
#: step's, for the JAX package's bf16 step and the port's, at test_tiny
#: and at TinyViT-21M's depths (2, 2, 6, 2) with test_tiny's widths.
#: Each case: (the most the port's drift may be, as a multiple of the JAX
#: bf16 step's; the least cosine between the two bf16 steps; the least
#: drift of the JAX bf16 step upstream of its last block, so that what is
#: compared exists).  Observed: test_tiny ratio <= 1.46 (patch_embed), pair
#: >= 0.9939, JAX drift >= 0.0030; full depth ratio <= 1.99
#: (stage1_block1), pair >= 0.9641, JAX drift >= 0.0130.  The port runs
#: eagerly and rounds to bf16 at every op boundary, where XLA fuses
#: elementwise chains (BatchNorm into GELU, a residual add into GELU, a
#: GEMM into its bias and GELU) and keeps them in f32, so its drift is
#: larger by a factor that grows with depth.
BF16_DRIFT_CASES = {
    "test_tiny": ((1, 1, 2, 1), 2.0, 0.99, 1e-3),
    "full_depth": ((2, 2, 6, 2), 2.5, 0.95, 1e-2),
}


@pytest.mark.parametrize("case", sorted(BF16_DRIFT_CASES))
def test_bf16_train_step_drifts_from_f32_as_the_jax_bf16_step_does(case):
    """The independent witness for chip_smoke.py's bf16 gradient gate: the
    JAX train_step computing in bf16 (f32 master weights, flax's BatchNorm,
    GELU and casts) loses gradient agreement with its f32 step by about as
    much as the port's bf16 plain path does, with the port's seeded init
    (the init of the full-width smoke run), B=2, the default optimizer and
    freeze.  At full depth the JAX bf16 step itself falls below 0.99 cosine
    upstream of stage 3.  pytest -s prints every module's cosines."""
    from geoguessr_ai_torch.models.super_guessr import init_parameters_

    depths, max_ratio, min_pair, min_drift = BF16_DRIFT_CASES[case]
    _, _, pm = _tiny_pair(depths=depths)
    init_parameters_(pm, 0)
    variables = to_jax_variables(pm.state_dict())
    x, coords, cells = _step_inputs(B=2, num_cells=8, seed=0)
    grads = {}
    for dtype in ("float32", "bfloat16"):
        jm, _, pm = _tiny_pair(dtype=dtype, variables=variables, depths=depths)
        _, _, jg = _jax_train_step(jm, variables, x, coords, cells, {})
        _, _, pg = _port_train_step(pm, x, coords, cells, {})
        jg = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                  jg)})
        grads["jax", dtype] = {n: torch.as_tensor(g) for n, g in jg.items()}
        grads["port", dtype] = {n: g.detach().float() for n, g in pg.items()}

    def module(name):
        parts = name.split(".")
        return parts[1] if parts[0] == "backbone" else parts[0]

    def cosine(a, b, names):
        a = torch.cat([a[n].flatten() for n in names]).double()
        b = torch.cat([b[n].flatten() for n in names]).double()
        return float(a @ b / (a.norm() * b.norm()))

    f32 = grads["jax", "float32"]
    last_block = f"stage3_block{depths[3] - 1}"
    for mod in sorted({module(n) for n in f32}):
        names = [n for n in f32 if module(n) == mod]
        drift_jax = 1 - cosine(grads["jax", "bfloat16"], f32, names)
        drift_port = 1 - cosine(grads["port", "bfloat16"], f32, names)
        pair = cosine(grads["port", "bfloat16"], grads["jax", "bfloat16"],
                      names)
        print(f"{case} {mod}: bf16 vs f32 cosine jax {1 - drift_jax:.6f} "
              f"port {1 - drift_port:.6f}; port bf16 vs jax bf16 {pair:.6f}")
        assert drift_port <= max_ratio * drift_jax, mod
        assert pair >= min_pair, mod
        if mod.startswith(("patch_embed", "stage", "downsample")) \
                and mod != last_block:
            assert drift_jax > min_drift, mod


# ---------------------------------------------------------------------------
# Pipeline and the coordinator
# ---------------------------------------------------------------------------


def _records(fixtures_dir, n=12, views=4):
    with open(os.path.join(fixtures_dir, "heading=000.jpg"), "rb") as f:
        blob = f.read()
    rng = np.random.default_rng(0)
    return [{"location_id": f"l{i}", "lat": float(rng.uniform(-50, 50)),
             "lon": float(rng.uniform(-170, 170)),
             "images": [blob] * (views if i % 3 else views - 1)}
            for i in range(n)]


def _same_decoder(monkeypatch, jax_module, port_module):
    """Leaves both packages on their native decoders when both load;
    otherwise pins ``decode_jpeg`` of ``jax_module`` and of
    ``port_module`` to each package's PIL decode."""
    from geoguessr_ai_tpu.data import pipeline as jax_pipeline
    from geoguessr_ai_tpu.data.native import jpeg as jax_jpeg

    from geoguessr_ai_torch.data import pipeline
    from geoguessr_ai_torch.data.native import jpeg

    if jpeg.available() and jax_jpeg.available():
        return
    monkeypatch.setattr(jax_module, "decode_jpeg", jax_pipeline._pil_decode)
    monkeypatch.setattr(port_module, "decode_jpeg", pipeline._pil_decode)


def test_panorama_batches_match_jax(fixtures_dir, monkeypatch):
    """Records as dicts (the port) and as a DataFrame (the JAX package),
    shuffled, with a short panorama (mask 0 view) and a padded last
    batch."""
    import pandas as pd

    from geoguessr_ai_tpu.data import pipeline as jax_pipeline
    from geoguessr_ai_tpu.data.pipeline import (
        PanoramaBatchIterator as JaxIterator,
    )

    from geoguessr_ai_torch.data.pipeline import (
        PanoramaBatchIterator,
        prefetch_to_device,
    )

    # native libjpeg against native where both packages built it; PIL on
    # both sides where either lacks it
    from geoguessr_ai_torch.data import pipeline

    _same_decoder(monkeypatch, jax_pipeline, pipeline)
    records = _records(fixtures_dir, n=7)
    kw = dict(batch_size=3, image_size=32, shuffle=True, seed=4)
    got = list(PanoramaBatchIterator(records, **kw))
    want = list(JaxIterator(pd.DataFrame(records), **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for key in ("pixel_values", "view_mask", "coords"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["location_id"] == b["location_id"]
        assert a["num_real"] == b["num_real"]
    assert got[-1]["num_real"] == 1
    assert len(PanoramaBatchIterator(records, 3, 32,
                                     drop_remainder=True)) == 2
    # a table with itertuples() is read the same way
    again = list(PanoramaBatchIterator(pd.DataFrame(records), **kw))
    np.testing.assert_array_equal(again[0]["coords"], want[0]["coords"])
    on_dev = list(prefetch_to_device(iter(got), "cpu", depth=2))
    assert isinstance(on_dev[0]["pixel_values"], torch.Tensor)
    assert on_dev[0]["location_id"] == got[0]["location_id"]
    assert len(on_dev) == 3


def _tiny_backbone(monkeypatch):
    from geoguessr_ai_torch import config as C
    from geoguessr_ai_torch.models.tinyvit import TinyViT, TinyViTConfig
    from geoguessr_ai_torch.train import coordinator

    monkeypatch.setattr(coordinator, "build_backbone", lambda cfg, _=None: (
        TinyViT(TinyViTConfig(image_size=64, embed_dims=(16, 32, 64, 80),
                              depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 5),
                              window_sizes=(2, 2, 4, 2),
                              dtype=torch.float32)),
        C.TINYVIT_NORM_MEAN, C.TINYVIT_NORM_STD, 64))


def _tiny_table(n=8):
    from geoguessr_ai_torch.geocells.manager import CentroidTable

    rng = np.random.default_rng(3)
    return CentroidTable(
        centroids=rng.uniform(-60, 60, (n, 2)).astype(np.float32),
        country=np.array(["X"] * n), admin1=np.array(["Y"] * n),
        cell_id=np.array([str(i) for i in range(n)]))


def test_train_runs_steps_validation_and_summary(fixtures_dir, monkeypatch):
    from geoguessr_ai_torch.config import (
        BackboneConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from geoguessr_ai_torch.train import coordinator
    from geoguessr_ai_torch.utils.logging import MetricsLogger

    _tiny_backbone(monkeypatch)
    logged = []

    class Probe(MetricsLogger):
        def log(self, metrics, step):
            logged.append((step, dict(metrics)))

    cfg = TrainConfig(
        batch_size=4, num_epochs=1, eval_every_steps=2, log_every_steps=1,
        decode_threads=2, optimizer=OptimizerConfig(learning_rate=1e-3),
        model=ModelConfig(backbone=BackboneConfig(image_size=64,
                                                  embed_dim=80)))
    records = _records(fixtures_dir, n=20)
    summary = coordinator.train(cfg, records[:16], records[16:], _tiny_table(),
                                metrics_logger=Probe(), max_steps=3,
                                device="cpu")
    train_logs = [m for _, m in logged if "train/loss" in m]
    assert [s for s, m in logged if "train/loss" in m] == [1, 2, 3]
    assert all(np.isfinite(float(m["train/loss"])) and np.isfinite(
        float(m["train/grad_norm"])) for m in train_logs)
    assert len([m for _, m in logged if "val_loss" in m]) == 2
    assert summary["global_step"] == 3 and np.isfinite(summary["val_loss"])
    assert summary["best_value"] == summary["val_loss"]


@pytest.mark.parametrize("change,match", [
    # the mesh is ported (tests/test_torch_port_mesh.py): a mesh of four in
    # one process does not cover its one rank
    (dict(mesh=dict(data_parallel=4)), "does not cover 1"),
])
def test_train_raises_for_what_is_not_ported(change, match, tmp_path):
    from geoguessr_ai_torch.config import (
        BackboneConfig,
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from geoguessr_ai_torch.train import coordinator

    cfg = TrainConfig(
        mesh=MeshConfig(**change.get("mesh", {})),
        model=ModelConfig(backbone=BackboneConfig(**change.get("backbone", {}))))
    with pytest.raises(ValueError, match=match):
        coordinator.train(cfg, [], [], _tiny_table(), device="cpu")


def test_train_entry_point_needs_cuda_unless_told_cpu():
    from geoguessr_ai_torch.config import TrainConfig
    from geoguessr_ai_torch.train import coordinator

    if torch.cuda.is_available():
        assert coordinator.C.resolve_device(None) == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        coordinator.train(TrainConfig(), [], [], _tiny_table())


def test_train_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'geoguessr_ai_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import geoguessr_ai_torch.train.coordinator\n"
        "import geoguessr_ai_torch.train.checkpoints\n"
        "import geoguessr_ai_torch.train.train_eval_loop\n"
        "import geoguessr_ai_torch.utils.profiling\n"
        "import geoguessr_ai_torch.data.native.jpeg\n"
        "import geoguessr_ai_torch.train.fixtures\n"
        "import geoguessr_ai_torch.profile_forward\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
