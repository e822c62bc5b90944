"""The PyTorch port's TinyViT modules held against the flax modules.

Each case builds the flax module, initialises it from a seed, carries its
variables across with ``models.convert.from_jax_variables`` (strict load)
and runs the same numpy input through both, in f32 on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import tinyvit as jtv

from geoguessr_ai_torch.models import tinyvit as ttv
from geoguessr_ai_torch.models.convert import from_jax_variables
from geoguessr_ai_torch.ops import window_attention as wa

ATOL, RTOL = 5e-4, 1e-3


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _randomise(variables, seed):
    """Replaces every leaf with seeded random values (BN variances
    positive), so that zero-initialised biases and attention biases are
    exercised too."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(_numpy_tree(variables))
    out = []
    for path, v in leaves:
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            out.append(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif v.ndim >= 2 and "attention_biases" not in name:
            fan_in = int(np.prod(v.shape[:-1]))
            out.append(rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32))
        else:
            out.append(rng.normal(0, 0.2, v.shape).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _carry(jax_module, port_module, x, seed=0, **call):
    """Init the flax module (jitted), randomise its variables and load them
    into the port module (strict); returns the flax output as numpy."""
    init = jax.jit(lambda key, v: jax_module.init(key, v, **call))
    apply = jax.jit(lambda variables, v: jax_module.apply(variables, v, **call))
    variables = _randomise(init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    return np.asarray(apply(variables, jnp.asarray(x)))


def test_relative_bias_index_matches_jax_sorted_unique_order():
    for window in (2, 4, 7, 16, 32):
        np.testing.assert_array_equal(ttv._relative_bias_index(window),
                                      jtv._relative_bias_index(window))
    # dense ids in sorted order of |dy| * window + |dx|: row 0 (the corner
    # token) sees every offset once, in raster order
    idx = ttv._relative_bias_index(4)
    np.testing.assert_array_equal(idx[0], np.arange(16))
    np.testing.assert_array_equal(idx, idx.T)
    assert idx[5, 0] == 5 and idx[6, 1] == 5 and idx[1, 4] == 5


def test_window_partition_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jtv.window_partition(jnp.asarray(x), 4))
    got = ttv.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    back = ttv.window_unpartition(got, 4, (8, 12))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jtv.window_unpartition(jnp.asarray(want), 4,
                                                        (8, 12))))
    np.testing.assert_array_equal(back.numpy(), x)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = ttv._gelu(torch.from_numpy(x), exact=False).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jtv._gelu(jnp.asarray(x), False)), atol=1e-6)
    exact = ttv._gelu(torch.from_numpy(x), exact=True).numpy()
    np.testing.assert_allclose(
        exact, np.asarray(jtv._gelu(jnp.asarray(x), True)), atol=1e-6)
    assert np.abs(got - exact).max() > 1e-4
    assert ttv.TinyViTConfig().exact_gelu is False


@pytest.mark.parametrize("kernel,stride,groups", [
    (3, 2, 1),   # the stem's stride-2 3x3 convs: flax pads k // 2
    (3, 2, 16),  # PatchMerging's stride-2 depthwise conv
    (3, 1, 16),  # the local conv
    (1, 1, 1),
])
def test_conv_bn_matches_flax(kernel, stride, groups):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 10, 16)).astype(np.float32)
    jm = jtv.ConvBN(16, kernel, stride=stride, groups=groups,
                    dtype=jnp.float32)
    pm = ttv.ConvBN(16, 16, kernel, stride=stride, groups=groups)
    want = _carry(jm, pm, x, train=False)
    got = pm(torch.from_numpy(x), torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", ["mbconv", "patch_embed", "patch_merging"])
def test_conv_modules_match_flax(name):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    if name == "mbconv":
        jm = jtv.MBConv(8, 4.0, 0.0, dtype=jnp.float32)
        pm = ttv.MBConv(8, 4.0, exact_gelu=False)
    elif name == "patch_embed":
        x = x[..., :3]
        jm = jtv.PatchEmbed(16, dtype=jnp.float32)
        pm = ttv.PatchEmbed(3, 16, exact_gelu=False)
    else:
        jm = jtv.PatchMerging(24, dtype=jnp.float32)
        pm = ttv.PatchMerging(8, 24, exact_gelu=False)
    want = _carry(jm, pm, x, train=False)
    got = pm(torch.from_numpy(np.ascontiguousarray(x)), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


#: branch -> (flax flags, port flags, the port op the branch must call)
BRANCHES = {
    "fused_block_noproj": (dict(fused_block_noproj=True),
                           dict(fused_block_noproj=True),
                           "fused_block_attention_noproj"),
    "fused_block": (dict(fused_block=True), dict(fused_block=True),
                    "fused_block_attention"),
    "qkv_kernel": (dict(use_pallas=True), dict(use_kernel_qkv=True),
                   "window_attention_qkv"),
    "plain": ({}, {}, None),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("window", [8, 16])
def test_window_attention_branches_match_flax(branch, window, monkeypatch):
    """Each branch matches flax; a kernel branch engages exactly when
    N % 128 == 0 (window 16 -> N=256), as in the JAX module."""
    jflags, pflags, op = BRANCHES[branch]
    dim, heads = 64, 2
    N = window * window
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, N, dim)).astype(np.float32)
    jm = jtv.WindowAttention(dim, heads, window, dtype=jnp.float32, **jflags)
    pm = ttv.WindowAttention(dim, heads, window, **pflags)
    want = _carry(jm, pm, x, seed=4)
    calls = []
    for name in BRANCHES.values():
        if name[2] is not None:
            real = getattr(wa, name[2])
            monkeypatch.setattr(
                wa, name[2],
                lambda *a, _real=real, _n=name[2], **k: (calls.append(_n),
                                                         _real(*a, **k))[1])
    got = pm(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    assert calls == ([op] if op and N % 128 == 0 else [])


def test_tinyvit_block_and_model_match_flax_at_test_tiny():
    """A small whole TinyViT (windows too small for any kernel branch)."""
    jcfg = jtv.TinyViTConfig.test_tiny(dtype=jnp.float32)
    pcfg = ttv.TinyViTConfig(
        image_size=64, embed_dims=jcfg.embed_dims, depths=jcfg.depths,
        num_heads=jcfg.num_heads, window_sizes=jcfg.window_sizes,
        dtype=torch.float32)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    pm = ttv.TinyViT(pcfg)
    want = _carry(jtv.TinyViT(jcfg), pm, x, seed=6)
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.embed_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


def test_port_config_mirrors_jax_defaults():
    jcfg = jtv.TinyViTConfig.tiny_vit_21m_512()
    pcfg = ttv.TinyViTConfig.tiny_vit_21m_512()
    for f in dataclasses.fields(pcfg):
        if f.name != "dtype":
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert pcfg.dtype == torch.bfloat16
    with pytest.raises(TypeError):  # options outside the slice do not exist
        ttv.TinyViTConfig(quant_mode="static")
    with pytest.raises(TypeError):
        ttv.TinyViTConfig(remat_stages=(1,))


def test_cast_weights_keeps_norms_and_biases_f32():
    m = ttv.TinyViT(ttv.TinyViTConfig(
        image_size=64, embed_dims=(16, 32, 64, 80), depths=(1, 1, 1, 1),
        num_heads=(1, 2, 4, 5), window_sizes=(2, 2, 4, 2))).cast_weights_()
    for name, p in m.named_parameters():
        want = (torch.bfloat16 if name.endswith("weight") and p.ndim >= 2
                else torch.float32)
        assert p.dtype == want, name
