"""The head-major window attention (K8a/K8b), the two-kernel large-N
backward (K7) and the routes that reach them, held against the JAX package
on the CPU.

Inputs come from numpy with a fixed seed.  The plain versions of the
kernels are held against the Pallas kernels in interpret mode and against
the XLA references; the model routes (the head-major branch of
``WindowAttention`` behind ``QKV_KERNEL_MIN_N``, the plain-forward /
kernel-backward branch of a stage that takes no kernel) against flax.  The
CUDA kernels are held against the same plain versions on the card in
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geoguessr_ai_tpu.models import tinyvit as jtv
from geoguessr_ai_tpu.ops import window_attention as jwa

from geoguessr_ai_torch.models import tinyvit as ttv
from geoguessr_ai_torch.models.convert import from_jax_variables, to_jax_variables
from geoguessr_ai_torch.ops import window_attention as wa

HD = 32
SCALE = HD ** -0.5

#: f32, two frameworks, sums in different orders.
F32_ATOL, F32_RTOL = 1e-5, 1e-4
#: The Pallas kernels in interpret mode against XLA, as
#: tests/test_window_attention.py holds them.
PALLAS_ATOL, PALLAS_RTOL = 2e-3, 1e-2
#: bf16 outputs: max |got - want| over max |want|, two bf16 ulps (2^-8
#: relative each) of the output's range; both round p and the output to
#: bf16 after f32 sums taken in different orders.
BF16_REL = 2 * 2.0 ** -8


def _qkvb(W, H, N, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (W, H, N, HD)).astype(np.float32)
               for _ in range(3))
    return q, k, v, rng.normal(0, 0.5, (H, N, N)).astype(np.float32)


# ---------------------------------------------------------------------------
# K8a / K8b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,H,N,dtype", [
    (8, 2, 256, "float32"),    # K8b's shape (W a multiple of BLOCK_W)
    (5, 2, 256, "float32"),    # W not a multiple of 8: K8a
    (2, 2, 512, "float32"),    # N >= 512: K8a
    (8, 2, 256, "bfloat16"),
])
def test_attention_plain_matches_pallas_kernels_and_xla(W, H, N, dtype):
    """``_attention_plain`` against ``_attention_pallas`` (the kernel its
    rule picks, in interpret mode) and ``_attention_xla``."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, bias = _qkvb(W, H, N)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want_xla = jwa._attention_xla(jq, jk, jv, jnp.asarray(bias), SCALE)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jwa._attention_pallas(jq, jk, jv, jnp.asarray(bias),
                                            SCALE)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = wa._attention_plain(tq, tk, tv, torch.from_numpy(bias), SCALE)
    assert got.dtype == tq.dtype and got.shape == (W, H, N, HD)
    got = got.float().numpy()
    for want, tol in ((want_xla, (F32_ATOL, F32_RTOL)),
                      (want_pallas, (PALLAS_ATOL, PALLAS_RTOL))):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=tol[0], rtol=tol[1])
        else:
            assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("W,N,block_w", [
    (8, 256, 8), (16, 128, 8), (1024, 256, 8), (64, 256, 8),
    (5, 256, 8), (4, 256, 8), (12, 256, 8), (12, 256, 4),
    (8, 512, 8), (64, 1024, 8), (4, 1024, 8), (3, 448, 8),
])
def test_headmajor_dispatch_matches_attention_pallas(W, N, block_w,
                                                     monkeypatch):
    """The port's choice between K8a and K8b for (W, N) and BLOCK_W is the
    choice ``_attention_pallas`` makes between ``_attention_qtiled`` and
    ``_attention_batched``."""
    picked = []
    for mod, names in ((jwa, ("_attention_qtiled", "_attention_batched")),
                       (wa, ("_attention_qtiled_cuda",
                             "_attention_batched_cuda"))):
        monkeypatch.setattr(mod, "BLOCK_W", block_w)
        for kind, name in zip(("qtiled", "batched"), names):
            monkeypatch.setattr(mod, name, lambda q, *a, _k=kind, **kw: (
                picked.append(_k), q)[1])
    q = jnp.zeros((W, 1, N, HD))
    jwa._attention_pallas(q, q, q, jnp.zeros((1, N, N)), SCALE)
    t = torch.zeros(W, 1, N, HD)
    wa._attention_headmajor_cuda(t, t, t, torch.zeros(1, N, N), SCALE)
    assert len(picked) == 2 and picked[0] == picked[1], picked


def test_window_attention_gradients_match_jax_vjp():
    """Every input gradient of ``window_attention`` (plain forward, the
    backward differentiating the plain version) against ``jax.vjp`` of the
    JAX ``window_attention`` on the CPU, in f32."""
    q, k, v, bias = _qkvb(3, 2, 256, seed=1)
    gout = np.random.default_rng(2).normal(0, 1, q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jwa.window_attention(*a, SCALE),
                       *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(gout))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    got_out = wa.window_attention(*ts, SCALE)
    assert got_out.grad_fn is not None
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=F32_ATOL, rtol=F32_RTOL)
    got = torch.autograd.grad(got_out, ts, torch.from_numpy(gout))
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=F32_RTOL,
                                   atol=F32_ATOL * float(np.abs(b).max()),
                                   err_msg=f"input {i}")


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _bwd_inputs(W, N, H, seed):
    rng = np.random.default_rng(seed)
    D = H * HD
    return (rng.normal(0, 1, (W, N, 3 * D)).astype(np.float32),
            rng.normal(0, 0.5, (H, N, N)).astype(np.float32),
            rng.normal(0, 1, (W, N, D)).astype(np.float32))


def test_attention_bwd_qtiled_plain_matches_pallas_interpret(monkeypatch):
    """K7's mirror against ``_attention_qkv_bwd_large`` with the JAX
    ``BWD_MERGED`` False (``_attention_bwd_qtiled_pallas``'s two kernels in
    interpret mode, four q-tiles of 256) at H * N^2 * 4 = 8 MB: dq, dk, dv
    (interleaved as d_qkv) and d_bias."""
    monkeypatch.setattr(jwa, "BWD_MERGED", False)
    W, N, H = 1, 1024, 2
    qkv, bias, g = _bwd_inputs(W, N, H, seed=3)
    assert H * N * N * 4 > wa.BWD_MAX_SCORE_BYTES
    want = jwa._attention_qkv_bwd_large(*map(jnp.asarray, (qkv, bias, g)),
                                        SCALE, H, interpret=True)
    got = wa._attention_bwd_qtiled_plain(*map(torch.from_numpy,
                                              (qkv, bias, g)), SCALE, H)
    assert got[0].shape == (W, N, 3 * H * HD) and got[1].shape == (H, N, N)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_ATOL,
                                   rtol=F32_RTOL)


@pytest.mark.parametrize("merged,N,mirror", [
    (True, 1024, "_attention_bwd_merged_plain"),
    (False, 1024, "_attention_bwd_qtiled_plain"),
    (False, 256, "_attention_qkv_bwd_plain"),  # small N: K4 either way
])
def test_attention_bwd_takes_k7_when_bwd_merged_is_false(merged, N, mirror,
                                                          monkeypatch):
    """``_attention_bwd`` on CPU tensors calls the mirror of the kernel it
    launches on the card: K7's when ``BWD_MERGED`` is False at large N."""
    monkeypatch.setattr(wa, "BWD_MERGED", merged)
    calls = []
    for name in ("_attention_qkv_bwd_plain", "_attention_bwd_merged_plain",
                 "_attention_bwd_qtiled_plain"):
        real = getattr(wa, name)
        monkeypatch.setattr(wa, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    qkv, bias, g = map(torch.from_numpy, _bwd_inputs(1, N, 2, seed=4))
    wa._attention_bwd(qkv, bias, g, SCALE, 2)
    assert calls == [mirror]


@pytest.mark.parametrize("mirror,N", [
    ("_attention_qkv_bwd_plain", 196),      # 14x14 windows: K4 on the card
    ("_attention_bwd_merged_plain", 100),   # K5
    ("_attention_bwd_qtiled_plain", 100),   # K7
])
def test_padded_tokens_leave_the_backward_unchanged(mirror, N):
    """A ragged N runs the backward kernels padded to a multiple of 64
    (``_pad_tokens``): each kernel's mirror on the padded inputs, cut back
    to N, against ``jax.vjp`` of ``_attention_qkv_fused_xla`` on the
    unpadded ones, in f32."""
    H = 2
    qkv, bias, g = _bwd_inputs(2, N, H, seed=5)
    _, vjp = jax.vjp(
        lambda a, b: jwa._attention_qkv_fused_xla(a, b, SCALE, H),
        jnp.asarray(qkv), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    pad = -N % 64
    padded = wa._pad_tokens(*map(torch.from_numpy, (qkv, bias, g)), pad)
    assert padded[0].shape[1] == N + pad and padded[1].shape[1:] == (N + pad,) * 2
    dqkv, dbias = getattr(wa, mirror)(*padded, SCALE, H)
    assert not dqkv[:, N:].any() and not dbias[:, N:].any()
    for a, b in ((dqkv[:, :N], want[0]), (dbias[:, :N, :N], want[1])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=F32_RTOL,
                                   atol=F32_ATOL * float(np.abs(b).max()))


def test_block_q_other_than_the_default_is_refused(monkeypatch):
    """K8a's q-tile is fixed, so the card's dispatch raises on a BLOCK_Q
    other than the JAX default rather than ignore it."""
    t = torch.zeros(8, 1, 256, HD)
    monkeypatch.setattr(wa, "BLOCK_Q", 128)
    with pytest.raises(ValueError, match="BLOCK_Q=128"):
        wa._attention_headmajor_cuda(t, t, t, torch.zeros(1, 256, 256), SCALE)


# ---------------------------------------------------------------------------
# The model routes
# ---------------------------------------------------------------------------

#: A narrow TinyViT at 512 px: every stage's window has N % 128 == 0
#: (256, 256, 1024, 256), hd = 32.
NARROW = dict(image_size=512, embed_dims=(32, 64, 64, 96), depths=(1, 1, 1, 1),
              num_heads=(1, 2, 2, 3))
#: The head-major configuration: every attention stage a kernel stage that
#: N < QKV_KERNEL_MIN_N sends head-major, no fused-block stage.
HEAD_MAJOR = dict(pallas_attention_stages=(1, 2, 3), fused_block_stages=(),
                  fused_block_noproj_stages=())
ATOL, RTOL = 5e-4, 1e-3


def _randomise(variables, seed):
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


def _pair(dtype, seed=0, **fields):
    """(flax TinyViT, its seeded variables, the port TinyViT loaded with
    them) computing in ``dtype``."""
    jcfg = jtv.TinyViTConfig(dtype=getattr(jnp, dtype), **fields)
    jm = jtv.TinyViT(jcfg)
    x0 = jnp.zeros((1, fields["image_size"], fields["image_size"], 3))
    variables = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0),
                           seed)
    pm = ttv.TinyViT(ttv.TinyViTConfig(dtype=getattr(torch, dtype), **fields))
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm


def _count_calls(monkeypatch, *names):
    calls = {n: 0 for n in names}
    for n in names:
        real = getattr(wa, n)

        def counted(*a, _r=real, _n=n, **kw):
            calls[_n] += 1
            return _r(*a, **kw)

        monkeypatch.setattr(wa, n, counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_major_tinyvit_matches_flax(dtype, monkeypatch):
    """The head-major configuration with ``QKV_KERNEL_MIN_N`` raised on
    both packages: every stage's attention goes through
    ``window_attention`` and none through K3's op; the pooled embeddings
    match flax (f32: ATOL/RTOL of the model tests; bf16: cosine 0.9999 and
    2 % of the range, the two frameworks rounding at different points)."""
    monkeypatch.setattr(jwa, "QKV_KERNEL_MIN_N", 2048)
    monkeypatch.setattr(wa, "QKV_KERNEL_MIN_N", 2048)
    jm, variables, pm = _pair(dtype, seed=5, **NARROW, **HEAD_MAJOR)
    x = np.random.default_rng(6).normal(0, 1, (2, 512, 512, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x))).astype(
        np.float64)
    calls = _count_calls(monkeypatch, "window_attention",
                         "window_attention_qkv", "window_attention_qkv_xla")
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).double().numpy()
    assert calls == {"window_attention": 3, "window_attention_qkv": 0,
                     "window_attention_qkv_xla": 0}
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.9999, cos
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_kernel_free_stages_match_flax_gradients(monkeypatch):
    """``pallas_attention_stages=()`` and both fused lists empty: every
    block takes ``window_attention_qkv_xla`` (plain forward, the attention
    backward rule), and the output and every parameter gradient of
    sum(out^2) match flax's in f32."""
    tiny = dict(image_size=64, embed_dims=(16, 32, 64, 80),
                depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 5),
                window_sizes=(2, 2, 4, 2), pallas_attention_stages=(),
                fused_block_stages=(), fused_block_noproj_stages=())
    jm, variables, pm = _pair("float32", seed=7, **tiny)
    x = np.random.default_rng(8).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)

    def loss(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (_, want_out), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    calls = _count_calls(monkeypatch, "window_attention_qkv_xla",
                         "_attention_bwd")
    out = pm(torch.from_numpy(x))
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(out.pow(2).sum(), list(pm.parameters()))
    assert calls == {"window_attention_qkv_xla": 4, "_attention_bwd": 4}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=RTOL)
    got = to_jax_variables(dict(zip(names, grads)))["params"]
    want = jax.tree_util.tree_map(np.asarray, want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(
            flat_got[path], w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))
