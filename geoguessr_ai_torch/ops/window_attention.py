"""TinyViT window attention: the three ops of the TinyViT forward and
their backward.

Each op is a ``torch.autograd.Function`` that mirrors the JAX package's
``custom_vjp`` (geoguessr_ai_tpu/ops/window_attention.py).  Forward and
backward dispatch on the device of their input: a CPU tensor takes the
plain PyTorch versions, a CUDA tensor launches the hand-written kernels
(``csrc/``) or raises.  Signatures and layouts are those of the JAX
package:

* x is (W, N, C) window tokens, or the raw (B, H, W, C) map for the 4D
  block;
* w_qkv is (C, 3D) and its output channels are interleaved per head:
  head h owns [h*3hd, (h+1)*3hd), with q|k|v slots of hd inside;
* bias is the (H, N, N) additive attention bias;
* the head-major op ``window_attention`` takes q, k, v as (W, H, N, hd).

Kernels:

* K1 ``_fused_block_cuda``, K2 ``_fb_s2_cuda`` and K3
  ``_attention_qkv_fused_cuda``: the forwards (K1's and K2's bf16 entries:
  the Hopper LayerNorm + GEMM core ``csrc/ln_gemm_sm90.cuh``, then the
  forward core below as K3 runs it, and K1's out-projection on the GEMM
  core again);
* K9 ``_fb4d_cuda``: K1 over the raw map, the window partition done by
  tensor maps in K1's GEMM launches (in bf16; the f32 twin by index
  arithmetic in its attention launch);
* K4 ``_attention_qkv_bwd_cuda``, K5 ``_attention_bwd_merged_cuda`` and
  K7 ``_attention_bwd_qtiled_cuda``: the attention backward, K4 when the
  all-heads f32 score footprint H * N^2 * 4 is at most 6 MB (stages 1 and
  3), else K5, or K7 when ``BWD_MERGED`` is False (stage 2).  In bf16 all
  three run the Hopper core ``csrc/attention_bwd_sm90.cuh`` (TMA loads
  through tensor maps over qkv and g, wgmma, persistent blocks; d_bias
  summed per group of windows, ``_bwd_groups``), which reads qkv and g in
  place and so needs their TMA layout (``_bwd_layout``).  K5 and K7 then
  run the same launches: K5 with one window group, K7 with
  ``_bwd_groups`` (also one at stage 2), both with t in a second pass, so
  at one group their bits are equal; ``BWD_MERGED`` still picks the
  wrapper, and each counts its own launches;
* K8a ``_attention_qtiled_cuda`` and K8b ``_attention_batched_cuda``: the
  head-major ``window_attention``, chosen as ``_attention_pallas`` chooses.
  In bf16 both, and K3, run one Hopper forward core
  (``csrc/attention_fwd_sm90.cuh``: TMA, wgmma, persistent blocks that keep
  a (head, q-tile) bias tile resident over a group of windows,
  ``_headmajor_groups``, or for K8a's f32 tile at large N stream it in
  chunks over four windows), which needs the TMA layout of its operands
  (``_headmajor_layout``, ``_qkv_layout``).

The kernels take activations in one of ``KERNEL_DTYPES``, the compute
dtype (``BackboneConfig.dtype``): each C entry has a bf16 and an f32 twin,
and a CUDA tensor of another dtype, or operands of two dtypes, raises.
Weights, the qkv bias and the attention bias are cast to the activations'
dtype as the plain versions cast them; the attention bias travels in that
dtype into K1-K4 and K9, as it does into the Pallas kernels, and f32 into
K5, K7 and K8.  The head dim is one of ``KERNEL_HEAD_DIMS``.  Every
wrapper adds one to its entry in ``LAUNCHES`` each time it launches its
kernel.

The module constants below are the JAX module's, with its defaults.  The
JAX package reads them when it traces; the port reads them at each call,
so a caller sets one before building or calling, as the JAX tools do.
"""

from __future__ import annotations

import math

import torch

#: Launches of each kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {
    "_fused_block_cuda": 0,
    "_fb_s2_cuda": 0,
    "_attention_qkv_fused_cuda": 0,
    "_attention_qkv_bwd_cuda": 0,
    "_attention_bwd_merged_cuda": 0,
    "_fb4d_cuda": 0,
    "_attention_bwd_qtiled_cuda": 0,
    "_attention_qtiled_cuda": 0,
    "_attention_batched_cuda": 0,
}

#: Head dims the kernels are built for: the multiples of mma.sync's k-step
#: of 16 up to 64 (every TinyViT stage has 32).
KERNEL_HEAD_DIMS = (16, 32, 64)
#: Activation dtypes the kernels take (``_build.typed_entry``).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

#: Largest all-heads f32 score footprint H * N^2 * 4 that takes the
#: small-N backward (K4); above it the large-N one (K5).  The JAX
#: package's _BWD_MAX_SCORE_BYTES.
BWD_MAX_SCORE_BYTES = 6 * 1024 * 1024

#: q-tile rows of the Pallas large-N head-major kernel, with the JAX
#: default.  K8a's q-tile is the 64 rows of the forward core's wgmma, so
#: the card's dispatch refuses any other value rather than ignore it.
BLOCK_Q = 256
#: Minimum window size N at which ``WindowAttention`` takes the qkv-fused
#: kernel (K3) over the head-major ``window_attention`` (K8a/K8b).  0 sends
#: every kernel stage to K3; raise it above a stage's N to route that stage
#: head-major.
QKV_KERNEL_MIN_N = 0
#: Windows of one head per K8b block.  ``window_attention`` takes K8b when
#: N < 512 and W is a multiple of it, else K8a.
BLOCK_W = 8
#: Large-N attention backward: the merged one (K5) when True, the
#: two-kernel one (K7) when False.  Both compute the same cotangents from
#: the f32 bias.
BWD_MERGED = True
#: Work items the d_bias launch of K4's and K7's bf16 core aims at: it
#: sums ds over the windows per (128-query tile, 64-key tile, head) item,
#: and cuts the windows into as many groups as bring the items up to this
#: many (``_bwd_groups``), about 8 an SM of an H100.
_BWD_DBIAS_ITEMS = 1024
#: Work items K8b's bf16 kernel aims at: an item is one (64-query tile,
#: window group, head) with its bias tile resident, and the windows are cut
#: into as many groups as bring the items up to this many
#: (``_headmajor_groups``), about 8 an SM of an H100.
_HEADMAJOR_ITEMS = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: the oracle of each kernel, and the CPU path.
# ---------------------------------------------------------------------------


def _layer_norm_f32(x, ln_scale, ln_bias, eps):
    """LayerNorm with f32 statistics (mean, then mean of squared
    deviations), returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (
        xc * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    ).to(x.dtype)


def _attention_qkv_fused_plain(qkv, bias, scale, num_heads):
    """Mirror of ``_attention_qkv_fused_xla``: f32 scores and softmax,
    probabilities cast to the value dtype before p.v."""
    W, N, D3 = qkv.shape
    hd = D3 // (3 * num_heads)
    q, k, v = qkv.reshape(W, N, num_heads, 3 * hd).split(hd, dim=-1)
    s = torch.einsum("wnhd,wmhd->whnm", q.float(), k.float())
    s = s * scale + bias[None].float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("whnm,wmhd->wnhd", p, v)
    return o.reshape(W, N, num_heads * hd)


def _attention_plain(q, k, v, bias, scale):
    """Mirror of ``_attention_xla``: (W, H, N, hd) q, k, v, f32 scores plus
    the bias in f32, f32 softmax, probabilities cast to the value dtype
    before p.v.  -> (W, H, N, hd) in the value dtype."""
    s = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    s = s * scale + bias[None].float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("whnm,whmd->whnd", p, v)


def _ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps):
    ln = _layer_norm_f32(x, ln_scale, ln_bias, eps)
    return ln @ w_qkv.to(x.dtype) + b_qkv.to(x.dtype)


def _fused_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                       bias, scale, num_heads, eps,
                       attn_fn=_attention_qkv_fused_plain):
    """Mirror of ``_fused_block_xla``; ``attn_fn`` computes the attention
    from qkv (the backwards pass ``_WindowAttentionQKV.apply``)."""
    qkv = _ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    o = attn_fn(qkv, bias, scale, num_heads)
    return o @ w_proj.to(x.dtype) + b_proj.to(x.dtype)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, window*window, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_unpartition(x: torch.Tensor, window: int, hw) -> torch.Tensor:
    H, W = hw
    B = x.shape[0] // ((H // window) * (W // window))
    x = x.reshape(B, H // window, W // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _fb4d_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
                scale, num_heads, window, eps,
                attn_fn=_attention_qkv_fused_plain):
    """Mirror of ``_fb4d_xla``: partition, the fused block, unpartition."""
    out = _fused_block_plain(window_partition(x, window), ln_scale, ln_bias,
                             w_qkv, b_qkv, w_proj, b_proj, bias, scale,
                             num_heads, eps, attn_fn)
    return window_unpartition(out, window, x.shape[1:3])


def _fb_s2_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                 num_heads, eps):
    """Mirror of ``_fb_s2_xla``."""
    qkv = _ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return _attention_qkv_fused_plain(qkv, bias, scale, num_heads)


def _attention_bwd_plain(qkv, bias, g, scale, num_heads):
    """The attention cotangents of both backward kernels, in f32 from the
    given bias: p in f32, dv from p rounded to the qkv dtype, dq and dk
    from ds rounded to it and scaled after the f32 product, d_bias the f32
    sum of ds over the windows.  Returns (d_qkv in the qkv dtype,
    interleaved like qkv, and d_bias (H, N, N) f32)."""
    W, N, D3 = qkv.shape
    hd = D3 // (3 * num_heads)
    q, k, v = (t.float() for t in
               qkv.reshape(W, N, num_heads, 3 * hd).split(hd, dim=-1))
    gh = g.reshape(W, N, num_heads, hd).float()
    s = torch.einsum("wnhd,wmhd->whnm", q, k) * scale + bias[None].float()
    p = torch.softmax(s, dim=-1)
    del s
    dp = torch.einsum("wnhd,wmhd->whnm", gh, v)
    dv = torch.einsum("whnm,wnhd->wmhd", p.to(qkv.dtype).float(), gh)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    dsv = ds.to(qkv.dtype).float()
    dq = torch.einsum("whnm,wmhd->wnhd", dsv, k) * scale
    dk = torch.einsum("whnm,wnhd->wmhd", dsv, q) * scale
    dqkv = torch.cat([dq, dk, dv], dim=-1).reshape(W, N, D3)
    return dqkv.to(qkv.dtype), ds.sum(0)


def _attention_qkv_bwd_plain(qkv, bias, g, scale, num_heads):
    """Mirror of ``_qkv_bwd_kernel`` (K4): the bias rounded to the qkv
    dtype, as ``_attention_qkv_bwd_pallas`` casts it."""
    return _attention_bwd_plain(qkv, bias.to(qkv.dtype), g, scale, num_heads)


def _attention_bwd_merged_plain(qkv, bias, g, scale, num_heads):
    """Mirror of ``_bwd_tile_math`` over whole rows with the staging of
    ``_attention_qkv_bwd_large`` (K5): the bias in f32, dq/dk/dv in f32
    and cast once to the qkv dtype."""
    return _attention_bwd_plain(qkv, bias.float(), g, scale, num_heads)


def _attention_bwd_qtiled_plain(qkv, bias, g, scale, num_heads):
    """Mirror of ``_bwd_k1_kernel`` (dq, dk, dv) and ``_bwd_k2_kernel``
    (d_bias) with the staging of ``_attention_qkv_bwd_large`` (K7): both
    run ``_bwd_tile_math``, as K5 does, so the f32-bias numerics of K5's
    mirror; dq/dk/dv summed in f32 and cast once to the qkv dtype, d_bias
    summed over the windows in f32."""
    return _attention_bwd_plain(qkv, bias.float(), g, scale, num_heads)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check(name, t, shape, dtype=torch.bfloat16):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return t


def _act_dtype(**operands):
    """The one dtype of the activation operands, one of KERNEL_DTYPES;
    raises ValueError on another dtype or on operands of two dtypes."""
    dtypes = {t.dtype for t in operands.values()}
    if len(dtypes) > 1:
        raise ValueError("the kernels take operands of one dtype, got mixed "
                         + ", ".join(f"{n} {t.dtype}"
                                     for n, t in operands.items()))
    (dtype,) = dtypes
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernels take torch.bfloat16 or torch.float32, "
                         f"got {dtype}")
    return dtype


def _head_dim(D, H):
    """The head dim D / H, which must be one of KERNEL_HEAD_DIMS."""
    hd = D // H
    if hd * H != D or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the kernels take a head dim in {KERNEL_HEAD_DIMS}, got D={D}, "
            f"H={H}")
    return hd


def _check_geometry(W, N, C, D, H, gemm=False):
    """Returns the head dim.  ``gemm``: the kernel also runs the qkv GEMM
    (3D output columns) and the out-projection (D input channels) on 64-wide
    tiles, so D must be a multiple of 64 too."""
    hd = _head_dim(D, H)
    if N % 64 or C % 64 or W < 1 or W > 65535 or (gemm and D % 64):
        raise ValueError(
            f"the kernels take N and C multiples of 64, 1 <= W <= 65535"
            f"{' and D a multiple of 64' if gemm else ''}, got W={W}, N={N}, "
            f"C={C}, D={D}")
    return hd


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({torch.cuda.CudaError(err)})")


def _bias_as(bias, H, N, dtype):
    return _check("bias", bias.to(dtype).contiguous(), (H, N, N), dtype)


def _weight_t(w, rows, cols, dtype):
    """(in, out) JAX-layout weight -> the (out, in) rows in ``dtype`` the
    kernel reads.  No copy when w is the transpose view of a contiguous
    (out, in) weight of that dtype, as the model passes it."""
    return _check("weight", w.t().to(dtype).contiguous(), (rows, cols), dtype)


def _vec_f32(v, n, name):
    return _check(name, v.float().contiguous(), (n,), torch.float32)


def _qkv_layout(qkv, bias, num_heads):
    """Returns (W, N, D, hd) when the tensor maps of K3's bf16 kernel can
    read qkv and the bias in place, else raises ValueError naming the rule
    it breaks.  Each argument is a tensor's (shape, strides, base address,
    element size).  TMA reads boxes of (hd, 64 rows) of bf16 from the (W,
    N, 3D) qkv at column (3 h + slot) hd and boxes of (64, 64 rows) of bf16
    from the (H, N, N) bias, each from a 16-byte aligned base with rows a
    multiple of 16 bytes apart, and the C entry takes no strides: both
    contiguous bf16, a head dim in KERNEL_HEAD_DIMS, N a multiple of 64 and
    1 <= W <= 65535."""
    shape = tuple(qkv[0])
    if len(shape) != 3 or shape[-1] % 3:
        raise ValueError(f"qkv must be (W, N, 3D), got {shape}")
    W, N, D3 = shape
    D = D3 // 3
    hd = _head_dim(D, num_heads)
    if not 1 <= W <= 65535 or N < 64 or N % 64:
        raise ValueError(f"K3 takes N a multiple of 64 and 1 <= W <= 65535, "
                         f"got W={W}, N={N}")
    want = {"qkv": shape, "bias": (num_heads, N, N)}
    for name, (t_shape, strides, ptr, elem) in zip(want, (qkv, bias)):
        w_shape = want[name]
        if elem != 2:
            raise ValueError(f"{name} must have 2-byte elements, got {elem}")
        if tuple(t_shape) != w_shape:
            raise ValueError(f"{name} must be {w_shape}, got {tuple(t_shape)}")
        if ptr % 16:
            raise ValueError(f"{name} must have a 16-byte aligned base, got "
                             f"address {ptr:#x}")
        if strides[-1] != 1 or strides[-2] * elem % 16:
            raise ValueError(f"{name} rows must be a multiple of 16 bytes "
                             f"apart, got strides {tuple(strides)}")
        dense = (w_shape[1] * w_shape[2], w_shape[2], 1)
        if any(n > 1 and st != d for n, st, d in zip(w_shape, strides, dense)):
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{tuple(strides)} for shape {w_shape}")
    return W, N, D, hd


def _attention_qkv_fused_cuda(qkv, bias, scale, num_heads):
    """K3: (W, N, 3D) qkv and the bias in qkv's dtype -> (W, N, D).  The
    bf16 kernel is the Hopper forward core in the interleaved layout, which
    needs ``_qkv_layout`` and walks ``_headmajor_groups`` window groups
    with the item's 64 x N bias tile resident: it takes every N (a multiple
    of 64) up to 1024 at every head dim, and raises where no ring fits
    beside that tile (first at N = 1280 with hd 64).  The f32 twin runs
    the first design."""
    from geoguessr_ai_torch.ops import _build

    W, N, D3 = qkv.shape
    D = D3 // 3
    hd = _check_geometry(W, N, 64, D, num_heads)
    dt = _act_dtype(qkv=qkv)
    _check("qkv", qkv, (W, N, D3), dt)
    bias = _bias_as(bias, num_heads, N, dt)
    groups = 1
    if dt == torch.bfloat16:
        _qkv_layout(*((t.shape, t.stride(), t.data_ptr(), t.element_size())
                      for t in (qkv, bias)), num_heads)
        groups = _headmajor_groups(W, num_heads, N)
    out = torch.empty((W, N, D), dtype=qkv.dtype, device=qkv.device)
    fn = _build.typed_entry("attention_qkv", "attention_qkv", dt)
    err = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), W, N,
             num_heads, hd, groups, float(scale), _stream())
    _raise_on(err, "_attention_qkv_fused_cuda")
    LAUNCHES["_attention_qkv_fused_cuda"] += 1
    return out


#: Largest window size and channel count K2's bf16 entry takes: the
#: attention's resident bf16 64 x N bias tile fits beside a ring up to
#: N = 1024 at every head dim, and K2 takes C up to 448 (TinyViT's stage-2
#: widths; the GEMM core itself takes K up to LN_GEMM_MAX_K).
FB_S2_MAX_N = 1024
FB_S2_MAX_C = 448
#: Largest K the Hopper LayerNorm + GEMM core (``csrc/ln_gemm_sm90.cuh``)
#: takes: it keeps a 128-row tile of K columns in shared memory beside a
#: ring of four 64 x 64 weight boxes, built for K up to 576 (kMaxKB boxes).
#: K1's and K9's bf16 entries run it with K = C (the qkv GEMM) and K = D
#: (the out-projection).
LN_GEMM_MAX_K = 576


def _fb_s2_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                num_heads, eps):
    """K2: (W, N, C) x -> (W, N, D), LayerNorm, the qkv GEMM into a (W, N,
    3D) scratch and the attention.  The bf16 entry runs the Hopper
    LayerNorm + GEMM core and then the forward core in its interleaved
    layout over ``_headmajor_groups`` window groups (as K3), which takes N
    up to FB_S2_MAX_N and C up to FB_S2_MAX_C; the f32 twin runs the first
    design."""
    from geoguessr_ai_torch.ops import _build

    W, N, C = x.shape
    D = w_qkv.shape[1] // 3
    hd = _check_geometry(W, N, C, D, num_heads, gemm=True)
    dt = _act_dtype(x=x)
    _check("x", x, (W, N, C), dt)
    ls = _vec_f32(ln_scale, C, "ln_scale")
    lb = _vec_f32(ln_bias, C, "ln_bias")
    wq = _weight_t(w_qkv, 3 * D, C, dt)
    # the qkv GEMM adds its bias in x's dtype, as the TPU kernel does
    bq = _vec_f32(b_qkv.to(dt), 3 * D, "b_qkv")
    bias = _bias_as(bias, num_heads, N, dt)
    qkv = torch.empty((W, N, 3 * D), dtype=x.dtype, device=x.device)
    out = torch.empty((W, N, D), dtype=x.dtype, device=x.device)
    groups = 1
    if dt == torch.bfloat16:
        if N > FB_S2_MAX_N or C > FB_S2_MAX_C:
            raise ValueError(f"K2 takes N up to {FB_S2_MAX_N} and C up to "
                             f"{FB_S2_MAX_C} in bf16, got N={N}, C={C}")
        _qkv_layout(*((t.shape, t.stride(), t.data_ptr(), t.element_size())
                      for t in (qkv, bias)), num_heads)
        groups = _headmajor_groups(W, num_heads, N)
    fn = _build.typed_entry("fb_s2", "fb_s2", dt)
    err = fn(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wq.data_ptr(),
             bq.data_ptr(), bias.data_ptr(), qkv.data_ptr(), out.data_ptr(),
             W, N, C, num_heads, hd, groups, float(scale), float(eps),
             _stream())
    _raise_on(err, "_fb_s2_cuda")
    LAUNCHES["_fb_s2_cuda"] += 1
    return out


def _fused_block_plan(N, C, D, window=None):
    """Raises ValueError where K1's bf16 entry (or, given the ``window``
    side, K9's) has no plan: the attention keeps a bf16 64 x N bias tile
    resident (N up to FB_S2_MAX_N), the GEMM core takes K up to
    LN_GEMM_MAX_K (C for the qkv GEMM, D for the out-projection), and K9's
    window map reads 128-row tiles of one window in boxes of whole window
    rows (a side dividing 64, N a multiple of 128: 16 or 32)."""
    name = "K1" if window is None else "K9"
    if N > FB_S2_MAX_N or C > LN_GEMM_MAX_K or D > LN_GEMM_MAX_K:
        raise ValueError(f"{name} takes N up to {FB_S2_MAX_N} and C, D up to "
                         f"{LN_GEMM_MAX_K} in bf16, got N={N}, C={C}, D={D}")
    if window is not None and (64 % window or N % 128):
        raise ValueError(f"K9 takes a window side dividing 64 with N a "
                         f"multiple of 128 in bf16 (16 or 32), got {window}")


def _fused_block_launch(lib, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                        b_proj, bias, num_heads, W, N, geometry, scale, eps):
    """K1 and K9's shared launch: converts the operands to what the
    kernels read, allocates qkv (W, N, 3D) and the attention output (W, N,
    D) as scratch, and calls ``lib``'s entry with ``geometry``, the window
    groups, scale and eps before the stream.  In bf16 the entry runs the
    Hopper cores, whose attention reads qkv through a tensor map
    (``_qkv_layout``) over ``_headmajor_groups`` window groups; the f32
    twin ignores the groups.  Returns (the entry's error code, the output
    shaped like x)."""
    from geoguessr_ai_torch.ops import _build

    C = x.shape[-1]
    D = w_proj.shape[0]
    dt = x.dtype
    ls = _vec_f32(ln_scale, C, "ln_scale")
    lb = _vec_f32(ln_bias, C, "ln_bias")
    wq = _weight_t(w_qkv, 3 * D, C, dt)
    # the qkv GEMM adds its bias in x's dtype, as the TPU kernel does
    bq = _vec_f32(b_qkv.to(dt), 3 * D, "b_qkv")
    wp = _weight_t(w_proj, C, D, dt)
    bp = _vec_f32(b_proj, C, "b_proj")
    bias = _bias_as(bias, num_heads, N, dt)
    qkv = torch.empty((W, N, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty((W, N, D), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    groups = 1
    if dt == torch.bfloat16:
        _qkv_layout(*((t.shape, t.stride(), t.data_ptr(), t.element_size())
                      for t in (qkv, bias)), num_heads)
        groups = _headmajor_groups(W, num_heads, N)
    err = _build.typed_entry(lib, lib, dt)(
        x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wq.data_ptr(),
        bq.data_ptr(), wp.data_ptr(), bp.data_ptr(), bias.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), *geometry, groups,
        float(scale), float(eps), _stream())
    return err, out


def _fused_block_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                      bias, scale, num_heads, eps):
    """K1: (W, N, C) x -> (W, N, C).  The bf16 entry runs the Hopper
    LayerNorm + GEMM core (the qkv GEMM), the forward core in its
    interleaved layout over ``_headmajor_groups`` window groups, and the
    core again without LayerNorm (the out-projection); it takes N up to
    FB_S2_MAX_N and C, D up to LN_GEMM_MAX_K and raises above
    (``_fused_block_plan``).  The f32 twin runs the first design."""
    W, N, C = x.shape
    D = w_proj.shape[0]
    hd = _check_geometry(W, N, C, D, num_heads, gemm=True)
    dt = _act_dtype(x=x)
    _check("x", x, (W, N, C), dt)
    if dt == torch.bfloat16:
        _fused_block_plan(N, C, D)
    err, out = _fused_block_launch(
        "fused_block", x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
        bias, num_heads, W, N, (W, N, C, num_heads, hd), scale, eps)
    _raise_on(err, "_fused_block_cuda")
    LAUNCHES["_fused_block_cuda"] += 1
    return out


def _fb4d_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
               scale, num_heads, window, eps):
    """K9: the (B, Hm, Wm, C) map -> the same shape, K1 over its windows.
    The bf16 entry runs K1's three launches with the partition in tensor
    maps: the qkv GEMM reads x and the out-projection writes out in window
    order through a 5D map over the map, so qkv and the attention output
    are K1's window-ordered scratch (``_fused_block_plan`` with the window
    side).  The f32 twin runs the first design, its scratch in map order."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, Hm, Wm, C = x.shape
    N = window * window
    if Hm % window or Wm % window:
        raise ValueError(f"the map {Hm}x{Wm} is not a whole number of "
                         f"{window}x{window} windows")
    W = B * (Hm // window) * (Wm // window)
    D = w_proj.shape[0]
    hd = _check_geometry(W, N, C, D, num_heads, gemm=True)
    dt = _act_dtype(x=x)
    _check("x", x, (B, Hm, Wm, C), dt)
    if dt == torch.bfloat16:
        _fused_block_plan(N, C, D, window)
    err, out = _fused_block_launch(
        "fb4d", x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
        num_heads, W, N, (B, Hm, Wm, C, num_heads, hd, window), scale, eps)
    _raise_on(err, "_fb4d_cuda")
    LAUNCHES["_fb4d_cuda"] += 1
    return out


#: The bias from every query to a padding key: its exp underflows to 0 in
#: f32 (and it is finite in bf16), so no query attends to a padding key.
PAD_KEY_BIAS = -1e30


def _pad_tokens(qkv, bias, g, pad):
    """(qkv, bias, g) with ``pad`` zero tokens after each window's N, for
    the backward kernels, which tile N by 64.  A padding key has bias
    PAD_KEY_BIAS, so p is 0 there and it adds nothing to the real rows; a
    padding query has g = 0, so dp and ds are 0 on its row and it adds
    nothing to dk, dv or d_bias.  The caller cuts the padding off the
    cotangents."""
    F = torch.nn.functional
    N = qkv.shape[1]
    bias = F.pad(bias, (0, pad, 0, pad))
    bias[:, :, N:] = PAD_KEY_BIAS
    return F.pad(qkv, (0, 0, 0, pad)), bias, F.pad(g, (0, 0, 0, pad))


def _bwd_groups(W, N, H):
    """The window groups G of the d_bias launch of K4's and K7's bf16
    core, a function of (W, N, H) only (never of the card): enough groups
    that its (128-query tile, 64-key tile, head, group) items number about
    _BWD_DBIAS_ITEMS, at most one a window; group i sums windows
    [i W // G, (i + 1) W // G) in order.  21 at K4's stage 1 (W=1024,
    N=256, H=6), 7 at stage 3 (W=64, H=18), 1 at K7's (W=64, N=1024,
    H=12)."""
    tiles = _bwd_items(W, N, H, 1)["dbias"]
    return max(1, min(W, _BWD_DBIAS_ITEMS // tiles))


def _bwd_items(W, N, H, G):
    """Work items of each launch of the bf16 core: the row statistics, dk
    and dv, dq (a 128-row tile of one window and head each) and d_bias (a
    128 x 64 tile of one head over one group of windows)."""
    rows = -(-N // 128) * W * H
    return {"stats": rows, "dkdv": rows, "dq": rows,
            "dbias": (N // 64) * -(-N // 128) * G * H}


def _bwd_scratch_shapes(W, N, H, G):
    """Scratch the wrapper allocates for one call: the (3, W, H, N) f32
    row statistics, and the (G, H, N, N) f32 d_bias partials when G > 1
    (None: the d_bias launch writes d_bias itself)."""
    return {"stats": (3, W, H, N),
            "partial": (G, H, N, N) if G > 1 else None}


def _bwd_layout(qkv_shape, qkv_strides, qkv_ptr, g_shape, g_strides, g_ptr,
                elem_size, num_heads):
    """Returns (W, N, D, hd) when the bf16 core's two tensor maps can read
    qkv (W, N, 3D) and g (W, N, D) in place, else raises ValueError
    naming the rule it breaks.  TMA reads boxes of (hd, 64 rows) of bf16
    from a 16-byte aligned base with rows a multiple of 16 bytes apart, and
    the C entries take no strides: both tensors contiguous bf16, N a
    multiple of 64 (the caller pads it), a head dim in KERNEL_HEAD_DIMS."""
    if elem_size != 2:
        raise ValueError(f"the bf16 core reads 2-byte elements, got "
                         f"{elem_size}")
    if len(qkv_shape) != 3 or qkv_shape[-1] % 3:
        raise ValueError(f"qkv must be (W, N, 3D), got {tuple(qkv_shape)}")
    W, N, D3 = qkv_shape
    D = D3 // 3
    hd = _head_dim(D, num_heads)
    if tuple(g_shape) != (W, N, D):
        raise ValueError(f"g must be {(W, N, D)}, got {tuple(g_shape)}")
    if not 1 <= W <= 65535 or N < 64 or N % 64:
        raise ValueError(f"the kernels take 1 <= W <= 65535 and N a "
                         f"multiple of 64, got W={W}, N={N}")
    for name, shape, strides, ptr in (("qkv", qkv_shape, qkv_strides,
                                       qkv_ptr),
                                      ("g", g_shape, g_strides, g_ptr)):
        if ptr % 16:
            raise ValueError(f"{name} must have a 16-byte aligned base, got "
                             f"address {ptr:#x}")
        if strides[-1] != 1 or strides[1] * elem_size % 16:
            raise ValueError(f"{name} rows must be a multiple of 16 bytes "
                             f"apart, got strides {tuple(strides)}")
        want = (shape[1] * shape[2], shape[2], 1)
        if any(n > 1 and st != w for n, st, w in zip(shape, strides, want)):
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{tuple(strides)} for shape {tuple(shape)}")
    return W, N, D, hd


def _attention_bwd_cuda(name, lib, qkv, bias, g, scale, num_heads,
                        bias_dtype=None):
    """K4, K5 or K7's launch, the bias in ``bias_dtype`` (None: qkv's
    dtype); an N that is not a multiple of 64 (a ragged window such as
    14x14 or 28x28) runs padded (``_pad_tokens``).  In bf16 all three run
    the Hopper core, which needs ``_bwd_layout``; K4 and K7 also take the
    d_bias partials of its window groups (``_bwd_groups``), while K5 sums
    all windows in one group, and the f32 twins take no groups."""
    from geoguessr_ai_torch.ops import _build

    dt = _act_dtype(qkv=qkv, g=g)
    bias_dtype = bias_dtype or dt
    N = qkv.shape[1]
    pad = -N % 64
    if pad:
        qkv, bias, g = _pad_tokens(qkv, bias.to(bias_dtype), g, pad)
    W, Np, D3 = qkv.shape
    D = D3 // 3
    hd = _check_geometry(W, Np, 64, D, num_heads)
    _check("qkv", qkv, (W, Np, D3), dt)
    _check("g", g, (W, Np, D), dt)
    bias = _check("bias", bias.to(bias_dtype).contiguous(),
                  (num_heads, Np, Np), bias_dtype)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((num_heads, Np, Np), dtype=torch.float32,
                        device=qkv.device)
    # K5 sums d_bias over the windows in one group and takes no partials
    grouped = lib != "attention_bwd_merged"
    G = 1
    if dt == torch.bfloat16:
        _bwd_layout(qkv.shape, qkv.stride(), qkv.data_ptr(), g.shape,
                    g.stride(), g.data_ptr(), qkv.element_size(), num_heads)
        if grouped:
            G = _bwd_groups(W, Np, num_heads)
    shapes = _bwd_scratch_shapes(W, Np, num_heads, G)
    # row max, 1 / row sum and t per (window, head, query)
    stats = torch.empty(shapes["stats"], dtype=torch.float32,
                        device=qkv.device)
    partial = None if shapes["partial"] is None else torch.empty(
        shapes["partial"], dtype=torch.float32, device=qkv.device)
    fn = _build.typed_entry(lib, lib, dt)
    ptrs = (qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), stats.data_ptr())
    if grouped:
        err = fn(*ptrs, 0 if partial is None else partial.data_ptr(), W, Np,
                 num_heads, hd, G, float(scale), _stream())
    else:
        err = fn(*ptrs, W, Np, num_heads, hd, float(scale), _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    if pad:
        return (dqkv[:, :N].contiguous(),
                dbias[:, :N, :N].contiguous())
    return dqkv, dbias


def _attention_qkv_bwd_cuda(qkv, bias, g, scale, num_heads):
    """K4: (d_qkv in qkv's dtype, d_bias f32) with the bias in qkv's dtype
    (rounded to bf16 in bf16), d_bias summed over the windows in an order
    fixed by the shape (bitwise reproducible)."""
    return _attention_bwd_cuda("_attention_qkv_bwd_cuda", "attention_qkv_bwd",
                               qkv, bias, g, scale, num_heads)


def _attention_bwd_merged_cuda(qkv, bias, g, scale, num_heads):
    """K5: (d_qkv in qkv's dtype, d_bias f32) with the bias in f32, d_bias
    summed over the windows in order (bitwise reproducible).  In bf16 it
    runs K7's Hopper core with one window group, so its bits are K7's
    wherever ``_bwd_groups`` is one."""
    return _attention_bwd_cuda("_attention_bwd_merged_cuda",
                               "attention_bwd_merged", qkv, bias, g, scale,
                               num_heads, torch.float32)


def _attention_bwd_qtiled_cuda(qkv, bias, g, scale, num_heads):
    """K7: (d_qkv in qkv's dtype, d_bias f32) with the bias in f32, the
    d_qkv side and the d_bias side as separate launches, d_bias summed over
    the windows in an order fixed by the shape (bitwise reproducible)."""
    return _attention_bwd_cuda("_attention_bwd_qtiled_cuda",
                               "attention_bwd_qtiled", qkv, bias, g, scale,
                               num_heads, torch.float32)


def _headmajor_operands(q, k, v, bias):
    """Checks the head-major operands; returns (W, H, N, hd, the f32
    bias, their dtype)."""
    W, H, N, hd = q.shape
    _head_dim(H * hd, H)
    if N % 64 or not 1 <= W <= 65535 or H > 65535:
        raise ValueError(f"the kernels take N a multiple of 64, "
                         f"1 <= W <= 65535 and H <= 65535, got W={W}, "
                         f"N={N}, H={H}")
    dt = _act_dtype(q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, (W, H, N, hd), dt)
    bias = _check("bias", bias.float().contiguous(), (H, N, N), torch.float32)
    return W, H, N, hd, bias, dt


def _headmajor_groups(W, H, N):
    """The window groups G of the bf16 forward core (K3, K8a, K8b) where it
    keeps the bias tile resident, a function of (W, H, N) only (never of
    the card): enough groups that its (64-query tile, group, head) items
    number about _HEADMAJOR_ITEMS, at most one a pair of windows, so that
    both consumer warpgroups of an item have a window; group i holds
    windows [i W // G, (i + 1) W // G), walked in order by the block that
    owns the item.  42 at stage 1 of a serving bucket of 16 (W=1024, H=6,
    N=256), 14 at stage 3 (W=64, H=18), 2 at stage 3 of a bucket of 1
    (W=4).  Where K8a streams the bias (its f32 tile does not fit), the
    core takes groups of at most four windows instead, ceil(W / 4) of
    them, whatever G it is given."""
    tiles = (N // 64) * H
    return max(1, min(-(-W // 2), _HEADMAJOR_ITEMS // tiles))


def _headmajor_items(W, H, N, G):
    """Work items of K8b's bf16 kernel: (64-query tile, window group,
    head), the q-tile fastest, so the items of one (group, head) run side
    by side and share each window's k and v in L2."""
    return (N // 64) * G * H


def _headmajor_layout(q, k, v, bias, max_n=512):
    """Returns (W, H, N, hd) when the tensor maps of K8a's and K8b's bf16
    kernel can read q, k, v and the bias in place, else raises ValueError
    naming the rule it breaks.  Each argument is a tensor's (shape,
    strides, base address, element size).  TMA reads boxes of (hd, 64 rows)
    of bf16 from q, k, v, seen as (W H, N, hd) rows, and boxes of (32, 64
    rows) of f32 from the (H, N, N) bias, each from a 16-byte aligned base
    with rows a multiple of 16 bytes apart, and the C entry takes no
    strides: all four contiguous, q, k, v bf16 of one (W, H, N, hd) shape
    with a head dim in KERNEL_HEAD_DIMS and N a multiple of 64 (below
    ``max_n``, K8b's 512, when given), the bias f32 (H, N, N), and W H
    below 2^31 (the maps' int coordinates)."""
    shape = tuple(q[0])
    if len(shape) != 4:
        raise ValueError(f"q must be (W, H, N, hd), got {shape}")
    W, H, N, hd = shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernels take a head dim in {KERNEL_HEAD_DIMS}, "
                         f"got {hd}")
    if W < 1 or H < 1 or W * H >= 2 ** 31 or N < 64 or N % 64 or (
            max_n is not None and N >= max_n):
        below = "" if max_n is None else f" below {max_n}"
        raise ValueError(f"the kernel takes N a multiple of 64{below} and "
                         f"1 <= W H < 2^31, got W={W}, H={H}, N={N}")
    want = {"q": (shape, 2), "k": (shape, 2), "v": (shape, 2),
            "bias": ((H, N, N), 4)}
    for name, (t_shape, strides, ptr, elem) in zip(want, (q, k, v, bias)):
        w_shape, w_elem = want[name]
        if elem != w_elem:
            raise ValueError(f"{name} must have {w_elem}-byte elements, got "
                             f"{elem}")
        if tuple(t_shape) != w_shape:
            raise ValueError(f"{name} must be {w_shape}, got {tuple(t_shape)}")
        if ptr % 16:
            raise ValueError(f"{name} must have a 16-byte aligned base, got "
                             f"address {ptr:#x}")
        if strides[-1] != 1 or strides[-2] * elem % 16:
            raise ValueError(f"{name} rows must be a multiple of 16 bytes "
                             f"apart, got strides {tuple(strides)}")
        dense = tuple(math.prod(w_shape[i + 1:])
                      for i in range(len(w_shape)))
        if any(n > 1 and st != d for n, st, d in zip(w_shape, strides, dense)):
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{tuple(strides)} for shape {w_shape}")
    return W, H, N, hd


def _attention_qtiled_cuda(q, k, v, bias, scale):
    """K8a: (W, H, N, hd) q, k, v (bf16 or f32) and an f32 bias ->
    (W, H, N, hd) in q's dtype, any N a multiple of 64.  The bf16 kernel is
    K8b's Hopper core, which needs ``_headmajor_layout``: the bias tile
    resident over ``_headmajor_groups`` window groups where it fits, else
    streamed in chunks over groups of four windows; the f32 twin runs the
    first design."""
    from geoguessr_ai_torch.ops import _build

    W, H, N, hd, bias, dt = _headmajor_operands(q, k, v, bias)
    out = torch.empty_like(q)
    groups = 1
    if dt == torch.bfloat16:
        _headmajor_layout(*((t.shape, t.stride(), t.data_ptr(),
                             t.element_size()) for t in (q, k, v, bias)),
                          max_n=None)
        groups = _headmajor_groups(W, H, N)
    err = _build.typed_entry("attention_headmajor", "attention_qtiled", dt)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), W, H, N, hd, groups, float(scale), _stream())
    _raise_on(err, "_attention_qtiled_cuda")
    LAUNCHES["_attention_qtiled_cuda"] += 1
    return out


def _attention_batched_cuda(q, k, v, bias, scale):
    """K8b: as K8a for N below 512, a q-tile's bias rows resident in shared
    memory while a block walks several windows of one head; W must be a
    multiple of BLOCK_W (the JAX dispatch rule) and N below 512.  The bf16
    kernel walks ``_headmajor_groups`` groups of windows and needs
    ``_headmajor_layout``; the f32 twin walks BLOCK_W windows a block."""
    from geoguessr_ai_torch.ops import _build

    W, H, N, hd, bias, dt = _headmajor_operands(q, k, v, bias)
    block_w = min(BLOCK_W, W)
    if W % block_w or N >= 512:
        raise ValueError(f"K8b takes W a multiple of BLOCK_W={BLOCK_W} and "
                         f"N < 512, got W={W}, N={N}")
    out = torch.empty_like(q)
    windows = block_w
    if dt == torch.bfloat16:
        _headmajor_layout(*((t.shape, t.stride(), t.data_ptr(),
                             t.element_size()) for t in (q, k, v, bias)))
        windows = _headmajor_groups(W, H, N)
    err = _build.typed_entry("attention_headmajor", "attention_batched", dt)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), W, H, N, hd, windows, float(scale), _stream())
    _raise_on(err, "_attention_batched_cuda")
    LAUNCHES["_attention_batched_cuda"] += 1
    return out


# ---------------------------------------------------------------------------
# Public ops: autograd Functions that dispatch on the input's device.
# ---------------------------------------------------------------------------


def _attention_bwd(qkv, bias, g, scale, num_heads):
    """The attention cotangent rule (``_qkv_bwd``): K4 when the score
    footprint is small, else K5, or K7 when ``BWD_MERGED`` is False, on a
    CUDA tensor; their plain mirrors on a CPU one.  Returns (d_qkv,
    d_bias f32)."""
    if num_heads * qkv.shape[1] ** 2 * 4 <= BWD_MAX_SCORE_BYTES:
        fns = (_attention_qkv_bwd_cuda, _attention_qkv_bwd_plain)
    elif BWD_MERGED:
        fns = (_attention_bwd_merged_cuda, _attention_bwd_merged_plain)
    else:
        fns = (_attention_bwd_qtiled_cuda, _attention_bwd_qtiled_plain)
    fn = fns[0] if qkv.is_cuda else fns[1]
    return fn(qkv, bias, g.contiguous(), scale, num_heads)


def _attention_headmajor_cuda(q, k, v, bias, scale):
    """``_attention_pallas``'s choice: K8a at N >= 512, else K8b when W is
    a multiple of BLOCK_W, else K8a."""
    if BLOCK_Q != 256:
        raise ValueError(f"BLOCK_Q={BLOCK_Q}: K8a's q-tile is the 64 rows of "
                         "the forward core's wgmma, fixed by its plan, so "
                         "the card takes only the default 256")
    W, _, N, _ = q.shape
    if N < 512 and W % BLOCK_W == 0:
        return _attention_batched_cuda(q, k, v, bias, scale)
    return _attention_qtiled_cuda(q, k, v, bias, scale)


def _grad_inputs(tensors):
    """Detached copies that require grad, for a recompute in a backward."""
    return [t.detach().requires_grad_() for t in tensors]


class _WindowAttentionQKV(torch.autograd.Function):
    """``window_attention_qkv``'s custom VJP: saves (qkv, bias) (``_qkv_fwd``)
    and runs the attention backward, d_bias cast to the bias dtype."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, num_heads):
        ctx.save_for_backward(qkv, bias)
        ctx.args = (scale, num_heads)
        if qkv.is_cuda:
            return _attention_qkv_fused_cuda(qkv, bias, scale, num_heads)
        return _attention_qkv_fused_plain(qkv, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = _attention_bwd(qkv, bias, g, *ctx.args)
        return dqkv, dbias.to(bias.dtype), None, None


class _WindowAttentionQKVXla(_WindowAttentionQKV):
    """``window_attention_qkv_xla``'s custom VJP: the plain forward on every
    device, the attention backward of ``window_attention_qkv`` (K4, or
    K5/K7, on the card)."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, num_heads):
        ctx.save_for_backward(qkv, bias)
        ctx.args = (scale, num_heads)
        return _attention_qkv_fused_plain(qkv, bias, scale, num_heads)


class _WindowAttention(torch.autograd.Function):
    """``window_attention``'s custom VJP: K8a/K8b forward on the card; the
    backward differentiates ``_attention_plain`` recomputed from the saved
    inputs (``_bwd``: the JAX package has no backward kernel here)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if q.is_cuda:
            return _attention_headmajor_cuda(q, k, v, bias, scale)
        return _attention_plain(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = _grad_inputs(ctx.saved_tensors)
        with torch.enable_grad():
            out = _attention_plain(*inputs, ctx.scale)
        return (*torch.autograd.grad(out, inputs, g), None)


class _FusedBlockAttention(torch.autograd.Function):
    """``fused_block_attention``'s custom VJP (``_fb_fwd`` /
    ``_fb_bwd_vjp``): the backward recomputes LayerNorm and the qkv GEMM,
    and the attention output through ``window_attention_qkv`` (K3's
    forward on the card, since the proj weight's gradient needs it), then
    differentiates the proj, LayerNorm and qkv GEMMs with autograd and the
    attention with its own backward (K4 on the card)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
                scale, num_heads, eps):
        args = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias)
        ctx.save_for_backward(*args)
        ctx.args = (scale, num_heads, eps)
        fn = _fused_block_cuda if x.is_cuda else _fused_block_plain
        return fn(*args, scale, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        scale, num_heads, eps = ctx.args
        inputs = _grad_inputs(ctx.saved_tensors)
        with torch.enable_grad():
            out = _fused_block_plain(*inputs, scale, num_heads, eps,
                                     _WindowAttentionQKV.apply)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


class _FusedBlockAttention4D(torch.autograd.Function):
    """``fused_block_attention_4d``'s custom VJP (``_fb4d_fwd`` /
    ``_fb4d_bwd``): the forward is K9 on the card; the backward recomputes
    through the partition path with ``window_attention_qkv`` as the
    attention (K3 and K4 on the card) and differentiates the rest, the
    partition copies included, with autograd."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
                scale, num_heads, window, eps):
        args = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias)
        ctx.save_for_backward(*args)
        ctx.args = (scale, num_heads, window, eps)
        fn = _fb4d_cuda if x.is_cuda else _fb4d_plain
        return fn(*args, scale, num_heads, window, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = _grad_inputs(ctx.saved_tensors)
        with torch.enable_grad():
            out = _fb4d_plain(*inputs, *ctx.args, _WindowAttentionQKV.apply)
        return (*torch.autograd.grad(out, inputs, g), None, None, None, None)


class _FusedBlockAttentionNoproj(torch.autograd.Function):
    """``fused_block_attention_noproj``'s custom VJP in the hand-rolled form
    of ``_fb_s2_bwd``: recompute only LayerNorm and the qkv GEMM, apply
    the attention cotangent rule (K5 on the card at stage 2) and
    differentiate the prefix with autograd; the attention output itself
    is never recomputed."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                num_heads, eps):
        args = (x, ln_scale, ln_bias, w_qkv, b_qkv, bias)
        ctx.save_for_backward(*args)
        ctx.args = (scale, num_heads, eps)
        fn = _fb_s2_cuda if x.is_cuda else _fb_s2_plain
        return fn(*args, scale, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        scale, num_heads, eps = ctx.args
        *saved, bias = ctx.saved_tensors
        inputs = _grad_inputs(saved)
        with torch.enable_grad():
            qkv = _ln_qkv_plain(*inputs, eps)
        dqkv, dbias = _attention_bwd(qkv.detach(), bias, g, scale, num_heads)
        grads = torch.autograd.grad(qkv, inputs, dqkv)
        return (*grads, dbias.to(bias.dtype), None, None, None)


def window_attention_qkv(qkv, bias, scale: float, num_heads: int):
    """Window attention over a fused (W, N, 3D) qkv tensor -> (W, N, D)."""
    return _WindowAttentionQKV.apply(qkv, bias, scale, num_heads)


def window_attention_qkv_xla(qkv, bias, scale: float, num_heads: int):
    """``window_attention_qkv`` with the plain forward on every device and
    the kernel backward: (W, N, 3D) -> (W, N, D)."""
    return _WindowAttentionQKVXla.apply(qkv, bias, scale, num_heads)


def window_attention(q, k, v, bias, scale: float):
    """softmax(q k^T * scale + bias) v over independent windows: q, k, v
    (W, H, N, hd), bias (H, N, N) -> (W, H, N, hd) in q's dtype."""
    return _WindowAttention.apply(q, k, v, bias, scale)


def fused_block_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                          bias, scale: float, num_heads: int,
                          eps: float = 1e-5):
    """proj(attention(qkv(LN(x)))) + b_proj for independent windows; the
    residual add stays with the caller.  x (W, N, C) -> (W, N, C)."""
    return _FusedBlockAttention.apply(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                      w_proj, b_proj, bias, scale, num_heads,
                                      eps)


def fused_block_attention_4d(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             b_proj, bias, scale: float, num_heads: int,
                             window: int, eps: float = 1e-5):
    """``fused_block_attention`` over the raw (B, H, W, C) map cut into
    window x window windows, H and W multiples of the window; the residual
    add stays with the caller.  -> (B, H, W, C)."""
    return _FusedBlockAttention4D.apply(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                        w_proj, b_proj, bias, scale,
                                        num_heads, window, eps)


def fused_block_attention_noproj(x, ln_scale, ln_bias, w_qkv, b_qkv, bias,
                                 scale: float, num_heads: int,
                                 eps: float = 1e-5):
    """attention(qkv(LN(x))) for independent windows, before the
    out-projection.  x (W, N, C) -> (W, N, D)."""
    return _FusedBlockAttentionNoproj.apply(x, ln_scale, ln_bias, w_qkv,
                                            b_qkv, bias, scale, num_heads,
                                            eps)
