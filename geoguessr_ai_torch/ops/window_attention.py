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
* bias is the (H, N, N) additive attention bias.

Kernels:

* K1 ``_fused_block_cuda``, K2 ``_fb_s2_cuda`` and K3
  ``_attention_qkv_fused_cuda``: the forwards;
* K9 ``_fb4d_cuda``: K1 over the raw map, the window partition done by
  index arithmetic in the attention launch;
* K4 ``_attention_qkv_bwd_cuda`` and K5 ``_attention_bwd_merged_cuda``:
  the attention backward, K4 when the all-heads f32 score footprint
  H * N^2 * 4 is at most 6 MB (stages 1 and 3), else K5 (stage 2).

The kernels take bf16 activations and weights; the bias travels bf16 into
K1-K4 and K9, as it does into the Pallas kernels, and f32 into K5.  Every
wrapper adds one to its entry in ``LAUNCHES`` each time it launches its
kernel.
"""

from __future__ import annotations

import torch

#: Launches of each kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {
    "_fused_block_cuda": 0,
    "_fb_s2_cuda": 0,
    "_attention_qkv_fused_cuda": 0,
    "_attention_qkv_bwd_cuda": 0,
    "_attention_bwd_merged_cuda": 0,
    "_fb4d_cuda": 0,
}

#: The only head dim the kernels are built for (every TinyViT stage).
KERNEL_HEAD_DIM = 32

#: Largest all-heads f32 score footprint H * N^2 * 4 that takes the
#: small-N backward (K4); above it the large-N one (K5).  The JAX
#: package's _BWD_MAX_SCORE_BYTES.
BWD_MAX_SCORE_BYTES = 6 * 1024 * 1024


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


def _check_geometry(W, N, C, D, H):
    hd = D // H
    if hd * H != D or hd != KERNEL_HEAD_DIM:
        raise ValueError(
            f"the kernels take head dim {KERNEL_HEAD_DIM}, got D={D}, H={H}"
        )
    if N % 64 or C % 64 or W < 1 or W > 65535:
        raise ValueError(
            f"the kernels take N and C multiples of 64 and 1 <= W <= 65535, "
            f"got W={W}, N={N}, C={C}"
        )


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _bias_bf16(bias, H, N):
    return _check("bias", bias.to(torch.bfloat16).contiguous(), (H, N, N))


def _weight_t(w, rows, cols):
    """(in, out) JAX-layout weight -> the (out, in) bf16 rows the kernel
    reads.  No copy when w is the transpose view of a contiguous bf16
    (out, in) weight, as the model passes it."""
    return _check("weight", w.t().to(torch.bfloat16).contiguous(), (rows, cols))


def _vec_f32(v, n, name):
    return _check(name, v.float().contiguous(), (n,), torch.float32)


def _attention_qkv_fused_cuda(qkv, bias, scale, num_heads):
    from geoguessr_ai_torch.ops import _build

    W, N, D3 = qkv.shape
    D = D3 // 3
    _check_geometry(W, N, 64, D, num_heads)
    _check("qkv", qkv, (W, N, D3))
    bias = _bias_bf16(bias, num_heads, N)
    out = torch.empty((W, N, D), dtype=qkv.dtype, device=qkv.device)
    fn = _build.entry("attention_qkv")
    err = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), W, N,
             num_heads, float(scale), _stream())
    _raise_on(err, "_attention_qkv_fused_cuda")
    LAUNCHES["_attention_qkv_fused_cuda"] += 1
    return out


def _fb_s2_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                num_heads, eps):
    from geoguessr_ai_torch.ops import _build

    W, N, C = x.shape
    D = w_qkv.shape[1] // 3
    _check_geometry(W, N, C, D, num_heads)
    _check("x", x, (W, N, C))
    ls = _vec_f32(ln_scale, C, "ln_scale")
    lb = _vec_f32(ln_bias, C, "ln_bias")
    wq = _weight_t(w_qkv, 3 * D, C)
    # the qkv GEMM adds a bf16 bias, as the TPU kernel does
    bq = _vec_f32(b_qkv.to(torch.bfloat16), 3 * D, "b_qkv")
    bias = _bias_bf16(bias, num_heads, N)
    qkv = torch.empty((W, N, 3 * D), dtype=x.dtype, device=x.device)
    out = torch.empty((W, N, D), dtype=x.dtype, device=x.device)
    fn = _build.entry("fb_s2")
    err = fn(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wq.data_ptr(),
             bq.data_ptr(), bias.data_ptr(), qkv.data_ptr(), out.data_ptr(),
             W, N, C, num_heads, float(scale), float(eps), _stream())
    _raise_on(err, "_fb_s2_cuda")
    LAUNCHES["_fb_s2_cuda"] += 1
    return out


def _fused_block_launch(lib, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                        b_proj, bias, num_heads, N, tail):
    """K1 and K9's shared launch: converts the operands to what the
    kernels read, allocates qkv and the attention output as scratch in
    x's row order, and calls ``lib``'s entry with ``tail`` (the geometry,
    scale, eps) before the stream.  Returns (the entry's error code, the
    output shaped like x)."""
    from geoguessr_ai_torch.ops import _build

    C = x.shape[-1]
    D = w_proj.shape[0]
    rows = x.shape[:-1]
    ls = _vec_f32(ln_scale, C, "ln_scale")
    lb = _vec_f32(ln_bias, C, "ln_bias")
    wq = _weight_t(w_qkv, 3 * D, C)
    # the qkv GEMM adds a bf16 bias, as the TPU kernel does
    bq = _vec_f32(b_qkv.to(torch.bfloat16), 3 * D, "b_qkv")
    wp = _weight_t(w_proj, C, D)
    bp = _vec_f32(b_proj, C, "b_proj")
    bias = _bias_bf16(bias, num_heads, N)
    qkv = torch.empty((*rows, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty((*rows, D), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    err = _build.entry(lib)(
        x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wq.data_ptr(),
        bq.data_ptr(), wp.data_ptr(), bp.data_ptr(), bias.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), *tail, _stream())
    return err, out


def _fused_block_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                      bias, scale, num_heads, eps):
    W, N, C = x.shape
    _check_geometry(W, N, C, w_proj.shape[0], num_heads)
    _check("x", x, (W, N, C))
    err, out = _fused_block_launch(
        "fused_block", x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
        bias, num_heads, N,
        (W, N, C, num_heads, float(scale), float(eps)))
    _raise_on(err, "_fused_block_cuda")
    LAUNCHES["_fused_block_cuda"] += 1
    return out


def _fb4d_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
               scale, num_heads, window, eps):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, Hm, Wm, C = x.shape
    N = window * window
    if Hm % window or Wm % window:
        raise ValueError(f"the map {Hm}x{Wm} is not a whole number of "
                         f"{window}x{window} windows")
    _check_geometry(B * (Hm // window) * (Wm // window), N, C,
                    w_proj.shape[0], num_heads)
    _check("x", x, (B, Hm, Wm, C))
    # qkv and the attention output stay in map order, like x and out
    err, out = _fused_block_launch(
        "fb4d", x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias,
        num_heads, N,
        (B, Hm, Wm, C, num_heads, window, float(scale), float(eps)))
    _raise_on(err, "_fb4d_cuda")
    LAUNCHES["_fb4d_cuda"] += 1
    return out


def _attention_bwd_cuda(name, lib, qkv, bias, g, scale, num_heads,
                        bias_dtype):
    from geoguessr_ai_torch.ops import _build

    W, N, D3 = qkv.shape
    D = D3 // 3
    _check_geometry(W, N, 64, D, num_heads)
    _check("qkv", qkv, (W, N, D3))
    _check("g", g, (W, N, D))
    bias = _check("bias", bias.to(bias_dtype).contiguous(), (num_heads, N, N),
                  bias_dtype)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((num_heads, N, N), dtype=torch.float32,
                        device=qkv.device)
    # row max, 1 / row sum and t per (window, head, query)
    stats = torch.empty((3, W, num_heads, N), dtype=torch.float32,
                        device=qkv.device)
    fn = _build.entry(lib)
    err = fn(qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
             dbias.data_ptr(), stats.data_ptr(), W, N, num_heads,
             float(scale), _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return dqkv, dbias


def _attention_qkv_bwd_cuda(qkv, bias, g, scale, num_heads):
    """K4: (d_qkv bf16, d_bias f32) with the bias rounded to bf16."""
    return _attention_bwd_cuda("_attention_qkv_bwd_cuda", "attention_qkv_bwd",
                               qkv, bias, g, scale, num_heads, torch.bfloat16)


def _attention_bwd_merged_cuda(qkv, bias, g, scale, num_heads):
    """K5: (d_qkv bf16, d_bias f32) with the bias in f32."""
    return _attention_bwd_cuda("_attention_bwd_merged_cuda",
                               "attention_bwd_merged", qkv, bias, g, scale,
                               num_heads, torch.float32)


# ---------------------------------------------------------------------------
# Public ops: autograd Functions that dispatch on the input's device.
# ---------------------------------------------------------------------------


def _attention_bwd(qkv, bias, g, scale, num_heads):
    """The attention cotangent rule (``_qkv_bwd``): K4 or K5 by the score
    footprint on a CUDA tensor, their plain mirrors on a CPU one.
    Returns (d_qkv, d_bias f32)."""
    small = num_heads * qkv.shape[1] ** 2 * 4 <= BWD_MAX_SCORE_BYTES
    if qkv.is_cuda:
        fn = _attention_qkv_bwd_cuda if small else _attention_bwd_merged_cuda
    else:
        fn = _attention_qkv_bwd_plain if small else _attention_bwd_merged_plain
    return fn(qkv, bias, g.contiguous(), scale, num_heads)


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
