"""TinyViT window attention: the three ops the guess path runs.

Each op has a plain PyTorch version and a wrapper around a hand-written
CUDA kernel (``csrc/``), and dispatches on the device of its input: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises.  Signatures and layouts are those of the JAX package
(geoguessr_ai_tpu/ops/window_attention.py):

* x is (W, N, C) window tokens;
* w_qkv is (C, 3D) and its output channels are interleaved per head:
  head h owns [h*3hd, (h+1)*3hd), with q|k|v slots of hd inside;
* bias is the (H, N, N) additive attention bias.

The kernels take bf16 activations and weights; the bias travels bf16, as
it does into the Pallas kernels.  Every wrapper adds one to its entry in
``LAUNCHES`` each time it launches its kernel.
"""

from __future__ import annotations

import torch

#: Launches of each kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {
    "_fused_block_cuda": 0,
    "_fb_s2_cuda": 0,
    "_attention_qkv_fused_cuda": 0,
}

#: The only head dim the kernels are built for (every TinyViT stage).
KERNEL_HEAD_DIM = 32


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
                       bias, scale, num_heads, eps):
    """Mirror of ``_fused_block_xla``."""
    qkv = _ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    o = _attention_qkv_fused_plain(qkv, bias, scale, num_heads)
    return o @ w_proj.to(x.dtype) + b_proj.to(x.dtype)


def _fb_s2_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                 num_heads, eps):
    """Mirror of ``_fb_s2_xla``."""
    qkv = _ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return _attention_qkv_fused_plain(qkv, bias, scale, num_heads)


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


def _fused_block_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                      bias, scale, num_heads, eps):
    from geoguessr_ai_torch.ops import _build

    W, N, C = x.shape
    D = w_proj.shape[0]
    _check_geometry(W, N, C, D, num_heads)
    _check("x", x, (W, N, C))
    ls = _vec_f32(ln_scale, C, "ln_scale")
    lb = _vec_f32(ln_bias, C, "ln_bias")
    wq = _weight_t(w_qkv, 3 * D, C)
    bq = _vec_f32(b_qkv.to(torch.bfloat16), 3 * D, "b_qkv")
    wp = _weight_t(w_proj, C, D)
    bp = _vec_f32(b_proj, C, "b_proj")
    bias = _bias_bf16(bias, num_heads, N)
    qkv = torch.empty((W, N, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty((W, N, D), dtype=x.dtype, device=x.device)
    out = torch.empty((W, N, C), dtype=x.dtype, device=x.device)
    fn = _build.entry("fused_block")
    err = fn(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), wq.data_ptr(),
             bq.data_ptr(), wp.data_ptr(), bp.data_ptr(), bias.data_ptr(),
             qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
             W, N, C, num_heads, float(scale), float(eps), _stream())
    _raise_on(err, "_fused_block_cuda")
    LAUNCHES["_fused_block_cuda"] += 1
    return out


# ---------------------------------------------------------------------------
# Public ops: dispatch on the input's device.
# ---------------------------------------------------------------------------


def window_attention_qkv(qkv, bias, scale: float, num_heads: int):
    """Window attention over a fused (W, N, 3D) qkv tensor -> (W, N, D)."""
    if qkv.is_cuda:
        return _attention_qkv_fused_cuda(qkv, bias, scale, num_heads)
    return _attention_qkv_fused_plain(qkv, bias, scale, num_heads)


def fused_block_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                          bias, scale: float, num_heads: int,
                          eps: float = 1e-5):
    """proj(attention(qkv(LN(x)))) + b_proj for independent windows; the
    residual add stays with the caller.  x (W, N, C) -> (W, N, C)."""
    if x.is_cuda:
        return _fused_block_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                 b_proj, bias, scale, num_heads, eps)
    return _fused_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                              b_proj, bias, scale, num_heads, eps)


def fused_block_attention_noproj(x, ln_scale, ln_bias, w_qkv, b_qkv, bias,
                                 scale: float, num_heads: int,
                                 eps: float = 1e-5):
    """attention(qkv(LN(x))) for independent windows, before the
    out-projection.  x (W, N, C) -> (W, N, D)."""
    if x.is_cuda:
        return _fb_s2_cuda(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                           num_heads, eps)
    return _fb_s2_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, bias, scale,
                        num_heads, eps)
