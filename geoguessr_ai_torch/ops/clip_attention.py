"""CLIP self-attention over a fused token-major qkv tensor: the two ops of
the CLIP tower and their backward.

Counterpart of geoguessr_ai_tpu/ops/clip_attention.py.  Each op is a
``torch.autograd.Function`` that mirrors the JAX package's ``custom_vjp``:
the forward dispatches on the device of its input (a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the hand-written kernel in
``csrc/`` or raises) and the backward recomputes through the plain version
with autograd, as the JAX ``_bwd`` / ``_proj_bwd`` recompute through
``_flash_xla`` (there is no backward kernel).  Layouts are the JAX
package's:

* qkv is (B, N, 3D) in q|k|v blocks of D channels: q = [0, D),
  k = [D, 2D), v = [2D, 3D), head h at columns [h*hd, (h+1)*hd) of each;
* w_proj is the (D, D) out-projection in (in, out) layout, its rows in the
  same h*hd + d order.

Kernels (hd=64 only, the head dim of ViT-L/14 and ViT-B/32):

* K6 ``_flash_cuda``: softmax(q k^T * scale) v -> (B, N, D);
* K11 ``_flash_proj_cuda``: the same, then o @ w_proj inside the kernel.

``head_block`` is the Pallas kernels' heads per grid cell; the result does
not depend on it and the CUDA kernels take no such parameter.  Every
wrapper adds one to its entry in ``LAUNCHES`` each time it launches its
kernel.
"""

from __future__ import annotations

import torch

#: Launches of each kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {
    "_flash_cuda": 0,
    "_flash_proj_cuda": 0,
}

#: The JAX package's default heads per Pallas grid cell.
HEAD_BLOCK = 2

#: The only head dim the kernels are built for.
KERNEL_HEAD_DIM = 64

#: Query rows per K11 block; its shared memory holds their (rows, D)
#: attention output in bf16 beside two (64, 64) k/v tiles per head pair.
_PROJ_ROWS = 64
_SMEM_LIMIT = 232448


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: the oracle of each kernel, and the CPU path.
# ---------------------------------------------------------------------------


def _flash_plain(qkv, scale, num_heads):
    """Mirror of ``_flash_xla``: f32 scores of the qkv-dtype q and k, f32
    softmax, probabilities rounded to the qkv dtype, p.v summed in f32 and
    rounded once."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    hd = D // num_heads
    q, k, v = (t.reshape(B, N, num_heads, hd) for t in qkv.split(D, dim=-1))
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1).to(v.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return o.to(qkv.dtype).reshape(B, N, D)


def _flash_proj_plain(qkv, w_proj, scale, num_heads):
    """Mirror of ``_flash_proj_xla``: the attention output rounded to the
    qkv dtype, then o @ w_proj summed in f32 and rounded once."""
    o = _flash_plain(qkv, scale, num_heads)
    w = w_proj.to(o.dtype)
    return (o.float() @ w.float()).to(o.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_qkv(qkv, num_heads):
    """Returns (B, N, D) after checking what the kernels take."""
    if not qkv.is_cuda:
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"qkv must be torch.bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(qkv.shape)}")
    B, N, D3 = qkv.shape
    D = D3 // 3
    if D != num_heads * KERNEL_HEAD_DIM:
        raise ValueError(
            f"the kernels take head dim {KERNEL_HEAD_DIM}, got D={D}, "
            f"H={num_heads}")
    if not 1 <= B <= 65535 or N < 1:
        raise ValueError(f"the kernels take 1 <= B <= 65535 and N >= 1, got "
                         f"B={B}, N={N}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    return B, N, D


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _flash_cuda(qkv, scale, num_heads):
    """K6: (B, N, D) in the qkv dtype."""
    from geoguessr_ai_torch.ops import _build

    B, N, D = _check_qkv(qkv, num_heads)
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    fn = _build.entry("clip_flash")
    err = fn(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, float(scale),
             _stream())
    _raise_on(err, "_flash_cuda")
    LAUNCHES["_flash_cuda"] += 1
    return out


def _flash_proj_smem_bytes(D):
    """Dynamic shared memory of one K11 block: two (64, 64+8) k tiles and
    two (64, 64+8) v^T tiles, and the (64, D+8) bf16 attention output."""
    return 4 * 64 * 72 * 2 + _PROJ_ROWS * (D + 8) * 2


def _flash_proj_cuda(qkv, w_proj, scale, num_heads):
    """K11: (B, N, D) in the qkv dtype."""
    from geoguessr_ai_torch.ops import _build

    B, N, D = _check_qkv(qkv, num_heads)
    if D % 128 or _flash_proj_smem_bytes(D) > _SMEM_LIMIT:
        raise ValueError(
            f"the out-projection kernel takes D a multiple of 128 whose "
            f"attention rows fit in shared memory, got D={D}")
    if tuple(w_proj.shape) != (D, D):
        raise ValueError(f"w_proj must be ({D}, {D}), got "
                         f"{tuple(w_proj.shape)}")
    # (in, out) -> the (out, in) rows the kernel reads; no copy when w_proj
    # is the transpose view of a contiguous bf16 (out, in) weight
    wt = w_proj.t().to(torch.bfloat16).contiguous()
    if not wt.is_cuda or wt.data_ptr() % 16:
        raise ValueError("w_proj must be a 16-byte aligned CUDA tensor")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    fn = _build.entry("clip_flash_proj")
    err = fn(qkv.data_ptr(), wt.data_ptr(), out.data_ptr(), B, N, num_heads,
             float(scale), _stream())
    _raise_on(err, "_flash_proj_cuda")
    LAUNCHES["_flash_proj_cuda"] += 1
    return out


# ---------------------------------------------------------------------------
# Public ops: autograd Functions that dispatch on the input's device.
# ---------------------------------------------------------------------------


class _ClipAttention(torch.autograd.Function):
    """``clip_attention``'s custom VJP: K6 (or the plain version) forward,
    the backward through autograd of the plain version (``_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, scale, num_heads, head_block):
        ctx.save_for_backward(qkv)
        ctx.args = (scale, num_heads)
        if qkv.is_cuda:
            return _flash_cuda(qkv, scale, num_heads)
        return _flash_plain(qkv, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        qkv = qkv.detach().requires_grad_()
        with torch.enable_grad():
            o = _flash_plain(qkv, *ctx.args)
        return torch.autograd.grad(o, qkv, g)[0], None, None, None


class _ClipAttentionProj(torch.autograd.Function):
    """``clip_attention_proj``'s custom VJP: K11 (or the plain version)
    forward, the backward through autograd of the plain version
    (``_proj_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, w_proj, scale, num_heads, head_block):
        ctx.save_for_backward(qkv, w_proj)
        ctx.args = (scale, num_heads)
        if qkv.is_cuda:
            return _flash_proj_cuda(qkv, w_proj, scale, num_heads)
        return _flash_proj_plain(qkv, w_proj, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _flash_proj_plain(*inputs, *ctx.args)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


def clip_attention(qkv, scale: float, num_heads: int,
                   head_block: int = HEAD_BLOCK):
    """softmax(q k^T * scale) v over a fused (B, N, 3D) qkv tensor in
    q|k|v block layout -> (B, N, D) in qkv's dtype."""
    return _ClipAttention.apply(qkv, scale, num_heads, head_block)


def clip_attention_proj(qkv, w_proj, scale: float, num_heads: int,
                        head_block: int = HEAD_BLOCK):
    """clip_attention(qkv) @ w_proj with the out-projection inside the
    kernel; w_proj is (D, D) in (in, out) layout.  The bias and residual
    stay with the caller."""
    return _ClipAttentionProj.apply(qkv, w_proj, scale, num_heads, head_block)
