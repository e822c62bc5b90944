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

Kernels (a head dim in ``KERNEL_HEAD_DIMS``, ViT-L/14 and ViT-B/32 have
64; qkv in bf16 or f32, the compute dtype, each with its C entry, and
w_proj cast to qkv's dtype as the plain version casts it):

* K6 ``_flash_cuda``: softmax(q k^T * scale) v -> (B, N, D); in bf16 the
  Hopper kernel (TMA loads, wgmma products, warp-specialised), in f32 the
  mma.sync twin;
* K11 ``_flash_proj_cuda``: the same, then o @ w_proj; in bf16 K6's
  Hopper kernel into a scratch and the Hopper GEMM core on it (two
  launches of one C call, counted as one), in f32 the first design (one
  mma.sync kernel that keeps o in shared memory).

qkv must be contiguous with a 16-byte aligned base (``_qkv_layout``): the
bf16 K6 kernel reads it through one TMA tensor map, which needs that base
and a row pitch that is a multiple of 16 bytes.

``head_block`` is the Pallas kernels' heads per grid cell; the result does
not depend on it and the CUDA kernels take no such parameter.  Every
wrapper adds one to its entry in ``LAUNCHES`` each time it launches its
kernel.
"""

from __future__ import annotations

import torch

from geoguessr_ai_torch.ops.window_attention import _act_dtype, _raise_on

#: Launches of each kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {
    "_flash_cuda": 0,
    "_flash_proj_cuda": 0,
}

#: The JAX package's default heads per Pallas grid cell.
HEAD_BLOCK = 2

#: Head dims the kernels are built for: the multiples of the mma k-step of
#: 16 up to 64 (one swizzled row of 32, 64 or 128 bytes in the bf16 K6).
KERNEL_HEAD_DIMS = (16, 32, 64)

#: Query rows per block of K11's f32 twin; its shared memory holds their
#: (rows, Dc) attention output beside two (64, hd) k/v tiles per head pair,
#: Dc the widest head chunk that fits (``_flash_proj_chunk``).
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


def _qkv_layout(shape, strides, data_ptr, elem_size, num_heads):
    """Returns (B, N, D, hd) for a qkv of this shape, element strides,
    address and element size when the kernels can read it, else raises
    ValueError naming the rule it breaks.  The C entries take no strides,
    so qkv is contiguous; the bf16 K6 kernel's tensor map also needs a
    16-byte aligned base and rows a multiple of 16 bytes apart (TMA)."""
    if len(shape) != 3 or shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(shape)}")
    B, N, D3 = shape
    D = D3 // 3
    hd = D // num_heads
    if hd * num_heads != D or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the kernels take a head dim in {KERNEL_HEAD_DIMS}, got D={D}, "
            f"H={num_heads}")
    if not 1 <= B <= 65535 or N < 1:
        raise ValueError(f"the kernels take 1 <= B <= 65535 and N >= 1, got "
                         f"B={B}, N={N}")
    if data_ptr % 16:
        raise ValueError(f"qkv must have a 16-byte aligned base, got address "
                         f"{data_ptr:#x}")
    if strides[-1] != 1 or (N > 1 and strides[1] * elem_size % 16):
        raise ValueError(f"qkv rows must be a multiple of 16 bytes apart, "
                         f"got strides {tuple(strides)} of {elem_size} bytes")
    want = (N * D3, D3, 1)
    if any(n > 1 and st != w for n, st, w in zip(shape, strides, want)):
        raise ValueError(f"qkv must be contiguous, got strides "
                         f"{tuple(strides)} for shape {tuple(shape)}")
    return B, N, D, hd


def _check_qkv(qkv, num_heads):
    """Returns (B, N, D, hd) after checking what the kernels take."""
    _act_dtype(qkv=qkv)
    if not qkv.is_cuda:
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    return _qkv_layout(tuple(qkv.shape), qkv.stride(), qkv.data_ptr(),
                       qkv.element_size(), num_heads)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _flash_cuda(qkv, scale, num_heads):
    """K6: (B, N, D) in the qkv dtype."""
    from geoguessr_ai_torch.ops import _build

    B, N, D, hd = _check_qkv(qkv, num_heads)
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    fn = _build.typed_entry("clip_flash", "clip_flash", qkv.dtype)
    err = fn(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, hd,
             float(scale), _stream())
    _raise_on(err, "_flash_cuda")
    LAUNCHES["_flash_cuda"] += 1
    return out


def _flash_proj_smem_bytes(dc, hd, elem=2):
    """Dynamic shared memory of one block of K11's first design (the f32
    twin): two (64, hd+8) k tiles and two (hd, 64+8) v^T tiles, or the
    (128, 64+8) W tile where that is larger, and the (64, dc+8) attention
    output, in elements of ``elem`` bytes."""
    tiles = max(2 * (64 * (hd + 8) + hd * 72) * elem, 128 * 72 * elem)
    return tiles + _PROJ_ROWS * (dc + 8) * elem


def _flash_proj_chunk(D, hd, dtype):
    """The channels of one K11 head chunk: D in bf16 (the GEMM core streams
    all D input channels of o from device memory); in f32 the widest whole
    number of head pairs that divides D, is a multiple of 64 and fits in
    shared memory, as the first design picks it.  None when none fits."""
    if torch.finfo(dtype).bits == 16:
        return D
    H = D // hd
    for n in range(1, H // 2 + 1):
        dc = D // n
        if (H // 2) % n == 0 and dc % 64 == 0 and \
                _flash_proj_smem_bytes(dc, hd, 4) <= _SMEM_LIMIT:
            return dc
    return None


def _flash_proj_cuda(qkv, w_proj, scale, num_heads):
    """K11: (B, N, D) in the qkv dtype.  In bf16 the C entry writes K6's
    output into a (B, N, D) scratch and multiplies it by w_proj on the
    GEMM core; the f32 twin takes no scratch."""
    from geoguessr_ai_torch.ops import _build

    B, N, D, hd = _check_qkv(qkv, num_heads)
    if D % 128 or _flash_proj_chunk(D, hd, qkv.dtype) is None:
        raise ValueError(
            f"the out-projection kernel takes D a multiple of 128 (in f32 "
            f"one whose attention rows fit in shared memory), got D={D}")
    if tuple(w_proj.shape) != (D, D):
        raise ValueError(f"w_proj must be ({D}, {D}), got "
                         f"{tuple(w_proj.shape)}")
    # (in, out) -> the (out, in) rows the kernel reads, in qkv's dtype; no
    # copy when w_proj is the transpose view of a contiguous (out, in)
    # weight of that dtype
    wt = w_proj.t().to(qkv.dtype).contiguous()
    if not wt.is_cuda or wt.data_ptr() % 16:
        raise ValueError("w_proj must be a 16-byte aligned CUDA tensor")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    attn = (torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
            if qkv.dtype == torch.bfloat16 else None)
    fn = _build.typed_entry("clip_flash_proj", "clip_flash_proj", qkv.dtype)
    err = fn(qkv.data_ptr(), wt.data_ptr(),
             None if attn is None else attn.data_ptr(), out.data_ptr(), B, N,
             num_heads, hd, float(scale), _stream())
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
