"""int8 GEMMs for embedding inference.

Counterpart of geoguessr_ai_tpu/ops/quant.py, function for function.
Weights are int8 with one symmetric scale per output channel, quantized
from the f32 parameters at each call (as the JAX forward does); activations
are int8 with a dynamic per-row scale (``int8_matmul``) or a static
calibrated one (``int8_static_*``), whose quantize step is elementwise.
The int8 x int8 -> int32 product is ``torch._int_mm``, a library GEMM as
the JAX package leaves its int8 dot to XLA; the quantize and dequantize
passes are plain PyTorch.

Numerics, as the JAX functions have them:

* scale = max(amax, 1e-12) / 127 in f32; q = clip(round(x / scale), -127,
  127) with a division (not a multiplied reciprocal) and round half to
  even;
* the int32 sum becomes f32 and is multiplied by (activation scale x
  weight scale), the bias is added in f32, and the result is rounded to
  ``out_dtype`` once.

``torch._int_mm`` takes M > 16 and K, N multiples of 8 on the card; the
operands are padded with zero rows and columns to that (exact) and the
result cut back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _scale_of(amax):
    return torch.clamp(amax.float(), min=1e-12) / 127.0


def _quantize(x, scale):
    # one f32 copy, divided, rounded and clipped in place: the bits of
    # clip(round(x / scale)), without the temporaries (the B=512 stage-0
    # activations are 13 GB in f32)
    q = x.to(torch.float32, copy=True).div_(scale)
    return q.round_().clamp_(-127, 127).to(torch.int8)


def quantize_symmetric(x, axis=None, eps: float = 1e-12):
    """Symmetric int8 quantization -> (q int8, scale f32).  axis=None: one
    scale for the tensor; axis=k: one scale per index of dim k, the other
    dims reduced away (kept with size 1)."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().max()
    else:
        dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=eps) / 127.0
    return _quantize(xf, scale), scale


def _int_mm(a, b):
    """Exact (M, K) int8 @ (K, N) int8 -> int32."""
    M, K = a.shape
    N = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a, b)
    pm, pk, pn = max(0, 17 - M), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    # column-major b (its transpose contiguous), as cuBLASLt's int8 GEMM
    # takes it
    y = torch._int_mm(a, b.t().contiguous().t())
    return y[:M, :N] if (pm or pn) else y


def _dequant(acc, scale, bias, out_dtype):
    """(acc f32 * scale + bias f32) rounded to out_dtype, in place on one
    f32 copy of acc."""
    y = acc.to(torch.float32)
    del acc
    y.mul_(scale)
    if bias is not None:
        y.add_(bias.float())
    return y.to(out_dtype)


def int8_matmul(x, w, bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16, per_row: bool = True):
    """y = x @ w (+ bias) through int8: x (..., K) any float dtype (a 2-D
    (M, K) here, as the JAX function is called), w (K, N) float weights.
    per_row: one activation scale per row, else one per tensor."""
    xf = x.float()
    if per_row:
        xs = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
        xq = _quantize(xf, xs)
    else:
        xq, xs = quantize_symmetric(xf)
    wq, ws = quantize_symmetric(w.float(), axis=1)
    lead = xq.shape[:-1]
    return _dequant(_int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(
        *lead, wq.shape[1]), xs * ws.reshape(-1), bias, out_dtype)


def int8_static_matmul(x, w, amax, bias: Optional[torch.Tensor] = None,
                       out_dtype=torch.bfloat16):
    """y = x @ w (+ bias) with the static activation scale of the
    calibrated abs-max ``amax`` (an f32 scalar)."""
    scale = _scale_of(amax)
    xq = _quantize(x, scale)
    wq, ws = quantize_symmetric(w.float(), axis=1)
    lead = xq.shape[:-1]
    return _dequant(_int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(
        *lead, wq.shape[1]), scale * ws.reshape(-1), bias, out_dtype)


def int8_static_einsum_nc_cd(x, w, amax, bias: Optional[torch.Tensor] = None,
                             out_dtype=torch.bfloat16):
    """'...c,cd->...d' on the static int8 path."""
    lead = x.shape[:-1]
    y = int8_static_matmul(x.reshape(-1, x.shape[-1]), w, amax, bias=bias,
                           out_dtype=out_dtype)
    return y.reshape(*lead, w.shape[-1])


def _im2col(x, k, stride, padding):
    """(B, H, W, C) -> (B, Ho, Wo, k * k * C), the patch in (kh, kw, c)
    order of an HWIO kernel."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    p = x.unfold(1, k, stride).unfold(2, k, stride)  # (B, Ho, Wo, C, kh, kw)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(*p.shape[:3], -1)


def int8_static_conv(x, w, amax, *, stride: int = 1, padding: int = 0,
                     out_dtype=torch.bfloat16):
    """NHWC conv with int8 operands: x (B, H, W, Cin) float quantized with
    the static scale of ``amax``, w (kh, kw, Cin, Cout) f32 (the flax HWIO
    layout) per output channel.  The int8 product is an im2col GEMM."""
    scale = _scale_of(amax)
    xq = _quantize(x, scale)
    wq, ws = quantize_symmetric(w.float(), axis=3)
    kh, kw, cin, cout = w.shape
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}x{kw}")
    cols = _im2col(xq, kh, stride, padding)
    lead = cols.shape[:3]
    return _dequant(_int_mm(cols.reshape(-1, cols.shape[-1]),
                            wq.reshape(-1, cout)).reshape(*lead, cout),
                    scale * ws.reshape(-1), None, out_dtype)


def fake_quant_static(x, amax):
    """Symmetric int8 quantize -> dequantize with a static scale, in x's
    dtype."""
    scale = _scale_of(amax)
    return _quantize(x, scale).to(torch.float32).mul_(scale).to(x.dtype)


class _FakeQuantSTE(torch.autograd.Function):
    """``fake_quant_static`` with the cotangent passed straight through to
    x (and none to amax), as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, amax):
        return fake_quant_static(x, amax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_static_ste(x, amax):
    """``fake_quant_static`` (the same primal bits) with a straight-through
    gradient."""
    return _FakeQuantSTE.apply(x, amax)


def calibrate_act_stats(apply_calibrate, variables, batches) -> dict:
    """Accumulates per-site activation abs-max over calibration batches.
    ``apply_calibrate(variables, x)`` runs a quant_mode="calibrate"
    forward and returns ``(out, {"act_stats": stats})``; the running stats
    go back in as ``variables["act_stats"]`` for the next batch.  Returns
    the last stats, the static model's ``act_scales``."""
    stats: dict = {}
    for x in batches:
        v = dict(variables)
        if stats:
            v["act_stats"] = stats
        _, mutated = apply_calibrate(v, x)
        stats = mutated["act_stats"]
    return stats


def int8_einsum_nc_cd(x, w, bias: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16):
    """'...c,cd->...d' on the dynamic (per-row) int8 path."""
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]), w, bias=bias,
                    out_dtype=out_dtype)
    return y.reshape(*lead, w.shape[-1])
