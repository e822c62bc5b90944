"""TinyViT's stage-0 MBConv with folded BatchNorm as one op (K10).

Counterpart of geoguessr_ai_tpu/ops/mbconv.py:

    1x1 expand (C -> E) + BN + GELU
    depthwise 3x3 + BN + GELU
    1x1 project (E -> C) + BN
    residual add + GELU

``fused_mbconv`` dispatches on the device of its input: a CPU tensor takes
the plain PyTorch version (``_mbconv_plain``, the mirror of the JAX
package's ``_mbconv_xla``), a CUDA tensor launches the hand-written kernel
``csrc/mbconv.cu`` (the Hopper kernel of ``csrc/mbconv_sm90.cuh``: its bf16
kind, or in f32 its f32 kind) or raises.  Inference only, as in the JAX package: BN
folds into per-channel (scale, bias) from the running statistics
(``fold_bn``), and there is no backward.  Layouts are the JAX package's:
x (B, H, W, C), w1 (C, E), w2 (3, 3, E) depthwise, w3 (E, C).  x is bf16
or f32 (the compute dtype; the kernel has an entry for each) and the
weights are cast to it, as the plain version casts them.  The wrapper
``_mbconv_cuda`` adds one to ``LAUNCHES`` each time it launches the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geoguessr_ai_torch.ops.window_attention import (
    _act_dtype,
    _check,
    _raise_on,
    _stream,
)

#: Launches of the kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {"_mbconv_cuda": 0}

#: Input channel counts the kernel is built for (TinyViT-21M's stage 0 has
#: 96); the expanded width must be a multiple of E_CHUNK.
KERNEL_CHANNELS = (32, 64, 96)
E_CHUNK = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm from running statistics as per-channel (s, b), y = x*s + b,
    computed in f32."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def _gelu(x, exact: bool):
    return F.gelu(x, approximate="none" if exact else "tanh")


def _mbconv_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, exact: bool):
    """Mirror of ``_mbconv_xla``: each GEMM and the depthwise MACs sum in
    f32 over operands in x's dtype (the depthwise taps rounded to it), BN is
    applied in f32 and rounded to x's dtype before each GELU, the residual
    add is in x's dtype."""
    dt = x.dtype
    B, H, W, C = x.shape
    E = w1.shape[1]
    h = x.float() @ w1.to(dt).float()
    h = _gelu((h * s1.float() + b1.float()).to(dt), exact)
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    del h
    w2f = w2.reshape(9, E).to(dt).float()
    acc = torch.zeros((B, H, W, E), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + hp[:, di:di + H, dj:dj + W, :].float() * w2f[di * 3 + dj]
    del hp
    y = _gelu((acc * s2.float() + b2.float()).to(dt), exact)
    del acc
    p = y.float() @ w3.to(dt).float()
    p = (p * s3.float() + b3.float()).to(dt)
    return _gelu(x + p, exact)


def _split_bf16(w):
    """f32 ``w`` as the stacked bf16 pair (hi, lo), hi = bf16(w) and lo =
    bf16(w - hi): the operands of the f32 kind's split products (lo.hi +
    hi.lo + hi.hi), made once a call."""
    hi = w.to(torch.bfloat16)
    return torch.stack([hi, (w - hi.float()).to(torch.bfloat16)])


def _mbconv_cuda(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, exact: bool):
    from geoguessr_ai_torch.ops import _build

    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    E = w1.shape[1]
    if C not in KERNEL_CHANNELS or E % E_CHUNK or not 1 <= B <= 65535:
        raise ValueError(
            f"the kernel takes C in {KERNEL_CHANNELS}, E a multiple of "
            f"{E_CHUNK} and 1 <= B <= 65535, got B={B}, C={C}, E={E}")
    dt = _act_dtype(x=x)
    _check("x", x, (B, H, W, C), dt)
    # the kernel reads the 1x1 weights (out, in); no copy when w1 / w3 are
    # the transposed views of contiguous conv weights of x's dtype, as the
    # model passes them.  The f32 kind reads each as its (hi, lo) bf16 pair.
    w1t = w1.t().to(dt).contiguous()
    w3t = w3.t().to(dt).contiguous()
    if dt == torch.float32:
        w1t = _check("w1", _split_bf16(w1t), (2, E, C), torch.bfloat16)
        w3t = _check("w3", _split_bf16(w3t), (2, C, E), torch.bfloat16)
    else:
        w1t = _check("w1", w1t, (E, C), dt)
        w3t = _check("w3", w3t, (C, E), dt)
    # depthwise taps rounded to x's dtype, then widened for the f32 MACs
    w2r = _check("w2", w2.reshape(9, E).to(dt).float().contiguous(), (9, E),
                 torch.float32)

    def pair(s, b, n, name):
        return _check(name, torch.stack([s.float(), b.float()]).contiguous(),
                      (2, n), torch.float32)

    sb1, sb2, sb3 = pair(s1, b1, E, "s1/b1"), pair(s2, b2, E, "s2/b2"), \
        pair(s3, b3, C, "s3/b3")
    out = torch.empty_like(x)
    fn = _build.typed_entry("mbconv", "mbconv", dt)
    err = fn(x.data_ptr(), w1t.data_ptr(), sb1.data_ptr(), w2r.data_ptr(),
             sb2.data_ptr(), w3t.data_ptr(), sb3.data_ptr(), out.data_ptr(),
             B, H, W, C, E, int(exact), _stream())
    _raise_on(err, "_mbconv_cuda")
    LAUNCHES["_mbconv_cuda"] += 1
    return out


def fused_mbconv(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, *,
                 exact_gelu: bool = False):
    """Inverted-bottleneck block with folded BatchNorm -> (B, H, W, C).

    x: (B, H, W, C); w1: (C, E); w2: (3, 3, E) depthwise; w3: (E, C); each
    (s, b) pair is a folded BN (``fold_bn``).  Inference only: raises when
    autograd would record the call."""
    args = (x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "fused_mbconv has no backward (inference only, as in the JAX "
            "package): call it under torch.no_grad() or "
            "torch.inference_mode(); training takes the unfused MBConv")
    fn = _mbconv_cuda if x.is_cuda else _mbconv_plain
    return fn(*args, exact_gelu)
