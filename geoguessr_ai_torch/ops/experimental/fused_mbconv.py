"""The experimental fused MBConv with plain biases (K12a, K12b).

Counterpart of geoguessr_ai_tpu/ops/experimental/fused_mbconv.py, which is
not wired into the JAX model either.  Per output pixel:

    1x1 expand (C -> E) + b1, tanh GELU, rounded to x's dtype
    depthwise 3x3 over that hidden tensor, zero outside the image, in f32
        with the f32 taps wdw, + b2, GELU, rounded
    1x1 project (E -> C) + b3, the residual added in f32, GELU, rounded.

``fused_mbconv`` (K12a) and ``fused_mbconv_v2`` (K12b, the next tile's
halo copied while the current one computes) compute the same function and
give the same bits.  Each dispatches on the device of its input: a CPU
tensor takes the plain version (``_fused_mbconv_plain``, the mirror of the
Pallas kernel body), a CUDA tensor launches the hand-written kernel in
``csrc/fused_mbconv_exp.cu`` or raises.  ``xla_mbconv`` is the JAX
module's unfused reference (bf16 taps, a rounded depthwise output), in
plain PyTorch.  Layouts are the JAX module's: x (B, H, W, C), w1 (C, E),
wdw (3, 3, E), w3 (E, C); H must be a multiple of 16, the Pallas kernel's
row strip.  The kernels take bf16 x and weights, f32 taps and biases, and
C = 96.

    python -m geoguessr_ai_torch.ops.experimental.fused_mbconv

times the unfused chain, K12a and K12b at B=256, (128, 128, 96), E=384 on
the GPU and prints their differences, as the JAX module's ``__main__``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geoguessr_ai_torch.ops.window_attention import _check, _raise_on, _stream

#: Launches of each kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {"_fused_mbconv_cuda": 0, "_fused_mbconv_v2_cuda": 0}

#: Rows of the Pallas kernel's strip: H must be a multiple of it.
TH = 16
#: The kernels' channel count and expanded-channel chunk.
KERNEL_CHANNELS = 96
E_CHUNK = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _check_rows(x):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] % TH:
        raise ValueError(f"H must be a multiple of {TH} (the Pallas kernel's "
                         f"row strip), got H={x.shape[1]}")


def _fused_mbconv_plain(x, w1, b1, wdw, b2, w3, b3):
    """Mirror of the Pallas kernel body: the expand GEMM sums in f32, b1
    and GELU in f32, rounded to x's dtype; zero padding of the expanded
    tensor; the depthwise MACs in f32 with the f32 taps in (dy, dx) order,
    b2 and GELU in f32, rounded; the project GEMM in f32 + b3, the residual
    added in f32, GELU, rounded once."""
    dt = x.dtype
    B, H, W, C = x.shape
    E = w1.shape[1]
    h = _gelu(x.float() @ w1.to(dt).float() + b1.float()).to(dt)
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    del h
    taps = wdw.float()
    acc = torch.zeros((B, H, W, E), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + hp[:, dy:dy + H, dx:dx + W, :].float() * taps[dy, dx]
    del hp
    h2 = _gelu(acc + b2.float()).to(dt)
    del acc
    out = h2.float() @ w3.to(dt).float() + b3.float()
    return _gelu(out + x.float()).to(dt)


def xla_mbconv(x, w1, b1, wdw, b2, w3, b3):
    """The JAX module's unfused reference: as the kernels, but the
    depthwise conv takes taps rounded to x's dtype and its output is
    rounded to x's dtype before b2 (a grouped conv, cuDNN on the card)."""
    dt = x.dtype
    E = w1.shape[1]
    h = _gelu(x.float() @ w1.to(dt).float() + b1.float()).to(dt)
    taps = wdw.to(dt).permute(2, 0, 1).reshape(E, 1, 3, 3)
    dw = F.conv2d(h.permute(0, 3, 1, 2), taps, None, 1, 1, 1, E)
    del h
    h2 = _gelu(dw.permute(0, 2, 3, 1).float() + b2.float()).to(dt)
    del dw
    out = h2.float() @ w3.to(dt).float() + b3.float()
    return _gelu(out + x.float()).to(dt)


def _fused_mbconv_cuda(x, w1, b1, wdw, b2, w3, b3, v2=False):
    """K12a, or K12b with ``v2``."""
    from geoguessr_ai_torch.ops import _build

    B, H, W, C = x.shape
    E = w1.shape[1]
    if C != KERNEL_CHANNELS or E % E_CHUNK or not 1 <= B <= 65535:
        raise ValueError(
            f"the kernels take C={KERNEL_CHANNELS}, E a multiple of "
            f"{E_CHUNK} and 1 <= B <= 65535, got B={B}, C={C}, E={E}")
    _check("x", x, (B, H, W, C))
    bf, f32 = torch.bfloat16, torch.float32
    w1t = _check("w1", w1.t().to(bf).contiguous(), (E, C))
    w3t = _check("w3", w3.t().to(bf).contiguous(), (C, E))
    taps = _check("wdw", wdw.reshape(9, E).to(f32).contiguous(), (9, E), f32)

    def pair(b, n, name):
        # a row of ones (the kernel's scale) and the bias
        return _check(name, torch.stack([torch.ones_like(b, dtype=f32),
                                         b.float()]).contiguous(), (2, n), f32)

    sb1, sb2, sb3 = pair(b1, E, "b1"), pair(b2, E, "b2"), pair(b3, C, "b3")
    out = torch.empty_like(x)
    name = "_fused_mbconv_v2_cuda" if v2 else "_fused_mbconv_cuda"
    fn = _build.entry("fused_mbconv_exp",
                      "fused_mbconv_v2_bf16" if v2 else "fused_mbconv_bf16")
    err = fn(x.data_ptr(), w1t.data_ptr(), sb1.data_ptr(), taps.data_ptr(),
             sb2.data_ptr(), w3t.data_ptr(), sb3.data_ptr(), out.data_ptr(),
             B, H, W, E, _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def fused_mbconv(x, w1, b1, wdw, b2, w3, b3):
    """K12a: the fused MBConv -> (B, H, W, C) in x's dtype."""
    _check_rows(x)
    if x.is_cuda:
        return _fused_mbconv_cuda(x, w1, b1, wdw, b2, w3, b3)
    return _fused_mbconv_plain(x, w1, b1, wdw, b2, w3, b3)


def fused_mbconv_v2(x, w1, b1, wdw, b2, w3, b3):
    """K12b: the same function with the halo copy double-buffered."""
    _check_rows(x)
    if x.is_cuda:
        return _fused_mbconv_cuda(x, w1, b1, wdw, b2, w3, b3, v2=True)
    return _fused_mbconv_plain(x, w1, b1, wdw, b2, w3, b3)


def _bench(reps: int = 10):
    import json
    import subprocess

    import numpy as np

    if not torch.cuda.is_available():
        raise SystemExit("this benchmark needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    B, H, W, C, E = 256, 128, 128, 96, 384
    dev = torch.device("cuda")

    def arr(shape, scale, dtype):
        return torch.from_numpy(rng.normal(size=shape) * scale).to(dev, dtype)

    x = arr((B, H, W, C), 0.5, torch.bfloat16)
    w1 = arr((C, E), 0.1, torch.bfloat16)
    b1 = arr((E,), 0.1, torch.float32)
    wdw = arr((3, 3, E), 0.1, torch.float32)
    b2 = arr((E,), 0.1, torch.float32)
    w3 = arr((E, C), 0.1, torch.bfloat16)
    b3 = arr((C,), 0.1, torch.float32)
    args = (x, w1, b1, wdw, b2, w3, b3)

    def bench(name, f, n=reps):
        r = f(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            r = f(*args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
        print(json.dumps({"case": name, "ms": ms}), flush=True)
        return r

    with torch.inference_mode():
        rx = bench("xla mbconv (plain torch, cuDNN depthwise)", xla_mbconv)
        rp = bench("K12a fused_mbconv", fused_mbconv)
        d = (rp.float() - rx.float()).abs()
        print(json.dumps({"v1 max diff": float(d.max()),
                          "mean": float(d.mean())}), flush=True)
        rp2 = bench("K12b fused_mbconv_v2", fused_mbconv_v2)
        d2 = (rp2.float() - rx.float()).abs()
        print(json.dumps({"v2 max diff": float(d2.max()),
                          "mean": float(d2.mean()),
                          "v2 bitwise equal to v1": bool(torch.equal(rp2,
                                                                     rp))}),
              flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    _bench()
