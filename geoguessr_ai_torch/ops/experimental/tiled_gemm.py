"""A tiled matrix product in two types (K13): the int8-rate probe.

Counterpart of the Pallas GEMM of tools/exp_int8_pallas.py
(``pallas_matmul``), with which the JAX package asked whether the int8
path of its matrix unit runs at twice the bf16 rate.  Nothing in either
package's models calls it: the static-int8 GEMMs of ``ops/quant.py`` are
library products.  ``python -m geoguessr_ai_torch.tools.exp_int8_gemm``
runs the probe.

``tiled_matmul(a, b, out_dtype)``: (M, K) @ (K, N), bf16 -> f32 or
int8 -> int32 (exact).  A CPU tensor takes the plain version, a CUDA
tensor launches ``csrc/tiled_gemm.cu`` or raises; the kernel takes M and
N multiples of 128 and K a multiple of 64 bytes of a row.  Both types run
the Hopper GEMM core ``csrc/gemm_sm90.cuh`` (a TMA ring of A and B
k-boxes, B shared by the two CTAs of a cluster, wgmma on two consumer
warpgroups, persistent blocks), whose bf16 -> bf16 kind is K11's
out-projection.  The kernel reads b K-major: a b that is the transpose
view of an (N, K) tensor goes over as it is, any other b is copied
transposed at every call (0.12 ms of a (4096, 4096) b on an H100).
"""

from __future__ import annotations

import torch

from geoguessr_ai_torch.ops.window_attention import _check, _raise_on, _stream

#: Launches of the kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {"_tiled_matmul_cuda": 0}
#: The same launches by operand type.
LAUNCHES_BY_TYPE = {"int8": 0, "bf16": 0}

#: Input dtype -> the product's dtype.
OUT_DTYPES = {torch.bfloat16: torch.float32, torch.int8: torch.int32}
TILE = 128


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_TYPE):
        for k in counts:
            counts[k] = 0


def _tiled_matmul_plain(a, b, out_dtype):
    """Mirror of ``matmul_kernel``'s dot: int8 summed exactly (in f64,
    where every partial sum of int8 products is an integer below 2^53),
    bf16 summed in f32."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(out_dtype)
    return a.float() @ b.float()


def _tiled_matmul_cuda(a, b, out_dtype):
    from geoguessr_ai_torch.ops import _build

    M, K = a.shape
    N = b.shape[1]
    if M % TILE or N % TILE or (K * a.element_size()) % 64:
        raise ValueError(f"the kernel takes M and N multiples of {TILE} and "
                         f"K a multiple of 64 bytes, got M={M}, K={K}, N={N}")
    _check("a", a, (M, K), a.dtype)
    # the kernel reads both operands K-contiguous: b transposed
    bt = _check("b", b.t().contiguous(), (N, K), a.dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = _build.entry("tiled_gemm", "tiled_gemm_s8" if a.dtype == torch.int8
                      else "tiled_gemm_bf16")
    err = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), M, N, K, _stream())
    _raise_on(err, "_tiled_matmul_cuda")
    LAUNCHES["_tiled_matmul_cuda"] += 1
    LAUNCHES_BY_TYPE["int8" if a.dtype == torch.int8 else "bf16"] += 1
    return out


def core_plan(M, K, N, dtype):
    """The GEMM core's plan of an (M, K) @ (K, N) call with operands of
    ``dtype``, as its C code makes it: dict of k-boxes, tile columns, ring
    stages, row and column tiles, shared-memory bytes a block and the CTAs
    a launch takes (the card's answer); None where the core has no plan.  Builds the library (on a machine with
    ``nvcc``); the CPU tests hold a mirror of it."""
    import ctypes

    from geoguessr_ai_torch.ops import _build

    out = (ctypes.c_int * 7)()
    in_bytes = torch.finfo(dtype).bits // 8 if dtype.is_floating_point \
        else torch.iinfo(dtype).bits // 8
    if _build.entry("tiled_gemm", "tiled_gemm_plan")(M, K, N, in_bytes, out):
        return None
    return dict(zip(("KB", "BN", "S", "mtiles", "ntiles", "bytes", "grid"),
                    out))


def tiled_matmul(a, b, out_dtype):
    """(M, K) @ (K, N) -> (M, N) in ``out_dtype``: bf16 operands give f32,
    int8 operands int32."""
    if a.dtype != b.dtype or a.dtype not in OUT_DTYPES:
        raise ValueError(f"a and b must both be bf16 or both int8, got "
                         f"{a.dtype} and {b.dtype}")
    if out_dtype != OUT_DTYPES[a.dtype]:
        raise ValueError(f"{a.dtype} operands give {OUT_DTYPES[a.dtype]}, "
                         f"not {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (M, K) and b (K, N), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    fn = _tiled_matmul_cuda if a.is_cuda else _tiled_matmul_plain
    return fn(a, b, out_dtype)
