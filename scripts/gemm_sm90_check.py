"""Probes the Hopper GEMM core (``csrc/gemm_sm90.cuh``) and its two users on
one GPU: K11 (CLIP attention + out-projection, ``clip_attention.
_flash_proj_cuda``: K6's kernel, then the core's bf16 -> bf16 kind) and K13
(``ops.experimental.tiled_gemm``: the core's int8 -> int32 and bf16 -> f32
kinds).

    python3 scripts/gemm_sm90_check.py

It builds the three libraries (printing what ``ptxas`` says of the core's
instances), prints the core's plan at each shape, and then for each shape
holds the kernel against its plain version (int8 exactly, bf16 within
chip_smoke.KERNEL_REL_TOL), checks it bitwise stable over two calls, and
prints its time (``chip_smoke.kernel_ms``: device time under 0.5 ms)
beside the bound and the library call; K13 with b K-major, as the kernel
reads it, and also from a (K, N) b, whose transpose copy the wrapper
makes at every call.  K11 is also held bit for bit
against the core applied to K6's output (K13's bf16 kind on K6's output,
padded to whole 128-row tiles, rounded to bf16) and split into its two
launches (torch.profiler), beside cuBLAS's ``o @ w``.  Any failure exits
non-zero.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import clip_attention as ca  # noqa: E402
from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg  # noqa: E402

#: (M, K, N) of K13: the edges (one 64-byte k-box, a 64-byte K tail, the
#: smallest tile count), a column count that takes 128-column tiles, and
#: the JAX tool's four shapes.
K13_SHAPES = ((128, 64, 128), (128, 192, 128), (256, 384, 384),
              (1024, 1024, 640)) + cs.K13_SHAPES
#: (B, N, D, H) of K11: CLIP ViT-L/14-336 at bucket 16, ViT-B/32's N = 50,
#: head dims 32 and 16.
K11_SHAPES = ((64, 577, 1024, 16), (64, 50, 768, 12), (3, 129, 128, 4),
              (2, 577, 128, 8))


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def build():
    secs = _build.build(("clip_flash", "clip_flash_proj", "tiled_gemm"))
    print(f"build_seconds {secs:.2f}")
    for name in ("tiled_gemm", "clip_flash_proj"):
        kernel = None
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            if "gemm_sm90" in (kernel or "") and (
                    "registers" in line or "spill" in line):
                print(f"ptxas {name} {kernel[-60:]}: {line.strip()}")
            if "warning" in line.lower() or "wgmma" in line.lower():
                print(f"ptxas {name}: {line.strip()}")


def k13_case(M, K, N, gen):
    rates = {}
    for int8 in (True, False):
        if int8:
            a = torch.randint(-127, 128, (M, K), generator=gen,
                              dtype=torch.int8).cuda()
            b = torch.randint(-127, 128, (K, N), generator=gen,
                              dtype=torch.int8).cuda()
            out_dtype, kind = torch.int32, "int8"
        else:
            a = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
            b = torch.randn(K, N, generator=gen).to("cuda", torch.bfloat16)
            out_dtype, kind = torch.float32, "bf16"
        plan = tg.core_plan(M, K, N, a.dtype)
        # b as the kernel reads it (K-major: the transpose view of an (N, K)
        # tensor), made once outside the timing; from a (K, N) b the
        # wrapper makes that copy at every call
        bk = b.t().contiguous().t()
        got = tg._tiled_matmul_cuda(a, bk, out_dtype)
        again = tg._tiled_matmul_cuda(a, bk, out_dtype)
        want = tg._tiled_matmul_plain(a, b, out_dtype)
        torch.cuda.synchronize()
        stable = torch.equal(got, again)
        max_abs, rel = cs._rel_err(got, want)
        ok = (torch.equal(got, want) if int8 else
              rel <= cs.KERNEL_REL_TOL and bool(torch.isfinite(got).all()))
        del got, again, want
        ms = cs.kernel_ms(lambda: tg._tiled_matmul_cuda(a, bk, out_dtype))
        with_copy = cs.kernel_ms(lambda: tg._tiled_matmul_cuda(a, b, out_dtype))
        copy_ms = cs.kernel_ms(lambda: b.t().contiguous())
        lib, what = cs._k13_library(a, b, int8)
        lib_ms = cs.kernel_ms(lib)
        bound, by, _, _ = cs._k13_bound_ms(M, K, N, int8)
        ops = 2.0 * M * K * N
        rates[kind] = ops / ms / 1e9
        print(f"K13 {kind} ({M}, {K}, {N}) plan {plan}: "
              + ("exact" if int8 else f"max_rel_err {rel:.4g}")
              + f" {ok}, bitwise over two calls {stable}; ms {ms:.4f} "
              f"({rates[kind]:.1f} TOPS), bound {bound:.4f} ({by}), "
              f"library {lib_ms:.4f} ({what}); from a (K, N) b "
              f"{with_copy:.4f} (its transpose copy alone {copy_ms:.4f})",
              flush=True)
        if not (ok and stable):
            _fail(f"K13 {kind} ({M}, {K}, {N}): correct {ok}, stable {stable}")
        del a, b, bk
        torch.cuda.empty_cache()
    print(f"K13 int8 / bf16 rate at ({M}, {K}, {N}): "
          f"{rates['int8'] / rates['bf16']:.3f}", flush=True)


def k11_case(B, N, D, H, gen):
    hd = D // H
    scale = hd ** -0.5
    qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(D, D, generator=gen) * D ** -0.5).to("cuda",
                                                         torch.bfloat16)
    got = ca._flash_proj_cuda(qkv, w, scale, H)
    again = ca._flash_proj_cuda(qkv, w, scale, H)
    core = cs._core_of_k6(qkv, w, scale, H)
    want = ca._flash_proj_plain(qkv, w, scale, H)
    torch.cuda.synchronize()
    max_abs, rel = cs._rel_err(got, want)
    stable, same = torch.equal(got, again), torch.equal(got, core)
    finite = bool(torch.isfinite(got).all())
    del got, again, core, want
    plan = tg.core_plan(B * N, D, D, torch.bfloat16)
    fn = lambda: ca._flash_proj_cuda(qkv, w, scale, H)  # noqa: E731
    ms = cs.kernel_ms(fn)
    k6_ms = cs.kernel_ms(lambda: ca._flash_cuda(qkv, scale, H))
    split = cs._launch_ms(fn) or {}
    o = ca._flash_cuda(qkv, scale, H)
    mm_ms = cs.kernel_ms(lambda: o @ w)
    bound, by = cs._clip_bound_ms("K11", B, N, D, H)
    print(f"K11 (B, N, D, H) = ({B}, {N}, {D}, {H}) hd {hd} plan {plan}: "
          f"max_rel_err {rel:.4g} finite {finite}, bitwise over two calls "
          f"{stable}, equal to the core on K6's output {same}; ms {ms:.4f}, "
          f"K6 alone {k6_ms:.4f}, launches " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items())
          + f"; cuBLAS o @ w {mm_ms:.4f}; bound {bound:.4f} ({by})",
          flush=True)
    if not (finite and rel <= cs.KERNEL_REL_TOL and stable and same):
        _fail(f"K11 ({B}, {N}, {D}, {H}): rel {rel:.3g}, finite {finite}, "
              f"stable {stable}, equal to the core on K6 {same}")
    ca.reset_launches()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    gen = torch.Generator().manual_seed(0)
    for shape in K11_SHAPES:
        k11_case(*shape, gen)
    for shape in K13_SHAPES:
        k13_case(*shape, gen)
    print(card, flush=True)


if __name__ == "__main__":
    main()
