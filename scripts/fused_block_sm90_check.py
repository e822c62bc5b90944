"""Quick probe of K1 (the fused attention block, ``csrc/fused_block.cu``)
and K9 (the same over the raw map, ``csrc/fb4d.cu``) in bf16 on one GPU,
with K2 (``csrc/fb_s2.cu``), which shares their LayerNorm + GEMM core.

Builds ``fused_block``, ``fb4d`` and ``fb_s2`` and prints what ``ptxas``
reports for them (registers, spills, serialised wgmma: C75xx), then at
each shape below holds the kernel against its plain version (max |err| /
max |ref|), checks two calls bitwise and K9 against K1 on the partitioned
map bit for bit.  At the main shapes (K1 at stage 1 of a serving bucket of
16 and at the embed configuration's stage 3; K9 at 64 and 512 images of
stage 1) it times the kernel (as device time: 20 calls in one CUDA graph,
replayed 5 times; K9 at 512 images by events over 10 calls), prints each
of its three launches' device time (torch.profiler), the bound of the
fused work and the floor of the three launches' bytes:

    python3 scripts/fused_block_sm90_check.py [--yardsticks] [--groups]

``--yardsticks`` also times cuBLAS's matmul and PyTorch's LayerNorm at the
GEMMs' shapes (the port never calls them there); ``--groups`` times the
attention launch with more window groups than ``_headmajor_groups`` gives.
Faster than chip_smoke.py, which runs the same checks among all the
others.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

#: K1 (W, N, C, H, timed): stage 1 of a serving bucket of 16 and the embed
#: configuration's stage 3 first, then head dims 16 and 64, the card
#: tests' shapes, a row count that is no multiple of the GEMMs' 128-row
#: tile and N = 1024.
K1_CASES = (
    (1024, 256, 192, 6, True), (64, 256, 576, 18, True),
    (64, 256, 128, 8, False), (64, 256, 384, 6, False),
    (4, 256, 192, 6, False), (2, 1024, 64, 2, False), (5, 64, 192, 6, False),
    (3, 128, 576, 18, False),
)
#: K9 (images, map side, C, H, window, timed): stage 1 at a serving bucket
#: of 16 (64 images) and at the embed batch (512), head dims 16 and 64, a
#: narrow map and 32 x 32 windows.
K9_CASES = (
    (64, 64, 192, 6, 16, True), (512, 64, 192, 6, 16, True),
    (1, 128, 128, 8, 16, False), (1, 128, 384, 6, 16, False),
    (2, 32, 64, 2, 16, False), (2, 64, 64, 2, 32, False),
)
#: K2 (W, N, C, H): stage 2 of a serving bucket of 16, the core's qkv kind
#: as before.
K2_CASES = ((64, 1024, 384, 12), (7, 64, 192, 6))
TOL = 2e-2


def _rel(a, want):
    return float((a.float() - want.float()).abs().max()
                 / want.float().abs().max())


def floor_ms(W, N, C, D, H, elem=2):
    """The three launches' bytes at the card's peak rate: x in, qkv out and
    in, the attention output out and in, out; the weights and the bias
    once each."""
    rows = W * N
    nbytes = elem * (rows * (C + 2 * 3 * D + 2 * D + C) + 4 * C * D
                     + H * N * N)
    return nbytes / cs.PEAK_BYTES_S * 1e3


def _k1_args(a, C, H):
    return (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
            a["w_proj"], a["b_proj"], a["bias"], (C // H) ** -0.5, H, 1e-5)


def _timing(label, fn, W, N, C, H, events=False):
    ms = cs.cuda_time_ms(fn) if events else cs.device_time_ms(fn)
    bound, by = cs._bound_ms("K1", W, N, C, H)
    launches = cs._launch_ms(fn)
    return (f" ms {ms:.4f} bound_ms {bound:.4f} ({by}) floor_ms "
            f"{floor_ms(W, N, C, C, H):.4f} (three launches' bytes)\n  {label} "
            "launch_ms (device, torch.profiler) " + (", ".join(
                f"{k} {v:.4f}" for k, v in launches.items())
                if launches else "not measured"))


def check_k1(gen):
    ok = True
    for W, N, C, H, timed in K1_CASES:
        a = cs._case_inputs(W, N, C, H, gen)
        args = _k1_args(a, C, H)
        fn = lambda: wa._fused_block_cuda(*args)  # noqa: E731
        x, y = fn(), fn()
        torch.cuda.synchronize()
        want = wa._fused_block_plain(*args)
        err, stable = _rel(x, want), torch.equal(x, y)
        finite = bool(torch.isfinite(x).all())
        line = (f"K1 W={W} N={N} C={C} H={H} hd={C // H} rel {err:.3g} "
                f"stable {stable} finite {finite}")
        if timed:
            line += _timing("K1", fn, W, N, C, H)
        print(line, flush=True)
        ok = ok and err <= TOL and stable and finite
        del a, args, x, y, want
        torch.cuda.empty_cache()
    return ok


def check_k9(gen):
    ok = True
    for images, side, C, H, ws, timed in K9_CASES:
        N = ws * ws
        W = images * (side // ws) ** 2
        a = cs._case_inputs(W, N, C, H, gen)
        x4 = a["x"].reshape(images, side, side, C)
        args = (x4, *_k1_args(a, C, H)[1:-1], ws, 1e-5)
        fn = lambda: wa._fb4d_cuda(*args)  # noqa: E731
        x, y = fn(), fn()
        torch.cuda.synchronize()
        k1 = wa.window_unpartition(wa._fused_block_cuda(
            wa.window_partition(x4, ws), *_k1_args(a, C, H)[1:]), ws,
            (side, side))
        same = torch.equal(x, k1)
        del k1
        want = torch.cat([wa._fb4d_plain(x4[i:i + 64], *args[1:])
                          for i in range(0, images, 64)])
        err, stable = _rel(x, want), torch.equal(x, y)
        finite = bool(torch.isfinite(x).all())
        line = (f"K9 {images} images map={side}x{side} C={C} H={H} "
                f"window={ws} rel {err:.3g} stable {stable} equal_to_k1 "
                f"{same} finite {finite}")
        if timed:
            line += _timing("K9", fn, W, N, C, H, events=images > 64)
        print(line, flush=True)
        ok = ok and err <= TOL and stable and same and finite
        del a, args, x, y, want, x4
        torch.cuda.empty_cache()
    return ok


def check_k2(gen):
    ok = True
    for W, N, C, H in K2_CASES:
        a = cs._case_inputs(W, N, C, H, gen)
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["bias"], (C // H) ** -0.5, H, 1e-5)
        fn = lambda: wa._fb_s2_cuda(*args)  # noqa: E731
        x, y = fn(), fn()
        torch.cuda.synchronize()
        err, stable = _rel(x, wa._fb_s2_plain(*args)), torch.equal(x, y)
        print(f"K2 W={W} N={N} C={C} H={H} rel {err:.3g} stable {stable} "
              f"ms {cs.device_time_ms(fn):.4f}", flush=True)
        ok = ok and err <= TOL and stable
        del a, args, x, y
    return ok


def yardsticks(gen):
    """cuBLAS's bf16 matmul and PyTorch's LayerNorm at the GEMMs' shapes of
    K1 at stage 1 of a serving bucket of 16 and of K9 at 512 images (qkv:
    (M, 192) x (192, 576); projection: (M, 192) x (192, 192)): what one
    library call takes for each piece, beside the core's launches."""
    import torch.nn.functional as F

    for M in (262144, 2097152):
        x = torch.randn(M, 192, generator=gen).to("cuda", torch.bfloat16)
        for name, n in (("qkv", 576), ("proj", 192)):
            w = (torch.randn(n, 192, generator=gen) / 14).to(
                "cuda", torch.bfloat16)
            fn = lambda: x @ w.t()  # noqa: E731
            print(f"yardstick M={M} {name} matmul (cuBLAS) ms "
                  f"{cs.kernel_ms(fn):.4f}", flush=True)
        fn = lambda: F.layer_norm(x, (192,))  # noqa: E731
        print(f"yardstick M={M} layer_norm ms {cs.kernel_ms(fn):.4f}",
              flush=True)
        del x


def groups_sweep(gen):
    """The forward core's interleaved attention (K1's and K9's second
    launch, through K3's wrapper) at K9's 512 images (W = 8192) and at K1's
    bucket 16 (W = 1024), N = 256, H = 6, with the window groups G that
    ``_headmajor_groups`` gives (42) and with more: device time by events
    over 10 calls, and whether the bits change with G."""
    real = wa._headmajor_groups
    for W in (8192, 1024):
        bf = torch.bfloat16
        qkv = torch.randn(W, 256, 576, generator=gen).to("cuda", bf)
        bias = (torch.randn(6, 256, 256, generator=gen) * 0.5).to("cuda", bf)
        fn = lambda: wa._attention_qkv_fused_cuda(  # noqa: E731
            qkv, bias, 32 ** -0.5, 6)
        want = fn()
        for G in (real(W, 6, 256), 84, 168, 336, 672):
            wa._headmajor_groups = lambda *a, G=G: G
            got = fn()
            torch.cuda.synchronize()
            bits = "equal" if torch.equal(got, want) else "differ"
            print(f"groups W={W} G={G} ({W / G:.1f} windows a group) ms "
                  f"{cs.cuda_time_ms(fn):.4f} bits {bits}", flush=True)
        wa._headmajor_groups = real
        del qkv, bias, want, got


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = ("fused_block", "fb4d", "fb_s2")
    try:
        print(f"build {_build.build(libs):.1f} s")
    except RuntimeError as e:
        print(str(e)[-6000:])
        sys.exit(1)
    for lib in libs:
        fn = ""
        for line in _build.build_log(lib).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif ("bytes spill stores" in line
                  and " 0 bytes spill stores" not in line):
                print("ptxas", lib, fn, line.strip())
            elif any(w in line for w in ("registers", "C75", "arning", "rror")):
                print("ptxas", lib, line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ok = check_k1(gen)
    ok = check_k9(gen) and ok
    ok = check_k2(gen) and ok
    if "--yardsticks" in sys.argv:
        yardsticks(gen)
    if "--groups" in sys.argv:
        groups_sweep(gen)
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
