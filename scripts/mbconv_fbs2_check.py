"""Quick probe of K10 (the fused stage-0 MBConv, ``csrc/mbconv.cu``) and K2
(the stage-2 no-proj fused block, ``csrc/fb_s2.cu``) in bf16 on one GPU.

Builds ``mbconv`` and ``fb_s2`` and prints what ``ptxas`` reports for them
(registers, spills, serialised wgmma: C75xx), then at each shape below
holds the kernel against its plain version (max |err| / max |ref|) and
checks two calls bitwise.  At the main shapes (K10 at 64 and 512 images of
TinyViT-21M's stage 0, K2 at stage 2 of a serving bucket of 16) it times
the kernel (K2 as device time: 20 calls in one CUDA graph, replayed 5
times; K10 by events over 10 calls), prints each of K2's two launches'
device time (torch.profiler), the bound, and for K10 the floors of its
special-function (MUFU), FP32 and shared-memory pipes at the card's
``clocks.max.sm``, from the instruction counts of the kernel's inner
loops (``K10_PER_EXPANDED``):

    python3 scripts/mbconv_fbs2_check.py [--sass]

``--sass`` also counts the instructions of each kind in the code of K10's
bf16 kernel (``cuobjdump -sass``).  Faster than chip_smoke.py, which runs
the same checks among all the others.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import mbconv  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

#: K10 (images, map height, map width, C, E, exact GELU, timed): the main
#: shapes first, then the other channel counts, ragged maps and the erf
#: GELU.
K10_CASES = (
    (64, 128, 128, 96, 384, False, True), (512, 128, 128, 96, 384, False, True),
    (4, 128, 128, 64, 256, False, False), (4, 128, 128, 32, 128, False, False),
    (3, 7, 9, 96, 384, False, False), (2, 112, 112, 64, 256, False, False),
    (2, 17, 33, 32, 192, False, False), (4, 128, 128, 96, 384, True, False),
    (1, 16, 16, 96, 64, False, False),
)
#: K2 (W, N, C, H, timed): stage 2 of a serving bucket of 16 first, then
#: head dims 16 and 64 at N = 1024 (chip_smoke's HEAD_DIM_CASES), a row
#: count that is not a multiple of 128 and small windows.
K2_CASES = (
    (64, 1024, 384, 12, True), (16, 1024, 128, 8, False),
    (16, 1024, 384, 6, False), (3, 1024, 384, 12, False),
    (7, 64, 192, 6, False), (5, 256, 384, 12, False), (1, 1024, 384, 12, False),
)
TOL = 2e-2
#: Instructions of each pipe for one (output pixel, expanded channel) of
#: K10's bf16 kernel at a 16 x 16 output tile (1.5 expanded halo pixels an
#: output pixel), counted from its code: MUFU: one tanh.approx for each of
#: the 1.5 + 1 + 0.25 GELUs; FP32: the 9 depthwise FMAs and, for each of
#: the 2.75 GELUs, BN's FMA, the GELU's five operations and its two bf16
#: roundings; shared memory: the depthwise's 25 wavefronts a warp (16 h
#: words and 9 tap pairs) for 256 (pixel, channel) outputs, and the
#: expanded chunk's stores (1.5 rows, a word of 2 channels for each lane,
#: 2-way bank conflicts).
K10_PER_EXPANDED = {"mufu": 2.75, "fp32": 9 + 2.75 * 8,
                    "smem_wavefronts": 25 / 256 + 1.5 * 2 / 64}


def _mbconv_inputs(B, Hm, Wm, C, E, gen):
    from geoguessr_ai_torch.ops.mbconv import fold_bn

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to("cuda")

    def folded(n):
        return fold_bn(randn(n, std=0.1, mean=1.0), randn(n, std=0.1),
                       randn(n, std=0.1), randn(n, std=0.1, mean=1.0).abs())

    bf = torch.bfloat16
    return (randn(B, Hm, Wm, C).to(bf), randn(E, C, std=C ** -0.5).to(bf).t(),
            *folded(E), randn(3, 3, E, std=1 / 3).to(bf), *folded(E),
            randn(C, E, std=E ** -0.5).to(bf).t(), *folded(C))


def _clock():
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    return mhz, torch.cuda.get_device_properties(0).multi_processor_count


def k10_floors(images, E=384, Hm=128, Wm=128):
    """ms of each pipe's work for K10 at its instruction counts: MUFU at 16
    a clock an SM, FP32 at 128, shared memory at one wavefront a clock."""
    mhz, sms = _clock()
    per_s = sms * mhz * 1e6
    n = images * Hm * Wm * E
    rate = {"mufu": 16, "fp32": 128, "smem_wavefronts": 1}
    return {k: n * v / (rate[k] * per_s) * 1e3
            for k, v in K10_PER_EXPANDED.items()}, mhz


def _rel(a, want):
    return float((a.float() - want.float()).abs().max()
                 / want.float().abs().max())


def check_k10(gen):
    ok = True
    for B, Hm, Wm, C, E, exact, timed in K10_CASES:
        args = _mbconv_inputs(B, Hm, Wm, C, E, gen)
        fn = lambda: mbconv._mbconv_cuda(*args, exact)  # noqa: E731
        a, b = fn(), fn()
        torch.cuda.synchronize()
        want = torch.cat([mbconv._mbconv_plain(args[0][i:i + 64], *args[1:], exact)
                          for i in range(0, B, 64)])
        err, stable = _rel(a, want), torch.equal(a, b)
        finite = bool(torch.isfinite(a).all())
        line = (f"K10 B={B} map={Hm}x{Wm} C={C} E={E} exact={exact} rel {err:.3g} "
                f"stable {stable} finite {finite}")
        if timed:
            ms = cs.cuda_time_ms(fn)
            bound, by = cs._mbconv_bound_ms(B)
            floors, mhz = k10_floors(B, E, Hm, Wm)
            line += (f" ms {ms:.4f} bound_ms {bound:.4f} ({by})\n  floors K10 "
                     f"B={B} at {mhz:.0f} MHz: " + ", ".join(
                         f"{k} {v:.4f} ms" for k, v in floors.items()))
        print(line, flush=True)
        ok = ok and err <= TOL and stable and finite
        del a, b, want, args
        torch.cuda.empty_cache()
    return ok


def check_k2(gen):
    ok = True
    for W, N, C, H, timed in K2_CASES:
        a = cs._case_inputs(W, N, C, H, gen)
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
                a["bias"], (C // H) ** -0.5, H, 1e-5)
        fn = lambda: wa._fb_s2_cuda(*args)  # noqa: E731
        x, y = fn(), fn()
        torch.cuda.synchronize()
        want = wa._fb_s2_plain(*args)
        err, stable = _rel(x, want), torch.equal(x, y)
        finite = bool(torch.isfinite(x).all())
        line = (f"K2 W={W} N={N} C={C} H={H} hd={C // H} rel {err:.3g} "
                f"stable {stable} finite {finite}")
        if timed:
            ms = cs.device_time_ms(fn)
            bound, by = cs._bound_ms("K2", W, N, C, H)
            launches = cs._launch_ms(fn)
            line += (f" ms {ms:.4f} bound_ms {bound:.4f} ({by})\n  K2 launch_ms "
                     "(device, torch.profiler) " + (", ".join(
                         f"{k} {v:.4f}" for k, v in launches.items())
                         if launches else "not measured"))
        print(line, flush=True)
        ok = ok and err <= TOL and stable and finite
        del a, args, x, y, want
        torch.cuda.empty_cache()
    return ok


def sass_counts():
    lib = next(_build.BUILD_DIR.glob("mbconv-*.so"))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, name, inside = {}, "", False
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            inside = "mbconv" in name and "Li96E" in name
            if inside:
                counts[name] = {}
        elif inside and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()[0]
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            op = op.split(".")[0]
            counts[name][op] = counts[name].get(op, 0) + 1
    for name, c in counts.items():
        print(f"sass {name}: " + ", ".join(
            f"{k} {n}" for k, n in sorted(c.items(), key=lambda x: -x[1])[:25]))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = ("mbconv", "fb_s2")
    try:
        print(f"build {_build.build(libs):.1f} s")
    except RuntimeError as e:
        print(str(e)[-6000:])
        sys.exit(1)
    for lib in libs:
        for line in _build.build_log(lib).splitlines():
            if any(w in line for w in ("registers", "spill", "C75", "arning",
                                       "rror")):
                print("ptxas", lib, line.strip())
    gen = torch.Generator().manual_seed(0)
    ok = check_k2(gen)
    ok = check_k10(gen) and ok
    if "--sass" in sys.argv:
        sass_counts()
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
