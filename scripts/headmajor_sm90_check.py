"""Quick probe of the bf16 Hopper forward core (``csrc/attention_fwd_sm90.cuh``)
on one GPU: K8b and K8a (the head-major window attention) and K3 (the
attention over the interleaved qkv).

Builds ``attention_headmajor`` and ``attention_qkv`` and prints what
``ptxas`` reports for them (registers, spills, serialised wgmma: C75xx),
then at each shape below holds the kernel against its plain version (max
|err| / max |ref|), checks two calls bitwise, and at the main shapes (K8b
at stages 1 and 3 of the head-major serving path at a bucket of 16; K8a
at stage 2 of bucket 16 and stage 3 of bucket 1; K3 at stage 3 of bucket
16) prints the window groups and items, then times the kernel, SDPA with
the bias as a mask, and the bound, each as device time (20 calls in one
CUDA graph, replayed 5 times), with the exponentials' floor on a line of
its own (one exponential a score at 16 a clock an SM, at the card's
``clocks.max.sm``; not folded into the bound, which is max(ops,
bytes)).  Faster than chip_smoke.py, which runs the same checks among all
the others:

    python3 scripts/headmajor_sm90_check.py [--sweep]

``--sweep`` also times K8b where only the bytes or only the work a score
changes: stage 1 at head dims 16, 32 and 64 (the same scores, half and
twice the bytes), and the same bytes at N = 64 and 128 (a quarter and half
the scores); K8a at stage 2 at head dims 16, 32 and 64; and counts the
instructions of each kind in the code of K8b's stage-1 instance and of
K8a's stage-2 (streamed) one (``cuobjdump -sass``).
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

#: (kernel, W, H, N, hd, timed): the main shapes first.  K8a's cover the
#: resident bias (N up to 704 at hd 32), the streamed one (two-tile
#: chunks, and one-tile chunks at an odd C), item window groups cut short
#: (W not a multiple of 4) and a single window.
CASES = (
    ("K8b", 1024, 6, 256, 32, True), ("K8b", 64, 18, 256, 32, True),
    ("K8a", 64, 12, 1024, 32, True), ("K8a", 4, 18, 256, 32, True),
    ("K3", 64, 18, 256, 32, True),
    ("K8b", 8, 2, 64, 16, False), ("K8b", 8, 3, 128, 64, False),
    ("K8b", 64, 2, 192, 32, False), ("K8b", 8, 2, 320, 32, False),
    ("K8b", 16, 2, 384, 64, False), ("K8b", 8, 3, 448, 64, False),
    ("K8b", 8, 2, 448, 16, False), ("K8b", 1024, 2, 256, 64, False),
    ("K8b", 64, 4, 256, 16, False),
    ("K8a", 16, 8, 1024, 16, False), ("K8a", 16, 6, 1024, 64, False),
    ("K8a", 8, 2, 512, 32, False), ("K8a", 6, 2, 768, 32, False),
    ("K8a", 5, 2, 832, 64, False), ("K8a", 1, 3, 1024, 32, False),
    ("K8a", 3, 2, 576, 16, False), ("K8a", 7, 2, 2048, 32, False),
    ("K3", 4, 18, 256, 32, False), ("K3", 8, 2, 64, 16, False),
    ("K3", 8, 2, 320, 64, False), ("K3", 16, 12, 1024, 32, False),
    ("K3", 3, 2, 1024, 64, False), ("K3", 1, 4, 512, 16, False),
    ("K3", 64, 6, 256, 64, False),
)
TOL = 2e-2


def _inputs(kernel, W, H, N, hd, gen):
    if kernel == "K3":
        D = H * hd
        qkv = torch.randn(W, N, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda", torch.bfloat16)
        return (qkv, bias, hd ** -0.5, H)
    q, k, v = (torch.randn(W, H, N, hd, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
    return (q, k, v, bias, hd ** -0.5)


def _fns(kernel):
    return {"K8b": (wa._attention_batched_cuda, wa._attention_plain),
            "K8a": (wa._attention_qtiled_cuda, wa._attention_plain),
            "K3": (wa._attention_qkv_fused_cuda,
                   wa._attention_qkv_fused_plain)}[kernel]


def exp_floor_ms(scores):
    """One exponential a score at 16 MUFU.EX2 a clock an SM, at the card's
    clocks.max.sm."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return scores / (16 * sms * mhz * 1e6) * 1e3, mhz


#: (W, H, N, hd): stage 1, then its scores with other bytes, then its bytes
#: with fewer scores.
SWEEP = (("K8b", 1024, 6, 256, 32), ("K8b", 1024, 6, 256, 16),
         ("K8b", 1024, 6, 256, 64), ("K8b", 4096, 6, 64, 32),
         ("K8b", 2048, 6, 128, 32), ("K8a", 64, 12, 1024, 16),
         ("K8a", 64, 12, 1024, 32), ("K8a", 64, 12, 1024, 64))
#: The kernel instances whose instructions --sweep counts: K8b's at stage
#: 1 (resident, f32 bias, hd 32, four-tile chunks) and K8a's at stage 2
#: (streamed, two-tile chunks).
SASS = ("attention_fwd_sm90ILi0EfLi32ELi4ELb0E",
        "attention_fwd_sm90ILi0EfLi32ELi2ELb1E")


def sweep(gen):
    for kernel, W, H, N, hd in SWEEP:
        args = _inputs(kernel, W, H, N, hd, gen)
        fn = _fns(kernel)[0]
        ms = cs.device_time_ms(lambda: fn(*args))
        nbytes = 4 * W * H * N * hd * 2
        print(f"sweep {kernel} W={W} H={H} N={N} hd={hd}: ms {ms:.4f}, "
              f"{nbytes / ms / 1e9:.3f} TB/s of q, k, v, out, "
              f"{W * H * N * N / ms / 1e9:.3f} Tscores/s", flush=True)
        del args
    lib = next(_build.BUILD_DIR.glob("attention_headmajor-*.so"))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for name in SASS:
        counts, inside = {}, False
        for line in sass.splitlines():
            if "Function :" in line:
                inside = name in line
            elif inside and "/*" in line and ";" in line:
                op = line.split("*/", 1)[1].strip().split()[0]
                if op.startswith("@"):
                    op = line.split("*/", 1)[1].strip().split()[1]
                op = op.split(".")[0]
                counts[op] = counts.get(op, 0) + 1
        print(f"sass {name}: " + ", ".join(
            f"{k} {n}" for k, n in sorted(counts.items(), key=lambda x: -x[1])))


def _timed_line(kernel, W, H, N, hd, args):
    fn = _fns(kernel)[0]
    ms = cs.device_time_ms(lambda: fn(*args))
    if kernel == "K3":
        lib, what = cs._sdpa_ms(*args), "bias cast to bf16"
        bound, by = cs._bound_ms("K3", W, N, H * hd, H)
    else:
        lib, what = cs._headmajor_sdpa_ms(*args)
        bound, by = cs._headmajor_bound_ms(W, H, N)
    floor, mhz = exp_floor_ms(W * H * N * N)
    return (f" ms {ms:.4f} sdpa_ms {lib:.4f} ({what}) bound_ms {bound:.4f} "
            f"({by})\n  exp_floor {kernel} W={W} H={H} N={N}: {floor:.4f} ms "
            f"({W * H * N * N:.3g} exponentials at 16 a clock an SM, "
            f"{mhz:.0f} MHz)")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = ("attention_headmajor", "attention_qkv")
    secs = _build.build(libs)
    print(f"build {secs:.1f} s")
    for lib in libs:
        for line in _build.build_log(lib).splitlines():
            if any(w in line for w in ("registers", "spill", "C75", "arning",
                                       "rror")):
                print("ptxas", lib, line.strip())
    ok = True
    for shape, want in cs.K8B_BITS.items():
        got = cs.k8b_bits(*shape)
        print(f"K8b bits W={shape[0]} H={shape[1]} N={shape[2]}: {got} "
              f"(before the shared core {want})", flush=True)
        ok = ok and got == want
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, W, H, N, hd, timed in CASES:
        args = _inputs(kernel, W, H, N, hd, gen)
        fn, plain = _fns(kernel)
        try:
            a = fn(*args)
            b = fn(*args)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            print(f"{kernel} W={W} H={H} N={N} hd={hd} FAILED: {e}", flush=True)
            ok = False
            continue
        want = plain(*args)
        err = float((a.float() - want.float()).abs().max()
                    / want.float().abs().max())
        stable = torch.equal(a, b)
        finite = bool(torch.isfinite(a).all())
        G = wa._headmajor_groups(W, H, N)
        items = wa._headmajor_items(W, H, N, G)
        # K8a's streamed plan takes groups of four windows instead
        sched = "" if kernel == "K8a" else (
            f" G={G} items={items} grid={min(items, sms)}")
        line = (f"{kernel} W={W} H={H} N={N} hd={hd}{sched} rel {err:.3g} "
                f"stable {stable} finite {finite}")
        if timed:
            line += _timed_line(kernel, W, H, N, hd, args)
        print(line, flush=True)
        ok = ok and err < TOL and stable and finite
        del a, b, want, args
    if "--sweep" in sys.argv:
        sweep(gen)
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
