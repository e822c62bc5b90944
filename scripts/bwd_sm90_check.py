"""Quick probe of the attention backwards K4, K5 and K7 on one GPU, in
bf16 or (``--f32``) in f32, the backward core's two kinds.

Builds the two libraries, then for ten shapes (the B=16 train shapes of
K4 at stages 1 and 3 and of K7 at stage 2, and small ones at head dims 16,
32 and 64, ragged N and window groups of one and of several windows)
holds each call against its plain version (max |err| / max |ref| of d_qkv,
of its q, k and v parts, and of d_bias), checks two calls bitwise and,
at the train shapes, times a call by events (10 after 2 warm-ups); then
counts the elements where K7 and K5 differ on the same inputs, and prints
the device time of each launch of K4, K7 and K5 at the train shapes
(torch.profiler).  With ``--f32`` every operand is f32, the tolerance is
1e-3, the cases add K4 at TinyViT-5M-224's three shapes (timed too), K7
and K5 must agree bit for bit where K7 takes one window group, and the
compiler's register and spill lines of the f32 kind are printed first.
Faster than chip_smoke.py, which runs the same checks among all the
others:

    python3 scripts/bwd_sm90_check.py [--f32]
"""

import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

#: (kernel, W, N, H, hd); the first three are the train shapes.
CASES = (("K4", 1024, 256, 6, 32), ("K4", 64, 256, 18, 32),
         ("K7", 64, 1024, 12, 32), ("K4", 3, 128, 2, 32),
         ("K4", 1, 64, 2, 16), ("K4", 17, 196, 3, 64),
         ("K7", 3, 512, 6, 32), ("K7", 2, 1024, 2, 64),
         ("K7", 3, 192, 2, 16), ("K4", 4, 256, 6, 64))
KERNELS = {"K4": (wa._attention_qkv_bwd_cuda, wa._attention_qkv_bwd_plain),
           "K7": (wa._attention_bwd_qtiled_cuda,
                  wa._attention_bwd_qtiled_plain),
           "K5": (wa._attention_bwd_merged_cuda,
                  wa._attention_bwd_merged_plain)}
#: K4's f32 cases at TinyViT-5M-224 (B=64), timed with the train shapes.
F32_CASES = (("K4", 1024, 49, 4, 32), ("K4", 64, 196, 5, 32),
             ("K4", 64, 49, 10, 32))
F32 = "--f32" in sys.argv[1:]
DTYPE = torch.float32 if F32 else torch.bfloat16
TOL = 1e-3 if F32 else 2e-2


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def inputs(W, N, H, hd, gen):
    D = H * hd
    return (torch.randn(W, N, 3 * D, generator=gen).to("cuda", DTYPE),
            (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda"),
            torch.randn(W, N, D, generator=gen).to("cuda", DTYPE),
            hd ** -0.5, H)


def event_ms(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    secs = _build.build(("attention_qkv_bwd", "attention_bwd_qtiled",
                         "attention_bwd_merged"))
    print(f"build {secs:.1f} s")
    if F32:
        for lib in ("attention_qkv_bwd", "attention_bwd_qtiled",
                    "attention_bwd_merged"):
            log = _build.build_log(lib).splitlines()
            for j, line in enumerate(log):
                if "Compiling entry function" in line and "f32_sm90" in line:
                    print(lib, line.split("'")[1][:60], *(
                        x.strip() for x in log[j + 1:j + 4]
                        if "Used" in x or "spill" in x))
    ok = True
    gen = torch.Generator().manual_seed(0)
    cases = CASES[:3] + (F32_CASES if F32 else ()) + CASES[3:]
    timed = 6 if F32 else 3
    for i, (k, W, N, H, hd) in enumerate(cases):
        args = inputs(W, N, H, hd, gen)
        kern, plain = KERNELS[k]
        a, b = kern(*args), kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        parts = [rel(a[0].view(W, N, H, 3, hd)[..., j, :],
                     want[0].view(W, N, H, 3, hd)[..., j, :]) for j in range(3)]
        stable = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        finite = bool(torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all())
        e1, e2 = rel(a[0], want[0]), rel(a[1], want[1])
        line = (f"{k} W={W} N={N} H={H} hd={hd} G="
                f"{wa._bwd_groups(W, -(-N // 64) * 64, H)} d_qkv {e1:.3g} (q, k, v "
                f"{parts[0]:.3g} {parts[1]:.3g} {parts[2]:.3g}) d_bias {e2:.3g} "
                f"stable {stable} finite {finite}")
        if i < timed:
            line += f" ms {event_ms(lambda: kern(*args)):.4f}"
        print(line, flush=True)
        ok = ok and e1 < TOL and e2 < TOL and stable and finite
    gen = torch.Generator().manual_seed(1)
    for W, N, H in ((64, 1024, 12), (2, 1024, 2)):
        args = inputs(W, N, H, 32, gen)
        a = wa._attention_bwd_qtiled_cuda(*args)
        b = wa._attention_bwd_merged_cuda(*args)
        torch.cuda.synchronize()
        G = wa._bwd_groups(W, N, H)
        print(f"K7 vs K5 W={W} N={N} H={H} (K7's G={G}): d_qkv elements "
              f"that differ {int((a[0] != b[0]).sum())} of {a[0].numel()}; "
              f"d_bias max difference {float((a[1] - b[1]).abs().max()):.3g}")
        if F32 and G == 1:
            ok = ok and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    gen = torch.Generator().manual_seed(0)
    for k, W, N, H, hd in (CASES[:3] + (("K5",) + CASES[2][1:],)
                           + (F32_CASES if F32 else ())):
        args = inputs(W, N, H, hd, gen)
        kern = KERNELS[k][0]
        for _ in range(3):
            kern(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kern(*args)
            torch.cuda.synchronize()
        print(f"{k} W={W} N={N} H={H} launches (device ms a call):")
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0)
            if t > 0:
                print(f"  {t / 5 / 1e3:.4f}  {e.key[:100]}")
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
