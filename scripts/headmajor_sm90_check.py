"""Quick probe of K8b's bf16 Hopper kernel (the head-major small-N window
attention) on one GPU.

Builds ``attention_headmajor`` and prints what ``ptxas`` reports for it
(registers, spills, serialised wgmma), then at each shape below holds
``_attention_batched_cuda`` against ``_attention_plain`` (max |err| / max
|ref|), checks two calls bitwise, and at the two head-major serving shapes
of a bucket of 16 (stage 1: W=1024, H=6, N=256; stage 3: W=64, H=18)
prints the window groups and items, then times the kernel, SDPA with the
bias as a float mask, and the bound, each as device time (20 calls in one
CUDA graph, replayed 5 times).  Faster than chip_smoke.py, which runs the
same checks among all the others:

    python3 scripts/headmajor_sm90_check.py [--sweep]

``--sweep`` also times the kernel where only the bytes or only the work a
score changes: stage 1 at head dims 16, 32 and 64 (the same scores, half
and twice the bytes), and the same bytes at N = 64 and 128 (a quarter and
half the scores), and counts the instructions of each kind in the stage-1
instance's code (``cuobjdump -sass``).
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

#: (W, H, N, hd); the first two are the serving shapes at bucket 16.
CASES = ((1024, 6, 256, 32), (64, 18, 256, 32), (8, 2, 64, 16),
         (8, 3, 128, 64), (64, 2, 192, 32), (8, 2, 320, 32),
         (16, 2, 384, 64), (8, 3, 448, 64), (8, 2, 448, 16),
         (1024, 2, 256, 64), (64, 4, 256, 16))
TOL = 2e-2


#: (W, H, N, hd): stage 1, then its scores with other bytes, then its bytes
#: with fewer scores.
SWEEP = ((1024, 6, 256, 32), (1024, 6, 256, 16), (1024, 6, 256, 64),
         (4096, 6, 64, 32), (2048, 6, 128, 32))


def sweep(gen):
    for W, H, N, hd in SWEEP:
        q, k, v = (torch.randn(W, H, N, hd, generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        args = (q, k, v, bias, hd ** -0.5)
        ms = cs.device_time_ms(lambda: wa._attention_batched_cuda(*args))
        nbytes = 4 * W * H * N * hd * 2
        print(f"sweep W={W} H={H} N={N} hd={hd}: ms {ms:.4f}, "
              f"{nbytes / ms / 1e9:.3f} TB/s of q, k, v, out, "
              f"{W * H * N * N / ms / 1e9:.3f} Tscores/s", flush=True)
    lib = next(_build.BUILD_DIR.glob("attention_headmajor-*.so"))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    name = "attention_batched_sm90ILi32ELi4E"
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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    secs = _build.build(("attention_headmajor",))
    print(f"build {secs:.1f} s")
    for line in _build.build_log("attention_headmajor").splitlines():
        if any(w in line for w in ("registers", "spill", "C75", "arning")):
            print("ptxas", line.strip())
    ok = True
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (W, H, N, hd) in enumerate(CASES):
        q, k, v = (torch.randn(W, H, N, hd, generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(3))
        bias = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
        args = (q, k, v, bias, hd ** -0.5)
        a = wa._attention_batched_cuda(*args)
        b = wa._attention_batched_cuda(*args)
        torch.cuda.synchronize()
        want = wa._attention_plain(*args)
        err = float((a.float() - want.float()).abs().max()
                    / want.float().abs().max())
        stable = torch.equal(a, b)
        finite = bool(torch.isfinite(a).all())
        G = wa._headmajor_groups(W, H, N)
        items = wa._headmajor_items(W, H, N, G)
        line = (f"K8b W={W} H={H} N={N} hd={hd} G={G} items={items} grid="
                f"{min(items, sms)} rel {err:.3g} stable {stable} finite "
                f"{finite}")
        if i < 2:
            ms = cs.device_time_ms(lambda: wa._attention_batched_cuda(*args))
            lib, what = cs._headmajor_sdpa_ms(*args)
            bound, by = cs._headmajor_bound_ms(W, H, N)
            line += (f" ms {ms:.4f} sdpa_ms {lib:.4f} ({what}) bound_ms "
                     f"{bound:.4f} ({by})")
        print(line, flush=True)
        ok = ok and err < TOL and stable and finite
    if "--sweep" in sys.argv:
        sweep(gen)
    print("ALL OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
