"""Quick probe of K6's and K11's f32 entries (``csrc/clip_flash.cu``,
``csrc/clip_flash_proj.cu``) on one GPU: the f32 kind of K6's Hopper
kernel (``clip_flash_sm90.cuh``) and the GEMM core's kSplitF32 kind
(``gemm_sm90.cuh``).

Builds ``clip_flash`` and ``clip_flash_proj`` and prints what ``ptxas``
reports for the f32 kind's kernels (registers, spills, serialised wgmma:
C75xx), then at each shape below holds each entry against its plain f32
version (max |err| / max |ref| within chip_smoke.F32_REL_TOL), checks two
calls bitwise and K11 bitwise against the core's kSplitF32 kind applied to
the split of K6's f32 output.  At the timed shapes (CLIP-L's bucket 16 and
ViT-B/32's N = 50 at 64 images) it prints each entry's device time, each
launch's (torch.profiler: the split of k and v, the attention, the
projection), the f32 bound and the f32 yardsticks (SDPA; K11: SDPA and
then the matmul):

    python3 scripts/clip_f32_check.py

Faster than chip_smoke.py, which runs the timed shapes among all the
others.
"""

import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402

#: (B, N, D, H, timed): CLIP-L bucket 16 and ViT-B/32 first, then head
#: dims 16 and 32, N around the 128-row tiles (1, 127, 128, 129, 255), one
#: image and three.
CASES = (
    (64, 577, 1024, 16, True), (64, 50, 768, 12, True),
    (3, 129, 128, 8, False), (2, 577, 256, 8, False), (1, 1, 128, 2, False),
    (3, 127, 256, 4, False), (2, 128, 128, 2, False), (1, 255, 384, 12, False),
)


def _ptxas():
    """ptxas's registers and spills of each f32-kind kernel (by its mangled
    name) and any warning that it serialised wgmma (C75xx)."""
    for name in ("clip_flash", "clip_flash_proj"):
        lines = _build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and ("f32_sm90" in line or "split_kv" in line
                                              or "gemm_sm90ILi3E" in line):
                kernel = re.search(r"'(\w+)'", line).group(1)
                for follow in lines[i:i + 5]:
                    if "registers" in follow or "spill" in follow:
                        cs.log(f"ptxas {name} {kernel}: "
                               f"{follow.split(':', 1)[-1].strip()}")
            if "C75" in line:
                cs.log(f"ptxas {name}: {line.strip()}")


def main():
    from geoguessr_ai_torch.ops import clip_attention as ca

    cs.phase_device()
    secs = _build.build(("clip_flash", "clip_flash_proj"))
    cs.log(f"build_seconds {secs:.2f}")
    _ptxas()
    gen = torch.Generator().manual_seed(cs.SEED + 26)
    for B, N, D, H, timed in CASES:
        args, lib = cs._clip_f32_inputs(B, N, D, H, gen)
        for kernel in ("K6", "K11"):
            kern, plain, kargs, yard = cs._clip_f32_case(kernel, args, lib)
            label = f"{kernel} f32 {(B, N, 3 * D)} H={H}"
            got = kern(*kargs)
            torch.cuda.synchronize()
            same = torch.equal(got, kern(*kargs))
            core = (cs._core_f32_of_k6(*args) if kernel == "K11" else None)
            want = plain(*kargs)
            err, rel = cs._rel_err(got, want)
            ok = rel <= cs.F32_REL_TOL and bool(torch.isfinite(got).all())
            line = (f"{label}: max_abs_err {err:.6g} max_rel_err {rel:.6g} "
                    f"bitwise over two calls {same}")
            if core is not None:
                core_same = torch.equal(got, core)
                line += f", bitwise the core on split(K6) {core_same}"
                same = same and core_same
            cs.log(line)
            if not (ok and same):
                cs.fail(f"{label}: f32 entry disagrees with its plain "
                        f"version, between calls or with the core")
            del got, want, core
            if timed:
                ms = cs.kernel_ms(lambda: kern(*kargs))
                bound, by = cs._clip_bound_ms(kernel, B, N, D, H, 4)
                yms, what = yard()
                cs.log(f"  ms {ms:.4f} (device time), bound_ms {bound:.4f} "
                       f"({by}), yardstick {what} {yms:.4f}")
                cs._log_launch_ms(cs._launch_ms(lambda: kern(*kargs)))
        del args, lib
        torch.cuda.empty_cache()
    cs.log("clip_f32_check: ok")


if __name__ == "__main__":
    main()
