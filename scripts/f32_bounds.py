#!/usr/bin/env python3
"""The least time (ms) of the kernel rows of PERF.md §6 that show only a
bf16 bound, in bf16 and in f32, from ``chip_smoke.py``'s bound formulas
(each input read once, each output written once, at 3.35 TB/s; products
at the 989 TFLOP/s bf16 or 495 TFLOP/s TF32 peak).  Arithmetic on the
shapes: it needs no card.

    python3 scripts/f32_bounds.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

#: (row, bound function, its shape arguments)
ROWS = (
    ("K4 5M-224 stage 1, real N=49", cs._bwd_bound_ms, ("K4", 1024, 49, 4)),
    ("K4 5M-224 stage 1, padded N=64", cs._bwd_bound_ms, ("K4", 1024, 64, 4)),
    ("K4 5M-224 stage 2, real N=196", cs._bwd_bound_ms, ("K4", 64, 196, 5)),
    ("K4 5M-224 stage 2, padded N=256", cs._bwd_bound_ms, ("K4", 64, 256, 5)),
    ("K4 5M-224 stage 3, real N=49", cs._bwd_bound_ms, ("K4", 64, 49, 10)),
    ("K4 5M-224 stage 3, padded N=64", cs._bwd_bound_ms, ("K4", 64, 64, 10)),
    ("K6 N=50", cs._clip_bound_ms, ("K6", 64, 50, 768, 12)),
    ("K11 N=50", cs._clip_bound_ms, ("K11", 64, 50, 768, 12)),
    ("K9 bucket 16 (K1's shape)", cs._bound_ms, ("K1", 1024, 256, 192, 6)),
    ("K10 bucket 16", cs._mbconv_bound_ms, (64,)),
    ("K8a stage 3 bucket 1", cs._headmajor_bound_ms, (4, 18, 256)),
)


def main():
    for label, fn, args in ROWS:
        (b16, by16), (b32, by32) = fn(*args, elem=2), fn(*args, elem=4)
        print(f"{label}: bf16 {b16:.4f} ms ({by16}), f32 {b32:.4f} ms "
              f"({by32})")


if __name__ == "__main__":
    main()
