#!/usr/bin/env python3
"""The f32 readings of the kernel rows of PERF.md §6 that ``chip_smoke.py``
does not time in f32: K4 at the three TinyViT-5M-224 shapes, K8a at stage
3 of a serving bucket of 1, K9 and K10 at a serving bucket of 16 (64
images).  Each f32 entry is held against its
plain f32 version (max |err| / max |ref| <= 1e-3, as phase 24) and timed as
device time beside one PyTorch call of the same function where there is
one (SDPA's forward, or its backward for K4), all on the card.

    python3 scripts/f32_rows.py

Prints the card's name and power limit, one line a row, then a JSON
object of the rows.  Needs a GPU.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: (row, kernel, the shape _f32_case takes)
ROWS = (
    ("K4 5M-224 stage 1", "K4", (1024, 49, 4)),
    ("K4 5M-224 stage 2", "K4", (64, 196, 5)),
    ("K4 5M-224 stage 3", "K4", (64, 49, 10)),
    ("K8a stage 3 bucket 1", "K8a", (4, 18, 256)),
    ("K9 bucket 16", "K9", (64,)),
    ("K10 bucket 16", "K10", (64,)),
)


def main():
    card = cs.phase_device()
    cs.phase_build()
    gen = torch.Generator().manual_seed(cs.SEED + 22)
    rows = {}
    for label, kernel, shape in ROWS:
        kern, plain, args, bound, bound_by, lib = cs._f32_case(kernel, shape,
                                                               gen)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        errs = [cs._rel_err(a, b) for a, b in pairs]
        rel = max(e[1] for e in errs)
        if rel > cs.F32_REL_TOL:
            cs.fail(f"{label}: f32 kernel disagrees with its plain f32 "
                    f"version (rel {rel:.3g})")
        del got, want
        ms = cs.kernel_ms(lambda: kern(*args))
        lib_ms, lib_what = (None, "") if lib is None else lib()
        rows[label] = dict(ms=ms, library_ms=lib_ms, library=lib_what,
                           bound_ms=bound, bound_by=bound_by,
                           max_rel_err=rel)
        print(f"{label} f32: max_rel_err {rel:.6g}, ms {ms:.4f}, library_ms "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"({lib_what}), bound_ms {bound:.4f} ({bound_by})", flush=True)
        del args
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
