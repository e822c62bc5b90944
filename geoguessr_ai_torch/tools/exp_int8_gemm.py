"""Does the card's int8 tensor-core path run at twice its bf16 rate?

    python -m geoguessr_ai_torch.tools.exp_int8_gemm [--reps 5]

The port of tools/exp_int8_pallas.py.  At the tool's four (M, K, N) shapes
(two square deep-K products and TinyViT's stage-2 MLP GEMMs at 131072
tokens) it runs the tool's chain of R=16 products accumulated into one
resident sum, in bf16 (f32 sum) and in int8 (int32 sum), through the
hand-written tiled GEMM (K13, ``ops.experimental.tiled_gemm``) and through
the library call (``torch.matmul`` / ``torch._int_mm``).  It prints one
JSON line per case with its mean ms and TOPS (2 M K N R operations over
the time), then one line per shape with the int8/bf16 rate ratio of K13
and of the library, and the card's name and power limit first and last.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from geoguessr_ai_torch.ops.experimental.tiled_gemm import tiled_matmul

#: (M, K, N), as the JAX tool has them.
SHAPES = (
    (4096, 2048, 4096),
    (4096, 4096, 4096),
    (131072, 384, 1536),
    (131072, 1536, 384),
)
#: Products in one chain.
R = 16


def log(**kw):
    print(json.dumps(kw), flush=True)


def chain(mm, a, bs, acc_dtype):
    """sum over r of mm(a, bs[r]), accumulated in acc_dtype."""
    acc = torch.zeros((a.shape[0], bs.shape[2]), dtype=acc_dtype,
                      device=a.device)
    for b in bs:
        acc += mm(a, b)
    return acc


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    mms = {
        "k13_bf16": (lambda a, b: tiled_matmul(a, b, torch.float32),
                     torch.float32),
        "k13_int8": (lambda a, b: tiled_matmul(a, b, torch.int32),
                     torch.int32),
        "lib_bf16": (torch.matmul, torch.float32),
        "lib_int8": (torch._int_mm, torch.int32),
    }
    for M, K, N in SHAPES:
        ops = 2 * M * K * N * R
        ab = torch.from_numpy(rng.normal(0, 1, (M, K))).to(dev, torch.bfloat16)
        bbs = torch.from_numpy(rng.normal(0, 1, (R, K, N))).to(
            dev, torch.bfloat16)
        a8 = torch.from_numpy(rng.integers(-127, 127, (M, K),
                                           dtype=np.int8)).to(dev)
        b8s = torch.from_numpy(rng.integers(-127, 127, (R, K, N),
                                            dtype=np.int8)).to(dev)
        tops = {}
        for name, (mm, acc_dtype) in mms.items():
            a, bs = (a8, b8s) if name.endswith("int8") else (ab, bbs)
            ms = time_ms(lambda: chain(mm, a, bs, acc_dtype), args.reps)
            tops[name] = ops / (ms * 1e-3) / 1e12
            log(probe=f"{name}_M{M}_K{K}_N{N}", ms=ms, tops=tops[name])
        log(shape=[M, K, N],
            k13_int8_over_bf16=tops["k13_int8"] / tops["k13_bf16"],
            lib_int8_over_bf16=tops["lib_int8"] / tops["lib_bf16"])
        del ab, bbs, a8, b8s
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
