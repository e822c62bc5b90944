"""Where the device time of the guess path goes.

    python -m geoguessr_ai_torch.profile_forward [--bucket 16] [--steps 5] [--trace PATH]

Builds the full-width ServingEngine (TinyViT-21M-512 bf16, 12647 cells,
seeded random weights) on the GPU, serves the fixture panorama at one
bucket size under ``torch.profiler``, and prints per forward: the host
wall time, the device's busy time and idle share, and the kernels by
device time.  The last line is the same as one JSON object.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

#: Kernel-name substrings -> the port's layer they belong to.
GROUPS = (
    ("window_attention_kernel", "attention (K1/K2/K3 CUDA)"),
    ("ln_gemm_kernel", "LN+GEMM (K1/K2 CUDA)"),
    ("conv", "convolution (cuDNN)"),
    ("gemm", "GEMM (cuBLAS)"),
    ("xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"),
)


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "elementwise, copies and reductions"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bucket", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace to this path")
    args = ap.parse_args(argv)

    from geoguessr_ai_torch.data.pipeline import decode_jpeg
    from geoguessr_ai_torch.inference import fixture_panorama
    from geoguessr_ai_torch.serving.engine import ServingEngine

    engine = ServingEngine(seed=0)  # the GPU; raises without one
    views = np.stack([decode_jpeg(open(p, "rb").read(), engine.image_size)
                      for p in fixture_panorama()])
    batch = np.repeat(views[None], args.bucket, axis=0)
    for _ in range(2):
        engine.predict_batch(batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.predict_batch(batch)  # ends with results on the host
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = collections.defaultdict(lambda: [0, 0.0])  # name -> count, us
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[evt.name]
            k[0] += 1
            k[1] += evt.time_range.elapsed_us()
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    per_fwd = {n: (c / args.steps, us / args.steps / 1e3)
               for n, (c, us) in kernels.items()}
    busy_ms = sum(ms for _, ms in per_fwd.values())
    groups = collections.defaultdict(float)
    for n, (_, ms) in per_fwd.items():
        groups[_group(n)] += ms

    card = torch.cuda.get_device_name(0)
    print(f"{card}: bucket {args.bucket}, {args.steps} forwards profiled")
    print(f"wall_ms_per_forward {wall_ms:.3f}")
    print(f"device_busy_ms_per_forward {busy_ms:.3f}")
    print(f"device_idle_share {1 - busy_ms / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {ms / busy_ms:6.1%}  {g}")
    print("top kernels per forward (launches, ms):")
    top = sorted(per_fwd.items(), key=lambda kv: -kv[1][1])[:15]
    for n, (c, ms) in top:
        print(f"  {ms:9.3f} ms  x{c:5.1f}  {n[:110]}")
    print(json.dumps({
        "device": card, "bucket": args.bucket, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": dict(groups),
    }))


if __name__ == "__main__":
    main()
