#!/bin/bash
# Times the bf16 kernels, the TinyViT engines and the CLIP engine of two
# trees on one GPU, in turns PARENT, THIS, THIS, PARENT, through
# chip_smoke.py's own phases (kernels vs plain versions with their times;
# the default B=16 train_step p50 of phase 8 and the K5 and K7 step p50s
# of phase 18; the guess paths' p50s, the head-major engine's too), and
# by one timer for both trees (below) K6 and K11 at CLIP ViT-L/14-336's
# bucket 16, K5 at the B=16 train shape of stage 2, K8b at the head-major
# serving shapes of stages 1 and 3 at bucket 16, K8a at stage 2 of bucket
# 16 and stage 3 of bucket 1, and K3 at stage 3 of bucket 16, each K8a and
# K3 shape with its exponentials' floor on a line of its own (one
# exponential a score at 16 a clock an SM, at the card's clocks.max.sm),
# and a hash of K8b's output on seeded inputs (equal in both trees when
# its bits did not change); K10 (the fused stage-0 MBConv) at 64 and 512
# images by events with a hash of its output at 64 images on a fixed seed,
# K12a and K12b (the experimental fused MBConv) at 64 and 256 images by
# events beside the cuDNN chain of the same function, and K2 (the stage-2
# no-proj fused block) at bucket 16 as
# device time (each launch's device time: phase 3's launch_ms lines, K1's
# too; K9's in phase 13's); K13 (the int8 / bf16 tiled GEMM) at the JAX
# tool's four shapes as device time with its int8 / bf16 rate; and
# the embed phase (Embedder p50 at B=512 with both knobs on and off) and
# the knob-serve phase (bucket-16 p50 of the engine with fused_mbconv and
# fused_block_4d):
#
#     git archive <parent-commit> | (mkdir -p build/ab_parent && tar -x -C build/ab_parent)
#     bash scripts/chip_ab.sh build/ab_parent
#
# PARENT must be a directory that .gitignore lists (build/ does).  Each
# run's whole output goes to $AB_OUT/ab_<run>.log (default build/ab_logs);
# the kernel times and p50s of each are printed.  AB_PHASES=serve runs
# only the two engines' serving phases (their p50s, which the host's noise
# moves most), in the same turns; AB_PHASES=mbconv only the K10 and K12
# lines; AB_PHASES=fusion only the hierarchical engine's fusion beside
# mean fusion (fusion_ab below).
set -u
parent=${1:?usage: chip_ab.sh PARENT_DIR}
out=$(pwd)/${AB_OUT:-build/ab_logs}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  (cd "$1" && python - <<'PY'
import os
import sys

import torch

import chip_smoke as cs



def sha(t):
    import hashlib
    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def mbconv_ab():
    """K10 at 64 and 512 images by events, with a hash of its output at 64
    images on a fixed seed (equal in both trees when its bits did not
    change); K12a and K12b at 64 and 256 images of the JAX benchmark's
    inputs by events, with the cuDNN chain of the same function."""
    from geoguessr_ai_torch.ops import mbconv
    from geoguessr_ai_torch.ops.experimental import fused_mbconv as fm

    gen = torch.Generator().manual_seed(5)
    for images in (64, 512):
        margs = cs._mbconv_inputs(images, gen)
        fn = lambda: mbconv._mbconv_cuda(*margs, False)
        print(f"AB K10 {images} images events_ms {cs.cuda_time_ms(fn):.4f}")
        if images == 64:
            out = fn()
            torch.cuda.synchronize()
            print(f"AB K10 bits 64 images {sha(out)}")
            del out
        del margs
    gen = torch.Generator().manual_seed(6)
    for images in (64, 256):
        args = cs._exp_mbconv_inputs(images, gen)
        with torch.inference_mode():
            ms = {k: cs.cuda_time_ms(lambda: fm._fused_mbconv_cuda(*args, v2=v2))
                  for k, v2 in (("K12a", False), ("K12b", True))}
            ms["K12 cuDNN chain"] = cs._exp_chain_ms(args)
        for k, t in ms.items():
            print(f"AB {k} {images} images events_ms {t:.4f}")
        del args
        torch.cuda.empty_cache()


def fusion_ab():
    """The hierarchical engine (D = 576, 16 heads) beside the mean-fusion
    engine at full width: predict_batch p50s at buckets 1 and 16, the two
    engines in turns (40 calls each after a warm-up); the fusion alone
    (pos_encoder + self_attn on (16, 4, 576) f32 with a mask) as host ms
    a call to its end and as events; and how long the fusion takes to
    return to the host behind a queued 50 ms kernel (about 50 when it
    waits for the card, under 1 when it only queues its launches)."""
    import time

    import numpy as np

    from geoguessr_ai_torch.serving.engine import ServingEngine

    hier = ServingEngine(seed=cs.SEED, hierarchical=True)
    mean = ServingEngine(seed=cs.SEED)
    views = np.random.default_rng(0).integers(0, 256, (4, 512, 512, 3),
                                              dtype=np.uint8)
    for bucket in (1, 16):
        b = np.repeat(views[None], bucket, axis=0)
        times = {"hierarchical": [], "mean": []}
        for eng in (hier, mean):
            eng.predict_batch(b)
        for _ in range(40):
            for label, eng in (("hierarchical", hier), ("mean", mean)):
                t0 = time.perf_counter()
                eng.predict_batch(b)
                times[label].append((time.perf_counter() - t0) * 1e3)
        h, m = (float(np.median(times[k])) for k in ("hierarchical", "mean"))
        print(f"AB fusion bucket {bucket} p50 hierarchical {h:.4f} mean "
              f"{m:.4f} difference {h - m:.4f} ms")
    model = hier.model
    x = torch.randn(16, 4, 576,
                    generator=torch.Generator().manual_seed(1)).cuda()
    mask = torch.ones(16, 4, dtype=torch.bool, device="cuda")
    mask[1::2, 2:] = False
    fuse = lambda: model.self_attn(model.pos_encoder(x), mask)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    cycles_50ms = int(10 ** 7 * 50 / start.elapsed_time(end))
    with torch.inference_mode():
        fuse()
        torch.cuda.synchronize()
        host = []
        for _ in range(50):
            t0 = time.perf_counter()
            fuse()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        events = cs.cuda_time_ms(fuse, iters=50)
        torch.cuda._sleep(cycles_50ms)
        t0 = time.perf_counter()
        fuse()
        behind = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print(f"AB fusion alone (16, 4, 576) host_ms {np.median(host):.4f} "
          f"events_ms {events:.4f}; returns behind a queued 50 ms kernel "
          f"in {behind:.3f} ms")


cs.phase_device(); cs.phase_build()
if os.environ.get("AB_PHASES") == "fusion":
    fusion_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "mbconv":
    mbconv_ab()
    sys.exit(0)
if os.environ.get("AB_PHASES") == "serve":
    _, paths, result, _ = cs.phase_serve()
    cs.phase_headmajor_serve(paths, result); cs.phase_clip_serve()
    sys.exit(0)
cs.phase_kernels(); cs.phase_backward_kernels(); cs.phase_clip_kernels()
cs.phase_embed_kernels(); cs.phase_headmajor_kernels()
cs.phase_train(); cs.phase_k7_train()
_, paths, result, _ = cs.phase_serve()
cs.phase_headmajor_serve(paths, result)
cs.phase_clip_serve()
cs.phase_embed(paths)
cs.phase_knob_serve(paths, result)

# K6 and K11 at CLIP-L bucket 16, K5 and K8b at their main shapes, by
# the same two timers in either tree: 20 launches between two events, and
# 20 launches captured in one CUDA graph replayed 5 times (device time
# only).
from geoguessr_ai_torch.ops import clip_attention as ca
from geoguessr_ai_torch.ops import window_attention as wa


def graph_ms(fn, iters=20, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


gen = torch.Generator().manual_seed(3)
qkv = torch.randn(64, 577, 3072, generator=gen).to("cuda", torch.bfloat16)
w = (torch.randn(1024, 1024, generator=gen) / 32).to("cuda", torch.bfloat16)
for name, fn in (("K6", lambda: ca._flash_cuda(qkv, 0.125, 16)),
                 ("K11", lambda: ca._flash_proj_cuda(qkv, w, 0.125, 16))):
    print(f"AB {name} (64, 577, 3072) H=16 events_ms "
          f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
del qkv, w
# K13 at the JAX tool's four (M, K, N), b handed over K-major as the
# kernel reads it (so neither tree's time holds the wrapper's transpose copy
# of a (K, N) b), as device time; its int8 / bf16 rate at each
from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg
for M, K, N in ((4096, 2048, 4096), (4096, 4096, 4096), (131072, 384, 1536),
                (131072, 1536, 384)):
    rates = {}
    for kind in ("int8", "bf16"):
        if kind == "int8":
            a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).cuda()
            b = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).cuda()
            out = torch.int32
        else:
            a = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
            b = torch.randn(K, N, generator=gen).to("cuda", torch.bfloat16)
            out = torch.float32
        bk = b.t().contiguous().t()
        fn = lambda: tg._tiled_matmul_cuda(a, bk, out)
        ms = graph_ms(fn)
        rates[kind] = 2 * M * K * N / ms / 1e9
        print(f"AB K13 {kind} ({M}, {K}, {N}) graph_ms {ms:.4f} "
              f"({rates[kind]:.1f} TOPS); from a (K, N) b events_ms "
              f"{cs.cuda_time_ms(lambda: tg._tiled_matmul_cuda(a, b, out), iters=20):.4f}")
        del a, b, bk
        torch.cuda.empty_cache()
    print(f"AB K13 int8 / bf16 rate ({M}, {K}, {N}) "
          f"{rates['int8'] / rates['bf16']:.3f}")
bq = torch.randn(64, 1024, 1152, generator=gen).to("cuda", torch.bfloat16)
bb = (torch.randn(12, 1024, 1024, generator=gen) * 0.5).to("cuda")
bg = torch.randn(64, 1024, 384, generator=gen).to("cuda", torch.bfloat16)
fn = lambda: wa._attention_bwd_merged_cuda(bq, bb, bg, 32 ** -0.5, 12)
print(f"AB K5 (64, 1024) H=12 events_ms {cs.cuda_time_ms(fn, iters=20):.4f} "
      f"graph_ms {graph_ms(fn):.4f}")
del bq, bb, bg
for W, H in ((1024, 6), (64, 18)):
    q, k, v = (torch.randn(W, H, 256, 32, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(3))
    hb = (torch.randn(H, 256, 256, generator=gen) * 0.5).to("cuda")
    fn = lambda: wa._attention_batched_cuda(q, k, v, hb, 32 ** -0.5)
    print(f"AB K8b ({W}, {H}, 256) events_ms "
          f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
    out = fn()
    torch.cuda.synchronize()
    del q, k, v, hb, out

mbconv_ab()
gen = torch.Generator().manual_seed(5)
a = cs._case_inputs(64, 1024, 384, 12, gen)
k2 = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"], a["bias"],
      32 ** -0.5, 12, 1e-5)
fn = lambda: wa._fb_s2_cuda(*k2)
# each launch's device time: phase 3's "K2 stage2 launch_ms" line (a trace
# taken this late in the process held one of its three calls)
print(f"AB K2 (64, 1024, 384) H=12 graph_ms {graph_ms(fn):.4f}")
del a, k2

import subprocess

import numpy as np

mhz = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
    capture_output=True, text=True).stdout.split()[0])
sms = torch.cuda.get_device_properties(0).multi_processor_count


def floor_line(name, shape, scores):
    print(f"AB exp_floor {name} {shape} {scores / (16 * sms * mhz * 1e6) * 1e3:.4f} ms "
          f"({scores:.3g} exponentials, 16 a clock an SM at {mhz:.0f} MHz)")


for W, H, N in ((64, 12, 1024), (4, 18, 256)):
    q, k, v = (torch.randn(W, H, N, 32, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(3))
    hb = (torch.randn(H, N, N, generator=gen) * 0.5).to("cuda")
    fn = lambda: wa._attention_qtiled_cuda(q, k, v, hb, 32 ** -0.5)
    print(f"AB K8a ({W}, {H}, {N}) events_ms "
          f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
    floor_line("K8a", (W, H, N), W * H * N * N)
    del q, k, v, hb
qkv = torch.randn(64, 256, 1728, generator=gen).to("cuda", torch.bfloat16)
b3 = (torch.randn(18, 256, 256, generator=gen) * 0.5).to("cuda", torch.bfloat16)
fn = lambda: wa._attention_qkv_fused_cuda(qkv, b3, 32 ** -0.5, 18)
print(f"AB K3 (64, 256, 1728) H=18 events_ms "
      f"{cs.cuda_time_ms(fn, iters=20):.4f} graph_ms {graph_ms(fn):.4f}")
floor_line("K3", (64, 256, 1728), 64 * 18 * 256 * 256)
for W, H, N in ((1024, 6, 256), (64, 18, 256)):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((W, H, N, 32), dtype=np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    hb = torch.from_numpy(rng.standard_normal((H, N, N), dtype=np.float32) * 0.5).to("cuda")
    out = wa._attention_batched_cuda(q, k, v, hb, 32 ** -0.5)
    torch.cuda.synchronize()
    print(f"AB K8b bits ({W}, {H}, {N}) {sha(out)}")
PY
  ) > "$out/ab_$2.log" 2>&1
  echo "== $2 rc=$?"
  grep -E "^K[0-9]+[ab]? |kernel_ms|library_ms|launch_ms|train_step p50|^bucket|^head-major engine bucket|^CLIP bucket|^CLIP pallas|^AB |^Embedder|^knob engine bucket|FAIL" \
    "$out/ab_$2.log"
}
run "$parent" parent1
run . change1
run . change2
run "$parent" parent2
# K10's bf16 kernels (mbconv_sm90<C, EXACT[, PLAIN = false]>) in both trees'
# libraries, instruction by instruction (cuobjdump's SASS without the
# addresses): "identical True" when the change compiled K10 to the same code
python3 - "$parent" <<'PY'
import glob
import re
import subprocess
import sys


def kernels(tree):
    lib = glob.glob(f"{tree}/build/kernels/mbconv-*.so")[0]
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                          capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        m = re.search(r"mbconv_sm90ILi(\d+)ELb([01])E(?:Lb0E)?E", name)
        if m:
            out[m.groups()] = [re.sub(r"/\*[0-9a-f]+\*/", "", l).split(";")[0].strip()
                               for l in body.splitlines() if re.match(r"\s*/\*[0-9a-f]+\*/", l)]
    return out


old, new = kernels(sys.argv[1]), kernels(".")
for key in sorted(old):
    print(f"AB K10 SASS C={key[0]} exact={key[1]}: {len(old[key])} / "
          f"{len(new.get(key, []))} instructions, identical {old[key] == new.get(key)}")
PY
