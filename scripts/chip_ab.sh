#!/bin/bash
# Times the bf16 kernels, the TinyViT engine and the CLIP engine of two
# trees on one GPU, in turns PARENT, THIS, THIS, PARENT, through
# chip_smoke.py's own phases (kernels vs plain versions with their times;
# the default B=16 train_step p50 of phase 8 and the K5 and K7 step p50s
# of phase 18; the guess paths' p50s), and K6 and K11 at CLIP
# ViT-L/14-336's bucket 16 by one timer for both trees (below):
#
#     git archive <parent-commit> | (mkdir -p build/ab_parent && tar -x -C build/ab_parent)
#     bash scripts/chip_ab.sh build/ab_parent
#
# PARENT must be a directory that .gitignore lists (build/ does).  Each
# run's whole output goes to $AB_OUT/ab_<run>.log (default build/ab_logs);
# the kernel times and p50s of each are printed.  AB_PHASES=serve runs
# only the two engines' serving phases (their p50s, which the host's noise
# moves most), in the same turns.
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

cs.phase_device(); cs.phase_build()
if os.environ.get("AB_PHASES") == "serve":
    cs.phase_serve(); cs.phase_clip_serve()
    sys.exit(0)
cs.phase_kernels(); cs.phase_backward_kernels(); cs.phase_clip_kernels()
cs.phase_embed_kernels(); cs.phase_headmajor_kernels()
cs.phase_train(); cs.phase_k7_train(); cs.phase_serve()
cs.phase_clip_serve()

# K6 and K11 at CLIP-L bucket 16 by the same two timers in either tree:
# 20 launches between two events, and 20 launches captured in one CUDA
# graph replayed 5 times (device time only).
from geoguessr_ai_torch.ops import clip_attention as ca


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
PY
  ) > "$out/ab_$2.log" 2>&1
  echo "== $2 rc=$?"
  grep -E "^K[0-9]+[ab]? |kernel_ms|launch_ms|train_step p50|^bucket|^CLIP bucket|^CLIP pallas|^AB |FAIL" \
    "$out/ab_$2.log"
}
run "$parent" parent1
run . change1
run . change2
run "$parent" parent2
