#!/bin/bash
# Times the bf16 kernels and the TinyViT engine of two trees on one GPU, in
# turns PARENT, THIS, THIS, PARENT, through chip_smoke.py's own phases
# (kernels vs plain versions with their times; the guess path's p50s):
#
#     git archive <parent-commit> | (mkdir -p build/ab_parent && tar -x -C build/ab_parent)
#     bash scripts/chip_ab.sh build/ab_parent
#
# PARENT must be a directory that .gitignore lists (build/ does).  Each
# run's whole output goes to $AB_OUT/ab_<run>.log (default build/ab_logs);
# the kernel times and p50s of each are printed.
set -u
parent=${1:?usage: chip_ab.sh PARENT_DIR}
out=$(pwd)/${AB_OUT:-build/ab_logs}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  (cd "$1" && python -c "
import chip_smoke as cs
cs.phase_device(); cs.phase_build()
cs.phase_kernels(); cs.phase_backward_kernels(); cs.phase_clip_kernels()
cs.phase_embed_kernels(); cs.phase_headmajor_kernels(); cs.phase_serve()
") > "$out/ab_$2.log" 2>&1
  echo "== $2 rc=$?"
  grep -E "^K[0-9]+[ab]? |kernel_ms|^bucket|FAIL" "$out/ab_$2.log" | paste - -
}
run "$parent" parent1
run . change1
run . change2
run "$parent" parent2
