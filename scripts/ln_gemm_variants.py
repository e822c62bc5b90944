"""Ablations of the Hopper LayerNorm + GEMM core (``csrc/ln_gemm_sm90.cuh``)
as K1 runs it, timed against the core as it stands, on one GPU.

Each variant is a copy of ``csrc/`` under ``build/variants/<name>/`` with
one edit of ``ln_gemm_sm90.cuh``, built with ``nvcc`` (all at once) into
its own ``fused_block`` library and called through
``window_attention._fused_block_cuda`` at stage 1 of a serving bucket of 16
(W=1024, N=256, C=192, H=6); each of its launches' device time comes from
torch.profiler (``chip_smoke._launch_ms``).  An ablation removes one piece
of the core's work and gives wrong results: it only says what that piece
costs.

    python3 scripts/ln_gemm_variants.py
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from geoguessr_ai_torch.ops import _build  # noqa: E402
from geoguessr_ai_torch.ops import window_attention as wa  # noqa: E402

#: name -> edits of ln_gemm_sm90.cuh as (old, new).
VARIANTS = {
    # the LayerNorm's work (the rows go to wgmma as they came)
    "no_layer_norm": [("""      layer_norm_group<KB>(tiles + buf * KB * kBoxA, c, gamma, beta, eps);
""", "")],
    # the weight boxes from L2: loaded for a block's first row tile only,
    # the ring's later phases completed by a plain arrival
    "weights_once": [("""              mbar_expect_tx(sm.full(pos.slot), kBoxB);
              tma_load(sm.slot(pos.slot), &w_map, sm.full(pos.slot), b * kBoxK, (ct + i) * kCols, 0);""",
                      """              if (t == (int)blockIdx.x) {
                mbar_expect_tx(sm.full(pos.slot), kBoxB);
                tma_load(sm.slot(pos.slot), &w_map, sm.full(pos.slot), b * kBoxK, (ct + i) * kCols, 0);
              } else {
                mbar_arrive(sm.full(pos.slot));
              }""")],
    # the output's TMA stores
    "no_stores": [("""    if constexpr (OUT_MAP)
      store_tile_tma_5d(leader, y_map, sm.out(c, out ^ i), col0 + 64 * i, WinCoords(p, row0));
    else
      store_tile_tma(leader, y_map, sm.out(c, out ^ i), col0 + 64 * i, row0);""",
                   """    if constexpr (OUT_MAP)
      store_tile_tma_5d(false, y_map, sm.out(c, out ^ i), col0 + 64 * i, WinCoords(p, row0));
    else
      store_tile_tma(false, y_map, sm.out(c, out ^ i), col0 + 64 * i, row0);""")],
    # the products
    "no_wgmma": [("""        wgmma_m64n64k16_ss(d[i], da + (b * kBoxA >> 4) + 2 * kk, bd[i] + 2 * kk);""",
                  """        d[i][kk] += __uint_as_float((uint32_t)(bd[i] >> (8 * kk)));""")],
}


def build_variants(out_dir):
    """Every variant's library, built at once; returns {name: path}."""
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(out_dir, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        header = os.path.join(src, "ln_gemm_sm90.cuh")
        text = open(header).read()
        for old, new in edits:
            if old not in text:
                sys.exit(f"{name}: the edit's anchor is not in ln_gemm_sm90.cuh")
            text = text.replace(old, new)
        open(header, "w").write(text)
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, "fused_block.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc failed\n{log[-3000:]}")
        built[name] = lib
    return built


_REAL_LIBRARY = _build.library


def _use(path):
    """Points ``_build.library`` at the library at path (None: the
    kernel's own)."""
    if path is None:
        _build.library = _REAL_LIBRARY
        return
    lib = ctypes.CDLL(path)
    for fn, argtypes in _build.SIGNATURES["fused_block"].items():
        entry = getattr(lib, fn)
        entry.argtypes = list(argtypes)
        entry.restype = ctypes.c_int
    _build.library = lambda name: lib


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    built = build_variants(os.path.join(ROOT, "build", "variants"))
    gen = torch.Generator().manual_seed(0)
    W, N, C, H = 1024, 256, 192, 6
    a = cs._case_inputs(W, N, C, H, gen)
    args = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
            a["w_proj"], a["b_proj"], a["bias"], (C // H) ** -0.5, H, 1e-5)
    fn = lambda: wa._fused_block_cuda(*args)  # noqa: E731
    for name, lib in [("kernel", None)] + list(built.items()):
        _use(lib)
        fn()
        torch.cuda.synchronize()
        launches = cs._launch_ms(fn) or {}
        print(f"K1 variant {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in launches.items() if "gemm" in k
            or k == "attention"), flush=True)
    _use(None)


if __name__ == "__main__":
    main()
