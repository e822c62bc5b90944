"""Ablations of the Hopper GEMM core (``csrc/gemm_sm90.cuh``) as K13 and
K11 run it, timed against the core as it stands, on one GPU.

Each variant is a copy of ``csrc/`` under ``build/variants/<name>/`` with
``gemm_sm90.cuh`` patched to one alternative of its design (no cluster
sharing each bt box by TMA multicast, 128-column tiles, a shallower ring,
the two consumer warpgroups splitting a tile's columns instead of its
rows),
built with ``nvcc`` (all at once) into its own ``tiled_gemm`` and
``clip_flash_proj`` libraries.  For each it prints K13's device time
(``chip_smoke.kernel_ms``, b K-major as the kernel reads it) in int8 and
bf16 at (4096, 4096, 4096) and at the tool's first MLP shape (131072,
384, 1536), and K11's at CLIP-L bucket
16 (64, 577, 3072) with its projection launch's device time
(torch.profiler, ``chip_smoke._launch_ms``); every variant's results are
checked against the core's own (int8 exactly; bf16 within
chip_smoke.KERNEL_REL_TOL), so a variant that breaks the product fails,
except the ablations (ABLATIONS), which remove one piece of the core's
work (its stores, its products, its loads) to say what that piece costs.

    python3 scripts/gemm_sm90_variants.py [VARIANT ...]
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
from geoguessr_ai_torch.ops import clip_attention as ca  # noqa: E402
from geoguessr_ai_torch.ops.experimental import tiled_gemm as tg  # noqa: E402

_STAGES = "constexpr int kMaxStages = 8;"
_TILE = ("  p->BN = Nout % 256 == 0 ? 256 : 128;", "  p->BN = 128;")
_STAGE = ("    stage_products<BN>(d, desc<64>(sm.a(at.slot) + a_off), "
          "desc<64>(sm.b(at.slot)));")
_PRODUCTS = "  for (int kk = 0; kk < 4; ++kk) mma<NW>(d, da + 2 * kk, db + 2 * kk);"
_EPILOGUE = ("    epilogue<KIND, BN>(d, sm, &c_map, m * kRows + 64 * c, n * BN, c, "
             "warp, g, cc);")
_KERNEL = "template <int KIND, int BN>\n__global__"
# each group takes all 128 rows of the tile against half its columns: two
# m64n{BN/2} products a k-step, on the two 64-row halves of its
# accumulators, and two epilogues
_SPLIT_COLS_CODE = """template <int BN, class Acc>
__device__ __forceinline__ Acc (&half(Acc (&d)[BN / 2], int h))[BN / 4] {
  return *reinterpret_cast<Acc(*)[BN / 4]>(d + h * (BN / 4));
}
template <int BN, class Acc>
__device__ __forceinline__ void split_products(Acc (&d)[BN / 2], uint64_t da, uint64_t db) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) mma<BN / 2>(half<BN>(d, h), da + ((h * 64 * kBoxBytes) >> 4) + 2 * kk, db + 2 * kk);
  wgmma_commit();
}

"""
# 256-column tiles only, which every case below takes: at 128 a group's 64
# columns would need an m64n64 product and one staging box a round, so the
# 128-column instance (still built, for tiled_gemm_plan) does nothing
_SPLIT_COLS = [
    (_KERNEL, _SPLIT_COLS_CODE + _KERNEL),
    (_STAGE, "    if constexpr (BN == 256) split_products<BN>(d, "
             "desc<64>(sm.a(at.slot)), desc<64>(sm.b(at.slot) + c * (BN / 2) "
             "* kBoxBytes));"),
    (_EPILOGUE, "    if constexpr (BN == 256) {\n" + "".join(
        f"      epilogue<KIND, BN / 2>(half<BN>(d, {h}), sm, &c_map, "
        f"m * kRows + {64 * h}, n * BN + c * (BN / 2), c, warp, g, cc);\n"
        for h in (0, 1)) + "    }"),
    ("  return p.BN == 256 ? launch<KIND, 256>(maps, p, sms, stream) : "
     "launch<KIND, 128>(maps, p, sms, stream);",
     "  return launch<KIND, 256>(maps, p, sms, stream);"),
]

#: name -> edits of gemm_sm90.cuh as (old, new).
VARIANTS = {
    # no cluster (clusters of one): each CTA loads its whole bt box itself
    "cluster_1": [
        ("constexpr int kCluster = 2;", "constexpr int kCluster = 1;"),
        ("""          tma_load_multicast(sm.b(pos.slot) + rank * kHalfB * kBoxBytes, &b_map, sm.full(pos.slot),
                             b * kBoxElems, n * BN + rank * kHalfB, 0, (1 << kCluster) - 1);""",
         "          tma_load(sm.b(pos.slot), &b_map, sm.full(pos.slot), "
         "b * kBoxElems, n * BN, 0);")],
    "tile_128": [_TILE],
    "tile_128_stages_4": [_TILE, (_STAGES, "constexpr int kMaxStages = 4;")],
    "stages_3": [(_STAGES, "constexpr int kMaxStages = 3;")],
    "stages_2": [(_STAGES, "constexpr int kMaxStages = 2;")],
    "split_cols": _SPLIT_COLS,
    # ablations: each removes one piece of the core's work and gives wrong
    # results; it only says what that piece costs
    # the epilogue's TMA stores
    "no_stores": [("store_tile_tma(leader, c_map,",
                   "store_tile_tma(false, c_map,")],
    # the products (the stages still land and are released)
    "no_products": [(_PRODUCTS, "  for (int kk = 0; kk < 4; ++kk) "
                     "asm volatile(\"\" :: \"l\"(da), \"l\"(db));")],
    # the loads (each stage's full barrier completed by a plain arrival)
    "no_loads": [("""          mbar_expect_tx(sm.full(pos.slot), p.stage_bytes());
          tma_load(sm.a(pos.slot), &a_map, sm.full(pos.slot), b * kBoxElems, m * kRows, 0);
          tma_load_multicast(sm.b(pos.slot) + rank * kHalfB * kBoxBytes, &b_map, sm.full(pos.slot),
                             b * kBoxElems, n * BN + rank * kHalfB, 0, (1 << kCluster) - 1);""",
                  """          mbar_arrive(sm.full(pos.slot));""")],
}
_NO_LOADS = VARIANTS["no_loads"]
# the products alone, probed: one consumer group issuing them, no box in
# flight while the next is issued, each box's products issued twice
VARIANTS["no_loads_one_group"] = _NO_LOADS + [
    (_STAGE, "    if (c == 0)\n" + _STAGE)]
VARIANTS["no_loads_wait0"] = _NO_LOADS + [("      wgmma_wait<1>();",
                                           "      wgmma_wait<0>();")]
VARIANTS["no_loads_twice"] = _NO_LOADS + [
    (_PRODUCTS, "  for (int kk = 0; kk < 8; ++kk) "
     "mma<NW>(d, da + 2 * (kk & 3), db + 2 * (kk & 3));")]
#: The ablations, whose results are not checked.
ABLATIONS = ("no_stores", "no_products", "no_loads", "no_loads_one_group",
             "no_loads_wait0", "no_loads_twice")
LIBS = ("tiled_gemm", "clip_flash_proj")


def build_variants(out_dir):
    """Every variant's two libraries, built at once; returns {name: {lib:
    path}}."""
    procs = []
    for name, edits in VARIANTS.items():
        src = os.path.join(out_dir, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        header = os.path.join(src, "gemm_sm90.cuh")
        text = open(header).read()
        for old, new in edits:
            if old not in text:
                sys.exit(f"{name}: the edit's anchor is not in gemm_sm90.cuh")
            text = text.replace(old, new)
        open(header, "w").write(text)
        for lib in LIBS:
            path = os.path.join(out_dir, f"{name}-{lib}.so")
            procs.append((name, lib, path, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path,
                 os.path.join(src, f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, lib, path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name} {lib}: nvcc failed\n{log[-3000:]}")
        built.setdefault(name, {})[lib] = path
    return built


_REAL_LIBRARY = _build.library


def _use(paths):
    """Points ``_build.library`` at the variant's libraries (None: the
    core's own)."""
    if paths is None:
        _build.library = _REAL_LIBRARY
        return
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn, argtypes in _build.SIGNATURES[name].items():
            entry = getattr(lib, fn)
            entry.argtypes = list(argtypes)
            entry.restype = ctypes.c_int
        libs[name] = lib
    _build.library = lambda name: libs[name] if name in libs else _REAL_LIBRARY(name)


def main(argv=None):
    only = set((argv if argv is not None else sys.argv[1:]))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.build(LIBS + ("clip_flash",))
    if only:  # a subset of the variants, by name
        for name in set(VARIANTS) - only:
            del VARIANTS[name]
    built = build_variants(os.path.join(ROOT, "build", "variants"))
    gen = torch.Generator().manual_seed(0)
    cases = []
    for M, K, N in ((4096, 4096, 4096), (131072, 384, 1536)):
        a8 = torch.randint(-127, 128, (M, K), generator=gen,
                           dtype=torch.int8).cuda()
        b8 = torch.randint(-127, 128, (K, N), generator=gen,
                           dtype=torch.int8).cuda()
        a = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
        b = torch.randn(K, N, generator=gen).to("cuda", torch.bfloat16)
        # b K-major, as the kernel reads it (no transpose copy timed)
        b8, b = b8.t().contiguous().t(), b.t().contiguous().t()
        cases.append((f"K13 int8 ({M}, {K}, {N})", lambda a8=a8, b8=b8:
                      tg._tiled_matmul_cuda(a8, b8, torch.int32), True))
        cases.append((f"K13 bf16 ({M}, {K}, {N})", lambda a=a, b=b:
                      tg._tiled_matmul_cuda(a, b, torch.float32), False))
    qkv = torch.randn(64, 577, 3072, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(1024, 1024, generator=gen) / 32).to("cuda", torch.bfloat16)
    k11 = lambda: ca._flash_proj_cuda(qkv, w, 0.125, 16)  # noqa: E731
    cases.append(("K11 (64, 577, 3072)", k11, False))
    want = {label: fn() for label, fn, _ in cases}
    torch.cuda.synchronize()
    for name, paths in [("core", None)] + list(built.items()):
        _use(paths)
        parts = []
        for label, fn, exact in cases:
            got = fn()
            torch.cuda.synchronize()
            ok = (torch.equal(got, want[label]) if exact else
                  cs._rel_err(got, want[label])[1] <= cs.KERNEL_REL_TOL)
            if not ok and name not in ABLATIONS:
                sys.exit(f"variant {name}: {label} disagrees with the core")
            parts.append(f"{label} {cs.kernel_ms(fn):.4f}")
        proj = (cs._launch_ms(k11) or {}).get("proj_gemm")
        parts.append("K11 proj_gemm " + (f"{proj:.4f}" if proj else "n/a"))
        print(f"variant {name}: " + ", ".join(parts), flush=True)
    _use(None)
    print(card, flush=True)


if __name__ == "__main__":
    main()
