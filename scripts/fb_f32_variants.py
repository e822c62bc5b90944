"""Variants of the f32 kinds of the LayerNorm + GEMM core and the forward
core (``csrc/ln_gemm_sm90.cuh``, ``csrc/attention_fwd_sm90.cuh``) as K2's
and K9's f32 entries run them, timed against the cores as they stand, on
one GPU.

Each variant is a copy of ``csrc/`` under ``build/variants/<name>/`` with
edits of the two headers, built with ``nvcc`` (all at once) into its own
``fb_s2`` and ``fb4d`` libraries and called through
``window_attention._fb_s2_cuda`` at stage 2 of a serving bucket of 16
(W=64, N=1024, C=384, H=12) and ``_fb4d_cuda`` at 64 images of stage 1
(64 x 64 maps of C=192, 16 x 16 windows, H=6), in f32; each launch's device
time comes from torch.profiler (``chip_smoke._launch_ms``).  A variant
that keeps the arithmetic is held against the plain f32 version; an
ablation (its name starts with ``no_``) removes one piece of the work and
gives wrong results: it only says what that piece costs.

    python3 scripts/fb_f32_variants.py [VARIANT ...]
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

FWD, LNG = "attention_fwd_sm90.cuh", "ln_gemm_sm90.cuh"
#: name -> edits as (header, old, new).
VARIANTS = {
    # one staging tile a consumer group at every K: the qkv GEMM's lo
    # plane waits for the hi plane's store to read it
    "one_stage": [(LNG, "const int options[3][2] = {{2, 2}, {1, 2}, {1, 1}};",
                   "const int options[3][2] = {{2, 1}, {1, 1}, {1, 1}};")],
    # the streamed bias at every N (K9's N = 256 tile resident otherwise)
    "streamed_bias": [(FWD, "  if (fit_ring_f32(p, 2, 2 * p->NT) || "
                            "fit_ring_f32(p, 1, p->NT)) return cudaSuccess;\n",
                       "")],
    # the GEMM's LayerNorm and in-place split of x (the products read the
    # f32 tile's bytes as they landed)
    "no_gemm_split": [(LNG, "    split_tile_f32<KB, KIND>(tiles + buf * kTile, "
                            "gamma, beta, eps);\n", "")],
}


def build_variants(out_dir, names):
    """Every variant's two libraries, built at once; returns {name: {lib:
    path}}."""
    procs = []
    for name in names:
        src = os.path.join(out_dir, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        for header, old, new in VARIANTS[name]:
            path = os.path.join(src, header)
            text = open(path).read()
            if old not in text:
                sys.exit(f"{name}: the edit's anchor is not in {header}")
            open(path, "w").write(text.replace(old, new))
        for lib in ("fb_s2", "fb4d"):
            out = os.path.join(out_dir, f"{name}-{lib}.so")
            procs.append((name, lib, out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                 os.path.join(src, f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, lib, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name} {lib}: nvcc failed\n{log[-3000:]}")
        built.setdefault(name, {})[lib] = out
    return built


_REAL_LIBRARY = _build.library


def _use(paths):
    """Points ``_build.library`` at the variant's libraries (None: the
    cores' own)."""
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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    built = build_variants(os.path.join(ROOT, "build", "variants"), names)
    f32 = torch.float32
    gen = torch.Generator().manual_seed(0)
    a = cs._case_inputs(64, 1024, 384, 12, gen, f32)
    k2 = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
          a["bias"], 32 ** -0.5, 12, 1e-5)
    kern, plain, k9, *_ = cs._embed_kernel_case("K9", 64, gen, f32)
    cases = (("K2", lambda: wa._fb_s2_cuda(*k2), lambda: wa._fb_s2_plain(*k2)),
             ("K9", lambda: kern(*k9), lambda: plain(*k9)))
    want = {label: ref() for label, _, ref in cases}
    for name, libs in [("kernel", None)] + list(built.items()):
        _use(libs)
        for label, fn, _ in cases:
            got = fn()
            torch.cuda.synchronize()
            rel = cs._rel_err(got, want[label])[1]
            del got
            launches = cs._launch_ms(fn) or {}
            print(f"{label} f32 variant {name}: max_rel_err {rel:.3g}, "
                  f"device_ms {cs.device_time_ms(fn):.4f}; " + ", ".join(
                      f"{k} {v:.4f}" for k, v in launches.items()
                      if "gemm" in k or k == "attention"), flush=True)
    _use(None)


if __name__ == "__main__":
    main()
