"""Variants of the f32 kinds of the LayerNorm + GEMM core and the forward
core (``csrc/ln_gemm_sm90.cuh``, ``csrc/attention_fwd_sm90.cuh``) as K1's,
K2's, K8a's and K9's f32 entries run them, timed against the cores as they
stand, on one GPU.

Each variant is a copy of ``csrc/`` under ``build/variants/<name>/`` with
edits of the two headers, built with ``nvcc`` (all at once) into its own
``fb_s2``, ``fb4d``, ``fused_block`` and ``attention_headmajor`` libraries
and called through ``window_attention._fb_s2_cuda`` at stage 2 of a
serving bucket of 16 (W=64, N=1024, C=384, H=12), ``_fb4d_cuda`` at 64
images of stage 1 (64 x 64 maps of C=192, 16 x 16 windows, H=6),
``_fused_block_cuda`` at stage 1 of a bucket of 16 (W=1024, N=256, C=192,
H=6) and the embed configuration's stage 3 (W=64, N=256, C=576, H=18) and
``_attention_qtiled_cuda`` at stage 2 of a bucket of 16 (W=64, H=12,
N=1024) and stage 3 of a bucket of 1 (W=4, H=18, N=256), in f32; each
launch's device time comes from torch.profiler (``chip_smoke._launch_ms``).
A variant that keeps the arithmetic is held against the plain f32 version;
an ablation (its name starts with ``no_``) removes one piece of the work
and gives wrong results: it only says what that piece costs.  ``ptxas``'s
spill lines of each variant's f32 GEMM projection kind at K = 576 are
printed beside its times.

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
LIBS = ("fb_s2", "fb4d", "fused_block", "attention_headmajor")
#: The split pass as the header walks the planes' rows (its head-major and
#: in-order sources), and walking each (window, head, tensor)'s rows of the
#: head-major source instead (the variant split_slab_order; K8a only).
SPLIT_ROWS = """\
  constexpr int kVec = HD / 4;    // float4 of a head row, uint2 of its planes' rows
  const int row4 = 3 * H * kVec;  // uint2 of a plane row
  const int end = N * row4;       // uint2 of window w in a plane
  const int w = blockIdx.y;
  const int f0 = blockIdx.x * (kSplitThreads * kSplitPer) + threadIdx.x;
  uint2* hi = planes + (long)w * end;
  float4 a[kSplitPer];
#pragma unroll
  for (int u = 0; u < kSplitPer; ++u) {
    const int f = f0 + u * kSplitThreads;
    if (f >= end) continue;
    if constexpr (SRC == kQkv) {
      a[u] = q[(long)w * end + f];
    } else {
      const int n = f / row4, col = f - n * row4;
      const int h = col / (3 * kVec), slot = (col - h * 3 * kVec) / kVec, j = col % kVec;
      const float4* x = slot == 0 ? q : slot == 1 ? k : v;
      a[u] = x[((long)(w * H + h) * N + n) * kVec + j];
    }
  }
#pragma unroll
  for (int u = 0; u < kSplitPer; ++u) {
    const int f = f0 + u * kSplitThreads;
    if (f >= end) continue;
    const Frag<float> s0 = split_pair(a[u].x, a[u].y), s1 = split_pair(a[u].z, a[u].w);
    hi[f] = make_uint2(s0.hi, s1.hi);
    hi[plane4 + f] = make_uint2(s0.lo, s1.lo);
  }
}

// One launch of split_planes: q, k, v f32 in SRC's layout and planes (2,
// W, N, 3 H HD) bf16, contiguous with 16-byte aligned bases; N a multiple
// of 64, 1 <= W <= 65535, a window's plane below 2^31 elements.
template <int HD, int SRC>
cudaError_t split_to_planes(const void* q, const void* k, const void* v, void* planes, int W, int H, int N,
                            cudaStream_t stream) {
  const long per = kSplitThreads * kSplitPer, end = (long)N * 3 * H * HD / 4;
  if (W < 1 || W > 65535 || H < 1 || N % kRows || end > 0x7fffffffL - per) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((end + per - 1) / per), W);
  split_planes<HD, SRC><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k), static_cast<const float4*>(v),
      static_cast<uint2*>(planes), H, N, (long)W * end);"""
SPLIT_SLABS = """\
  constexpr int kVec = HD / 4;  // float4 of a head row, uint2 of its planes' rows
  const int slot = blockIdx.y;
  const int w = blockIdx.x / H, h = blockIdx.x - w * H;
  const int slab = N * kVec;
  const float4* x = (slot == 0 ? q : slot == 1 ? k : v) + (long)blockIdx.x * slab;
  const long ld = 3L * H * kVec;
  uint2* hi = planes + (long)w * N * ld + (3 * h + slot) * kVec;
  const int i0 = blockIdx.z * (kSplitThreads * kSplitPer) + threadIdx.x;
  float4 a[kSplitPer];
#pragma unroll
  for (int u = 0; u < kSplitPer; ++u)
    if (i0 + u * kSplitThreads < slab) a[u] = x[i0 + u * kSplitThreads];
#pragma unroll
  for (int u = 0; u < kSplitPer; ++u) {
    const int i = i0 + u * kSplitThreads;
    if (i >= slab) continue;
    const Frag<float> s0 = split_pair(a[u].x, a[u].y), s1 = split_pair(a[u].z, a[u].w);
    const long o = (i / kVec) * ld + i % kVec;
    hi[o] = make_uint2(s0.hi, s1.hi);
    hi[plane4 + o] = make_uint2(s0.lo, s1.lo);
  }
}

// The head-major source only (K8a's and K8b's split).
template <int HD, int SRC>
cudaError_t split_to_planes(const void* q, const void* k, const void* v, void* planes, int W, int H, int N,
                            cudaStream_t stream) {
  static_assert(SRC == kHeadMajor, "the slab order reads head-major q, k, v");
  const long per = kSplitThreads * kSplitPer, chunks = ((long)N * HD / 4 + per - 1) / per;
  if (W < 1 || H < 1 || (long)W * H >= 0x7fffffffL || N % kRows || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(W * H, 3, (unsigned)chunks);
  split_planes<HD, SRC><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k), static_cast<const float4*>(v),
      static_cast<uint2*>(planes), H, N, (long)W * N * 3 * H * HD / 4);"""
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
    # the f32 GEMM's k-box loop not unrolled (the projection kind spills at
    # K = 512 and 576 unrolled)
    "gemm_rolled": [(LNG, "#pragma unroll\n  for (int b = 0; b < KB; ++b) {\n"
                          "    wait_phase(full(at.slot), at.phase);\n"
                          "    const uint32_t bs = slots + at.slot * kF32Slot;",
                     "#pragma unroll 1\n  for (int b = 0; b < KB; ++b) {\n"
                     "    wait_phase(full(at.slot), at.phase);\n"
                     "    const uint32_t bs = slots + at.slot * kF32Slot;")],
    # K8a's split pass: eight uint2 a thread, or two, in place of four
    "split_per8": [(FWD, "constexpr int kSplitPer = 4;",
                    "constexpr int kSplitPer = 8;")],
    "split_per2": [(FWD, "constexpr int kSplitPer = 4;",
                    "constexpr int kSplitPer = 2;")],
    # K8a's split pass over each (window, head, tensor)'s rows in order (the
    # reads contiguous, each warp's writes 64-byte pieces of four plane
    # rows), in place of the planes' rows in order
    "split_slab_order": [(FWD, SPLIT_ROWS, SPLIT_SLABS)],
}


def build_variants(out_dir, names):
    """Every variant's LIBS, built at once; returns {name: {lib: path}}."""
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
        for lib in LIBS:
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
        if lib == "fused_block":
            _proj_spills(name, log)
    return built


def _proj_spills(name, log):
    """ptxas's spill line of the f32 projection kind at K = 576 (KB 9,
    no window map: K1's embed stage 3) in a fused_block build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "ln_gemm_f32_sm90ILi9ELi1ELb0E" in line:
            for follow in lines[i:i + 4]:
                if "spill" in follow:
                    print(f"{name}: ptxas ln_gemm_f32_sm90<9, 1, false> "
                          f"{follow.split(':', 1)[-1].strip()}", flush=True)


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
    _build.build(LIBS)
    _proj_spills("kernel", _build.build_log("fused_block"))
    built = build_variants(os.path.join(ROOT, "build", "variants"), names)
    f32 = torch.float32
    gen = torch.Generator().manual_seed(0)
    a = cs._case_inputs(64, 1024, 384, 12, gen, f32)
    k2 = (a["x"], a["ln_scale"], a["ln_bias"], a["w_qkv"], a["b_qkv"],
          a["bias"], 32 ** -0.5, 12, 1e-5)
    kern, plain, k9, *_ = cs._embed_kernel_case("K9", 64, gen, f32)
    cases = [("K2", lambda: wa._fb_s2_cuda(*k2), lambda: wa._fb_s2_plain(*k2)),
             ("K9", lambda: kern(*k9), lambda: plain(*k9))]
    for W, N, C, H in ((1024, 256, 192, 6), (64, 256, 576, 18)):
        b = cs._case_inputs(W, N, C, H, gen, f32)
        k1 = (b["x"], b["ln_scale"], b["ln_bias"], b["w_qkv"], b["b_qkv"],
              b["w_proj"], b["b_proj"], b["bias"], (C // H) ** -0.5, H, 1e-5)
        cases.append((f"K1 {(W, N, C, H)}",
                      lambda k1=k1: wa._fused_block_cuda(*k1),
                      lambda k1=k1: wa._fused_block_plain(*k1)))
    for W, H, N in ((64, 12, 1024), (4, 18, 256)):
        k8 = [torch.randn(W, H, N, 32, generator=gen).to("cuda")
              for _ in range(3)]
        k8 += [(torch.randn(H, N, N, generator=gen) * 0.5).to("cuda"),
               32 ** -0.5]
        cases.append((f"K8a {(W, H, N)}",
                      lambda k8=k8: wa._attention_qtiled_cuda(*k8),
                      lambda k8=k8: wa._attention_plain(*k8)))
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
                      if "gemm" in k or k in ("attention", "qkv_split")),
                  flush=True)
    _use(None)


if __name__ == "__main__":
    main()
