// K9: K1 (the fused TinyViT attention block, LayerNorm -> qkv GEMM ->
// window attention -> out-projection + b_proj) over the raw (B, Hm, Wm, C)
// map, with no window partition or unpartition copy.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:1869 _fb4d_pallas
// (kernel _fb4d_kernel): stage 1 of TinyViT-21M-512 with fused_block_4d, a
// (B, 64, 64, 192) map cut into 16x16 windows (N=256, H=6).  The TPU
// kernel moved the partition into its BlockSpec index map.
//
// What bounds it on the H100: the same work as K1 at stage 1, bytes and
// the attention's exponentials (see fused_block.cu); at B=512 the map is
// 805 MB in and 805 MB out, and the three launches move about 8.05 GB
// (2.4 ms at 3.35 TB/s), the floor of this design.  What it saves over K1
// on the partitioned path is the two partition copies (a read and a write
// of the map each); qkv and the attention output still make one round trip
// through device memory.
//
// The bf16 entry runs K1's three launches, with the partition moved into
// tensor maps (ln_gemm_sm90.cuh's window map, MAP): the qkv GEMM reads x
// through a 5D map over the map whose 128-row box is 8 rows of 16 columns
// of one window, so it writes the (W, N, 3D) qkv in window order, which the
// attention reads exactly as K1's does; the out-projection reads the (W, N,
// D) attention output and stores out through the same map, in 64-row boxes
// of 4 window rows.  The window side ws must divide 64 with ws * ws a
// multiple of 128 (16 or 32 up to N = 1024; the wrapper refuses others).
// Every output element is summed in the order of K1's on the partitioned
// map, so K9 equals K1 there bit for bit.
//
// The _f32 twin runs the same three launches on the cores' f32 kinds (the
// GEMM core splitting x and the attention output in place into bf16 hi and
// lo, the weights the wrapper's stacked (hi, lo) pairs, qkv stored as its
// bf16 hi and lo planes in qkv_scratch; the forward core's f32 kind with
// its 64 x 256 bias tile resident over `groups`), through the same window
// map: x read in f32 boxes of 32 channels, out stored row by row at its
// place in the map.  Its scratch is window-ordered, as K1's.
#include "attention_fwd_sm90.cuh"
#include "ln_gemm_sm90.cuh"

extern "C" int fb4d_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                         const void* b_proj, const void* bias, void* qkv_scratch,
                         void* attn_scratch, void* out, int B, int Hm, int Wm, int C, int H,
                         int hd, int window, int groups, float scale, float eps, void* stream) {
  using gg::lng90::kProjGemm;
  using gg::lng90::kQkvGemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const int M = B * Hm * Wm;
  const int N = window * window;
  const int W = M / N;
  cudaError_t e = gg::lng90::run<kQkvGemm, true>(
      x, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), w_qkv_t,
      static_cast<const float*>(b_qkv), qkv_scratch, M, C, 3 * D, eps, s, window, Wm);
  if (e != cudaSuccess) return (int)e;
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    e = run<kQkv, gg::bf16, HD, false>(qkv_scratch, qkv_scratch, qkv_scratch, bias, attn_scratch,
                                       W, H, N, groups, scale, s);
    break;
  })
  if (e != cudaSuccess) return (int)e;
  return (int)gg::lng90::run<kProjGemm, true>(attn_scratch, nullptr, nullptr, w_proj_t,
                                              static_cast<const float*>(b_proj), out, M, D, C, eps,
                                              s, window, Wm);
}

// The 128-row kind of the attention (window_attention.FWD_Q_ROWS = 128):
// hd 32, N a multiple of 128, `groups` walked a pair of windows at a time.
extern "C" int fb4d_q128_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                              const void* b_proj, const void* bias, void* qkv_scratch,
                              void* attn_scratch, void* out, int B, int Hm, int Wm, int C, int H,
                              int hd, int window, int groups, float scale, float eps,
                              void* stream) {
  using gg::lng90::kProjGemm;
  using gg::lng90::kQkvGemm;
  using namespace gg::fwd90;
  if (hd != kRows128HeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const int M = B * Hm * Wm;
  const int N = window * window;
  const int W = M / N;
  cudaError_t e = gg::lng90::run<kQkvGemm, true>(
      x, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), w_qkv_t,
      static_cast<const float*>(b_qkv), qkv_scratch, M, C, 3 * D, eps, s, window, Wm);
  if (e != cudaSuccess) return (int)e;
  e = run<kQkv, gg::bf16, kRows128HeadDim, false>(qkv_scratch, qkv_scratch, qkv_scratch, bias,
                                                  attn_scratch, W, H, N, groups, scale, s,
                                                  2 * kRows);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::lng90::run<kProjGemm, true>(attn_scratch, nullptr, nullptr, w_proj_t,
                                              static_cast<const float*>(b_proj), out, M, D, C, eps,
                                              s, window, Wm);
}

// The attention's plan at (W, N, H, hd, G, rows) without a launch: out[8]
// as fwd90::plan fills it (the bf16 bias, no streamed plan).
extern "C" int fb4d_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::fwd90::plan(W, H, N, G, hd, 2, false, rows, out);
}

extern "C" int fb4d_f32(const void* x, const void* ln_scale, const void* ln_bias,
                        const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                        const void* b_proj, const void* bias, void* qkv_scratch,
                        void* attn_scratch, void* out, int B, int Hm, int Wm, int C, int H,
                        int hd, int window, int groups, float scale, float eps, void* stream) {
  using gg::lng90::kProjGemm;
  using gg::lng90::kQkvGemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const int M = B * Hm * Wm;
  const int N = window * window;
  const int W = M / N;
  cudaError_t e = gg::lng90::run_f32<kQkvGemm, true>(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), w_qkv_t, static_cast<const float*>(b_qkv),
      qkv_scratch, M, C, 3 * D, eps, s, window, Wm);
  if (e != cudaSuccess) return (int)e;
  GG_HEAD_DIM_SWITCH(hd, {
    e = gg::fwd90::run_f32<HD>(qkv_scratch, bias, attn_scratch, W, H, N, groups, scale, s);
    break;
  })
  if (e != cudaSuccess) return (int)e;
  return (int)gg::lng90::run_f32<kProjGemm, true>(
      static_cast<const float*>(attn_scratch), nullptr, nullptr, w_proj_t,
      static_cast<const float*>(b_proj), static_cast<float*>(out), M, D, C, eps, s, window, Wm);
}

// The f32 attention's plan at (W, N, H, hd, G) without a launch: out[8] as
// fwd90::plan_f32 fills it (64-row items only).
extern "C" int fb4d_plan_f32(int W, int N, int H, int hd, int G, int rows, int* out) {
  if (rows != gg::fwd90::kRows) return (int)cudaErrorInvalidValue;
  return (int)gg::fwd90::plan_f32(W, H, N, G, hd, out);
}
