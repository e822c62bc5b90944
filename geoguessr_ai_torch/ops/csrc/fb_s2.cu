// K2: the stage-2 "no-proj" fused block, LayerNorm -> qkv GEMM -> window
// attention, returning the pre-projection (W, N, D) output.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:1485 _fb_s2_pallas
// (kernel _fb_s2_kernel), stage 2 of TinyViT-21M-512 (N=1024, C=384,
// H=12, hd=32).
//
// What bounds it on the H100 at stage 2 of a serving bucket of 16 (W=64):
// the attention's 4*N*N*hd flops per (window, head), 103 GFLOP, the qkv
// GEMM's 58 GFLOP, against 0.23 GB of x, bias, output and weights; at
// hd=32 the N*N exponentials (MUFU, 16/clk/SM) cost about as much as the
// tensor-core work.  Two launches, as in the first design: qkv makes one
// round trip through device memory (151 MB each way at bucket 16, ~0.09 ms
// at 3.35 TB/s).  A window's qkv is 2.36 MB, which fits no SM, and a
// per-head slice would redo the window's LayerNorm and GEMM 12 times; the
// TPU kernel kept qkv in VMEM.
//
// The bf16 entry runs two Hopper cores (TMA, wgmma, persistent
// warp-specialised blocks):
//   1. ln_gemm_sm90.cuh: each 128-row tile of x normalised once in shared
//      memory (f32 statistics, two passes), then walked against the
//      1152 columns of w_qkv in 64-column tiles streamed through a ring;
//      epilogue bf16(bf16(acc) + b), K2's ROUND_FIRST contract.
//   2. attention_fwd_sm90.cuh in its interleaved layout, exactly as K3's
//      attention_qkv_bf16 calls it: one tensor map over qkv, the item's
//      64 x N bf16 bias tile resident over a group of windows
//      (window_attention._headmajor_groups, passed in as `groups`), the
//      online softmax in chunks of four 64-key tiles at N = 1024.  The
//      first design's softmax was online too (common.cuh), so K2's numeric
//      contract against _fb_s2_plain does not change.  A bf16 64 x 1024
//      bias tile is 128 KB and fits beside a ring at every head dim; N
//      above 1024 is refused by the wrapper.
// The _f32 twin keeps the first design: common.cuh's LayerNorm + GEMM
// kernel and window attention kernel (mma.sync, "Element types"); it
// ignores `groups`.
#include "attention_fwd_sm90.cuh"
#include "ln_gemm_sm90.cuh"

extern "C" int fb_s2_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w_qkv_t, const void* b_qkv, const void* bias,
                          void* qkv_scratch, void* out, int W, int N, int C, int H, int hd,
                          int groups, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  using gg::lng90::kQkvGemm;
  cudaError_t e = gg::lng90::run<kQkvGemm, false>(x, static_cast<const float*>(ln_scale),
                                                  static_cast<const float*>(ln_bias), w_qkv_t,
                                                  static_cast<const float*>(b_qkv), qkv_scratch,
                                                  W * N, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    return (int)run<kQkv, gg::bf16, HD, false>(qkv_scratch, qkv_scratch, qkv_scratch, bias, out,
                                               W, H, N, groups, scale, s);
  })
}

// The 128-row kind of the attention (window_attention.FWD_Q_ROWS = 128):
// hd 32, N a multiple of 128, `groups` walked a pair of windows at a time.
extern "C" int fb_s2_q128_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                               const void* w_qkv_t, const void* b_qkv, const void* bias,
                               void* qkv_scratch, void* out, int W, int N, int C, int H, int hd,
                               int groups, float scale, float eps, void* stream) {
  using namespace gg::fwd90;
  if (hd != kRows128HeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  using gg::lng90::kQkvGemm;
  cudaError_t e = gg::lng90::run<kQkvGemm, false>(x, static_cast<const float*>(ln_scale),
                                                  static_cast<const float*>(ln_bias), w_qkv_t,
                                                  static_cast<const float*>(b_qkv), qkv_scratch,
                                                  W * N, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  return (int)run<kQkv, gg::bf16, kRows128HeadDim, false>(qkv_scratch, qkv_scratch, qkv_scratch,
                                                          bias, out, W, H, N, groups, scale, s,
                                                          2 * kRows);
}

// The attention's plan at (W, N, H, hd, G, rows) without a launch: out[8]
// as fwd90::plan fills it (the bf16 bias, no streamed plan).
extern "C" int fb_s2_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::fwd90::plan(W, H, N, G, hd, 2, false, rows, out);
}

extern "C" int fb_s2_f32(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w_qkv_t, const void* b_qkv, const void* bias,
                         void* qkv_scratch, void* out, int W, int N, int C, int H, int hd,
                         int /*groups*/, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  cudaError_t e = gg::launch_ln_gemm<true, true>(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w_qkv_t),
      static_cast<const float*>(b_qkv), static_cast<float*>(qkv_scratch), W * N, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::launch_window_attention(static_cast<const float*>(qkv_scratch),
                                          static_cast<const float*>(bias),
                                          static_cast<float*>(out), W, N, H, hd, scale, s);
}
