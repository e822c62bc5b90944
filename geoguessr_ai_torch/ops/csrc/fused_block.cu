// K1: the fully fused TinyViT attention block, LayerNorm -> qkv GEMM ->
// window attention -> out-projection + b_proj (the residual add stays
// outside).
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:1078 _fused_block_pallas
// (kernel _fused_block_kernel): stage 1 of TinyViT-21M-512 (N=256, C=192,
// H=6, 16 windows per image) and stage 3 of the embed configuration
// (N=256, C=576, H=18).
//
// What bounds it on the H100: stage 1 is the widest tensor of the model
// (1024 windows at bucket 16).  Its qkv GEMM does 6*C*C flops per token
// against 8*C bytes of x in and qkv out, 0.75*C = 144 flops per byte at
// C=192, under the card's ~295 flops/byte ridge, so bytes bound the block,
// and the attention's N*N exponentials cost about as much as its products.
// The design is three launches: LayerNorm + qkv GEMM, attention, and the
// out-projection GEMM with the f32 b_proj added to the f32 sum.  The qkv
// tensor and the attention output each make one round trip through device
// memory, which the TPU kernel kept in VMEM: at stage 1 of a serving bucket
// of 16 the three launches move about 1.0 GB (0.30 ms at 3.35 TB/s), the
// floor of this design.  A window's qkv (295 KB at stage 1) fits no SM.
//
// The bf16 entry runs the port's two Hopper cores (TMA, wgmma, persistent
// warp-specialised blocks):
//   1. ln_gemm_sm90.cuh, kQkvGemm: each 128-row tile of x normalised once
//      in shared memory, then walked against the 3D columns of w_qkv;
//      epilogue bf16(bf16(acc) + b), the ROUND_FIRST contract (K up to 576:
//      the embed configuration's stage 3).
//   2. attention_fwd_sm90.cuh in its interleaved layout, exactly as K2 and
//      K3 call it: one tensor map over qkv, the item's 64 x N bf16 bias tile
//      resident over a group of windows (window_attention._headmajor_groups,
//      passed in as `groups`: 42 at stage 1 of a serving bucket of 16).  At
//      N = 256 a chunk is the whole score row; the first design's softmax
//      was online, so the contract against _fused_block_plain is the same
//      few bf16 ulps.
//   3. ln_gemm_sm90.cuh, kProjGemm: the attention output's tiles straight
//      from TMA to wgmma (no LayerNorm), epilogue bf16(acc + b_proj) with
//      the f32 b_proj, the ROUND_LAST contract.
// The _f32 twin runs the first design's three launches in f32 (common.cuh
// "Element types": no rounding between them, split operands in every
// product); it ignores `groups`.
#include "attention_fwd_sm90.cuh"
#include "ln_gemm_sm90.cuh"

// x, the weights, bias, the scratch and out in bf16 (or f32 for the _f32
// twin); ln_scale, ln_bias, b_qkv and b_proj f32.
extern "C" int fused_block_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                                const void* b_proj, const void* bias, void* qkv_scratch,
                                void* attn_scratch, void* out, int W, int N, int C, int H,
                                int hd, int groups, float scale, float eps, void* stream) {
  using gg::lng90::kProjGemm;
  using gg::lng90::kQkvGemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  cudaError_t e = gg::lng90::run<kQkvGemm, false>(
      x, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), w_qkv_t,
      static_cast<const float*>(b_qkv), qkv_scratch, W * N, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    e = run<kQkv, gg::bf16, HD, false>(qkv_scratch, qkv_scratch, qkv_scratch, bias, attn_scratch,
                                       W, H, N, groups, scale, s);
    break;
  })
  if (e != cudaSuccess) return (int)e;
  return (int)gg::lng90::run<kProjGemm, false>(attn_scratch, nullptr, nullptr, w_proj_t,
                                               static_cast<const float*>(b_proj), out, W * N, D, C,
                                               eps, s);
}

// The 128-row kind of the attention (window_attention.FWD_Q_ROWS = 128):
// hd 32, N a multiple of 128, `groups` walked a pair of windows at a time.
extern "C" int fused_block_q128_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                                     const void* b_proj, const void* bias, void* qkv_scratch,
                                     void* attn_scratch, void* out, int W, int N, int C, int H,
                                     int hd, int groups, float scale, float eps, void* stream) {
  using gg::lng90::kProjGemm;
  using gg::lng90::kQkvGemm;
  using namespace gg::fwd90;
  if (hd != kRows128HeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  cudaError_t e = gg::lng90::run<kQkvGemm, false>(
      x, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), w_qkv_t,
      static_cast<const float*>(b_qkv), qkv_scratch, W * N, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  e = run<kQkv, gg::bf16, kRows128HeadDim, false>(qkv_scratch, qkv_scratch, qkv_scratch, bias,
                                                  attn_scratch, W, H, N, groups, scale, s,
                                                  2 * kRows);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::lng90::run<kProjGemm, false>(attn_scratch, nullptr, nullptr, w_proj_t,
                                               static_cast<const float*>(b_proj), out, W * N, D, C,
                                               eps, s);
}

// The attention's plan at (W, N, H, hd, G, rows) without a launch: out[8]
// as fwd90::plan fills it (the bf16 bias, no streamed plan).
extern "C" int fused_block_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::fwd90::plan(W, H, N, G, hd, 2, false, rows, out);
}

extern "C" int fused_block_f32(const void* x, const void* ln_scale, const void* ln_bias,
                               const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                               const void* b_proj, const void* bias, void* qkv_scratch,
                               void* attn_scratch, void* out, int W, int N, int C, int H, int hd,
                               int /*groups*/, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  cudaError_t e = gg::launch_ln_gemm<true, true>(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w_qkv_t),
      static_cast<const float*>(b_qkv), static_cast<float*>(qkv_scratch), W * N, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  e = gg::launch_window_attention(static_cast<const float*>(qkv_scratch),
                                  static_cast<const float*>(bias),
                                  static_cast<float*>(attn_scratch), W, N, H, hd, scale, s);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::launch_ln_gemm<false, false>(
      static_cast<const float*>(attn_scratch), nullptr, nullptr,
      static_cast<const float*>(w_proj_t), static_cast<const float*>(b_proj),
      static_cast<float*>(out), W * N, D, C, eps, s);
}
