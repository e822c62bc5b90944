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
// and the attention's N*N exponentials cost about as much as its products.  The design is three launches: LayerNorm + qkv GEMM
// (x normalised in shared memory), attention (scores in registers), and
// the out-projection GEMM with the f32 b_proj added to the f32 sum.  The
// qkv tensor and the attention output each make one round trip through
// device memory, which the TPU kernel kept in VMEM: that is the known gap
// for a later change.
#include "common.cuh"

extern "C" int fused_block_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                                const void* b_proj, const void* bias, void* qkv_scratch,
                                void* attn_scratch, void* out, int W, int N, int C, int H,
                                float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * gg::kHd;
  cudaError_t e = gg::launch_ln_gemm<true, true>(
      static_cast<const gg::bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const gg::bf16*>(w_qkv_t),
      static_cast<const float*>(b_qkv), static_cast<gg::bf16*>(qkv_scratch), W * N, C, 3 * D,
      eps, s);
  if (e != cudaSuccess) return (int)e;
  e = gg::launch_window_attention(static_cast<const gg::bf16*>(qkv_scratch),
                                  static_cast<const gg::bf16*>(bias),
                                  static_cast<gg::bf16*>(attn_scratch), W, N, H, scale, s);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::launch_ln_gemm<false, false>(
      static_cast<const gg::bf16*>(attn_scratch), nullptr, nullptr,
      static_cast<const gg::bf16*>(w_proj_t), static_cast<const float*>(b_proj),
      static_cast<gg::bf16*>(out), W * N, D, C, eps, s);
}
