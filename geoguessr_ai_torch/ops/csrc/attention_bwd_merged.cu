// K5: the large-N window-attention backward, d_qkv (W, N, 3D) in bf16 and
// d_bias (H, N, N) in f32 summed over the W windows, with an f32 bias.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:1708
// _attention_bwd_merged_pallas (kernel _bwd_merged_kernel, the tile math
// _bwd_tile_math at :618), which the JAX package reaches at stage 2 of
// TinyViT-21M-512 (N=1024, H=12, one window per image) through K2's VJP
// and _attention_qkv_bwd_large.  The TPU kernel takes head-major q, k, v, g
// staged by XLA transposes (:802-825) and returns f32 dq, dk, dv; this one
// reads the interleaved (W, N, 3D) qkv and (W, N, D) g directly and writes
// d_qkv, rounding each f32 sum to bf16 once, as the staging's final cast
// does.  The bias is read as f32 (:1717).
//
// What bounds it on the H100: at N=1024 the five N x N x 32 products per
// (window, head) are 10 N^2 hd flops against 14 N hd bytes of q, k, v, g
// in and d_qkv out, about 731 flops per byte, above the card's ~295 flops
// per byte ridge, so the tensor cores bound it (~258 GFLOP at B=16
// panoramas).  An f32 row of 1024 scores per query does not fit a
// Hopper SM's shared memory beside the rest, so the design
// (attention_bwd.cuh) recomputes scores per 64x64 tile in four launches:
// about 2.4x the minimal tensor-core work, the gap for a later change.
#include "attention_bwd.cuh"

extern "C" int attention_bwd_merged_bf16(const void* qkv, const void* bias, const void* g,
                                         void* dqkv, void* dbias, void* stats, int W, int N,
                                         int H, float scale, void* stream) {
  const gg::BwdArgs a{static_cast<const gg::bf16*>(qkv), static_cast<const gg::bf16*>(g),
                      static_cast<gg::bf16*>(dqkv),      static_cast<float*>(dbias),
                      static_cast<float*>(stats),        W,
                      N,                                 H,
                      scale};
  return (int)gg::launch_attention_bwd(a, static_cast<const float*>(bias),
                                       static_cast<cudaStream_t>(stream));
}
