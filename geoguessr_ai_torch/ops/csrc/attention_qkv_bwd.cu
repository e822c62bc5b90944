// K4: the small-N window-attention backward, d_qkv (W, N, 3D) in bf16 and
// d_bias (H, N, N) in f32 summed over the W windows, from the interleaved
// qkv tensor, the bf16 bias and the output cotangent g (W, N, D).
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:560
// _attention_qkv_bwd_pallas (kernel _qkv_bwd_kernel), which the JAX package
// chooses when H * N^2 * 4 <= 6 MB: stage 1 (N=256, H=6, 16 windows per
// image) directly through K1's VJP and stage 3 (N=256, H=18) through
// window_attention_qkv's VJP.  The bias travels bf16, as the Pallas call
// casts it.
//
// What bounds it on the H100: at stage 1 and B=16 panoramas (1024 windows)
// the minimal work is five N x N x 32 products per (window, head), 10 N^2
// hd flops, against reading qkv and g and writing d_qkv once, 14 N hd
// bytes: about 183 flops per byte at N=256, under the card's ~295 flops
// per byte ridge, so bytes bound it (~0.7 GB).  This first design
// (attention_bwd.cuh) recomputes the scores in each of its four launches
// instead of keeping them on chip: about 2.4x the minimal tensor-core work
// and 5 exponentials per score, the gap for a later change.
#include "attention_bwd.cuh"

extern "C" int attention_qkv_bwd_bf16(const void* qkv, const void* bias, const void* g,
                                      void* dqkv, void* dbias, void* stats, int W, int N,
                                      int H, float scale, void* stream) {
  const gg::BwdArgs a{static_cast<const gg::bf16*>(qkv), static_cast<const gg::bf16*>(g),
                      static_cast<gg::bf16*>(dqkv),      static_cast<float*>(dbias),
                      static_cast<float*>(stats),        W,
                      N,                                 H,
                      scale};
  return (int)gg::launch_attention_bwd(a, static_cast<const gg::bf16*>(bias),
                                       static_cast<cudaStream_t>(stream));
}
