// What the window-attention backward kernels of the port (K4
// attention_qkv_bwd.cu, K5 attention_bwd_merged.cu, K7
// attention_bwd_qtiled.cu) compute, and the pieces of it that their Hopper
// core (attention_bwd_sm90.cuh) shares.  Each computes the cotangents of
//
//     o = softmax(q k^T * scale + bias) v        per (window, head)
//
// from the interleaved qkv tensor and the output cotangent g, with the
// numerics of the Pallas tile math (geoguessr_ai_tpu/ops/window_attention.py
// _qkv_bwd_kernel and _bwd_tile_math):
//
//   s  = q.k (f32 sum of bf16 products) * scale + bias        (f32)
//   p  = exp(s - max_row s) / sum_row                          (f32)
//   dp = g.v                                                   (f32)
//   t  = sum_row dp * p                                        (f32)
//   ds = p * (dp - t)                                          (f32)
//   dv = bf16(p)^T g,  dq = (bf16(ds) k) * scale,  dk = (bf16(ds)^T q) * scale
//   d_bias[h] = sum over windows of ds                         (f32)
//
// K4 reads the bias in the activations' type (the Pallas call casts it),
// K5 and K7 as f32.  In f32 (common.cuh "Element types"), qkv, g and d_qkv
// are f32, the products split their operands into bf16 (hi, lo) pairs, and
// p and ds are split, not rounded.
//
// The work is four launches that each recompute the scores of their tiles
// (FlashAttention-2 style) and own their outputs, so nothing but d_bias
// needs a cross-item sum: the row statistics (max, 1 / sum, t) per query,
// dk and dv per key tile, dq per query tile, and d_bias per tile summed
// over the windows in an order fixed by the shape (no atomics, so bitwise
// the same from run to run, as the Pallas kernels' sum in grid order is).
#pragma once

#include "common.cuh"

namespace gg {

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shape of one call: qkv (W, N, 3D), g (W, N, D), D = H * HD; stats are
// three (W, H, N) f32 planes: row max, 1 / row sum, t.
template <class E>
struct BwdArgs {
  const E* qkv;
  const E* g;
  E* dqkv;
  float* dbias;
  float* stats;
  int W, N, H;
  float scale;
};

template <class E>
__device__ __forceinline__ long stat_index(const BwdArgs<E>& a, int w, int h, int row) {
  return ((long)w * a.H + h) * a.N + row;
}

}  // namespace gg
