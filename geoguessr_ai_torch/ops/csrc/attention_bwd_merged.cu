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
// Why the TPU's "merged" order has no counterpart on an SM.  The TPU kernel
// walks its (H, W, q-tile) grid in order on one core and keeps a head's
// whole (N, N) f32 d_bias resident in VMEM across the windows (4 MiB at
// N = 1024, inside _BWD_MERGED_VMEM's 64 MiB), so dq, dk, dv and d_bias
// come out of one pass.  A Hopper SM has 227 KB of shared memory and runs
// beside 131 others in no order, so a sum over the windows has to be owned
// by one work item, and dk/dv (summed over the queries of one window) and
// d_bias (summed over the windows of one query tile) run in opposite
// orders.  The bf16 entry is therefore the backward core of
// attention_bwd_sm90.cuh, which K7 (attention_bwd_qtiled.cu) runs too:
// four persistent launches, the row statistics, dk/dv per 128-key tile, dq
// per 128-query tile, and d_bias summed over the W windows in order, here
// in one group (G = 1: every d_bias tile sums all W windows in window
// order, K5's contract), with t taken in a second pass over the keys.  So
// its d_qkv and d_bias are the first design's bit for bit, and K7's
// whenever K7's window groups are one (at stage 2, _bwd_groups(64, 1024,
// 12) = 1).
//
// What bounds it on the H100: at N=1024 the five N x N x 32 products per
// (window, head) are 10 N^2 hd flops against 14 N hd bytes of q, k, v, g
// in and d_qkv out, about 731 flops per byte, above the card's ~295 flops
// per byte ridge, so the tensor cores bound it (~258 GFLOP at B=16
// panoramas).  The core recomputes the scores in each launch: twelve
// N x N products a (window, head) where the function needs five.
// The _f32 twin keeps the first design (attention_bwd.cuh), which
// recomputes scores per 64x64 tile on mma.sync in four launches.
#include "attention_bwd_sm90.cuh"

namespace {

// qkv, g, dqkv bf16 (or f32 for the twin); bias, dbias and stats f32.
template <class E>
gg::BwdArgs<E> args(const void* qkv, const void* g, void* dqkv, void* dbias, void* stats, int W,
                    int N, int H, float scale) {
  return gg::BwdArgs<E>{static_cast<const E*>(qkv), static_cast<const E*>(g),
                        static_cast<E*>(dqkv),        static_cast<float*>(dbias),
                        static_cast<float*>(stats),   W,
                        N,                            H,
                        scale};
}

}  // namespace

// Shapes validated by the Python wrapper (N a multiple of 64, head dim 16,
// 32 or 64, 1 <= W <= 65535; in bf16 qkv and g 16-byte aligned with rows a
// multiple of 16 bytes apart, _bwd_layout).  stats is (3, W, H, N) f32
// scratch; every element of dqkv and dbias is written.  One window group,
// so no partials.
extern "C" int attention_bwd_merged_bf16(const void* qkv, const void* bias, const void* g, void* dqkv,
                void* dbias, void* stats, int W, int N, int H, int hd, float scale,
                void* stream) {
  const gg::BwdArgs<gg::bf16> a = args<gg::bf16>(qkv, g, dqkv, dbias, stats, W, N, H, scale);
  const float* b = static_cast<const float*>(bias);
  // one window group (no partials), t in a second pass
  return (int)gg::bwd90::launch(a, b, nullptr, 1, hd, 2, static_cast<cudaStream_t>(stream));
}

extern "C" int attention_bwd_merged_f32(const void* qkv, const void* bias, const void* g, void* dqkv,
                void* dbias, void* stats, int W, int N, int H, int hd, float scale,
                void* stream) {
  return (int)gg::launch_attention_bwd(args<float>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                       static_cast<const float*>(bias), hd,
                                       static_cast<cudaStream_t>(stream));
}
