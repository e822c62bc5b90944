// K7: the two-kernel large-N window-attention backward, d_qkv (W, N, 3D)
// in the activations' type (bf16, or f32) and d_bias (H, N, N) in f32 summed over the W windows, with an
// f32 bias.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:694
// _attention_bwd_qtiled_pallas (_bwd_k1_kernel -> dq, dk, dv, :657;
// _bwd_k2_kernel -> d_bias, :677; the tile math _bwd_tile_math, :618),
// which the JAX package takes at stage 2 of TinyViT-21M-512 (N=1024, H=12)
// in place of the merged backward (K5) when BWD_MERGED is False.  The TPU
// needs two kernels because its two sums run in opposite grid orders: dk/dv
// over the q-tiles of one (head, window), d_bias over the windows of one
// (head, q-tile).  So does this port, and for the same reason.  The
// staging of _attention_qkv_bwd_large (:802) is index arithmetic: qkv and
// g are read interleaved and d_qkv written so, each f32 sum rounded to
// bf16 once as the staging's final cast does.
//
// What bounds it on the H100: the tensor cores.  The minimum is the five
// N x N x hd products of the dq/dk/dv side plus the two of the d_bias side
// (s and dp again), 14 N^2 hd flops a (window, head): 0.365 ms at the bf16
// peak at W=64, H=12, N=1024.
//
// The bf16 entry runs the Hopper core of attention_bwd_sm90.cuh, which
// K4's bf16 entry shares: the d_qkv side as three persistent launches
// (the row statistics, dk/dv per 128-key tile, dq per 128-query tile, each
// over (tile, window, head) items spread evenly over the SMs), the d_bias
// side as a fourth that sums ds of one (128-query, 64-key) tile over the
// windows in order; every product is a wgmma on tiles that a producer
// warpgroup brought in ahead by TMA, the f32 bias tiles included.  Its row
// statistics take two passes over the keys, t in the second, exactly as
// the first design and K5 compute them, so its d_qkv and d_bias are K5's
// bit for bit (a one-pass t rounds otherwise, and six blocks of bf16
// backward amplify an ulp past chip_smoke.py's K5-vs-K7 train-step gate).
// The first design, which both entries ran once, took the three d_qkv
// phases in series in one block per (head, window), 768 blocks each
// carrying a chain of ~800 mma.sync tile steps, at about 6 % of the bf16
// peak.  The _f32 entry runs the core's f32 kind: the same launches, the
// products split into bf16 pairs on the chip.
#include "attention_bwd_sm90.cuh"

namespace gg {
namespace {

template <class E>
BwdArgs<E> args(const void* qkv, const void* g, void* dqkv, void* dbias, void* stats, int W, int N,
                int H, float scale) {
  return BwdArgs<E>{static_cast<const E*>(qkv), static_cast<const E*>(g),
                    static_cast<E*>(dqkv),        static_cast<float*>(dbias),
                    static_cast<float*>(stats),   W,
                    N,                            H,
                    scale};
}

}  // namespace
}  // namespace gg

// Shapes validated by the Python wrapper (N a multiple of 64, head dim 16,
// 32 or 64, 1 <= W <= 65535, 1 <= G <= W).  stats is (3, W, H, N) f32
// scratch and partial (G, H, N, N) f32 scratch when G > 1; every element
// of dqkv and dbias is written.  qkv, g and dqkv bf16 (or f32 for the _f32
// entry); bias and dbias f32.
extern "C" int attention_bwd_qtiled_bf16(const void* qkv, const void* bias, const void* g,
                                         void* dqkv, void* dbias, void* stats, void* partial,
                                         int W, int N, int H, int hd, int G, float scale,
                                         void* stream) {
  return (int)gg::bwd90::launch(gg::args<gg::bf16>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                static_cast<const float*>(bias), static_cast<float*>(partial), G,
                                hd, 2, static_cast<cudaStream_t>(stream));
}

// The 64-row kind of the core (window_attention.BWD_Q_ROWS = 64, hd 32).
extern "C" int attention_bwd_qtiled_q64_bf16(const void* qkv, const void* bias, const void* g,
                                             void* dqkv, void* dbias, void* stats, void* partial,
                                             int W, int N, int H, int hd, int G, float scale,
                                             void* stream) {
  return (int)gg::bwd90::launch(gg::args<gg::bf16>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                static_cast<const float*>(bias), static_cast<float*>(partial), G,
                                hd, 2, static_cast<cudaStream_t>(stream), 64);
}

// The bf16 core's plan at (W, N, H, G, hd, rows) without a launch: out[12]
// as bwd90::plan fills it (the f32 bias).
extern "C" int attention_bwd_qtiled_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::bwd90::plan<float>(W, N, H, G, hd, rows, out);
}

// The f32 entry runs the core's f32 kind with the bf16 entry's groups and
// passes: K5's f32 entry's bits wherever G is one.
extern "C" int attention_bwd_qtiled_f32(const void* qkv, const void* bias, const void* g,
                                        void* dqkv, void* dbias, void* stats, void* partial, int W,
                                        int N, int H, int hd, int G, float scale, void* stream) {
  return (int)gg::bwd90::launch(gg::args<float>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                static_cast<const float*>(bias), static_cast<float*>(partial), G,
                                hd, 2, static_cast<cudaStream_t>(stream));
}

// The f32 kind's plan at (W, N, H, G, hd, rows = 128) without a launch.
extern "C" int attention_bwd_qtiled_plan_f32(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::bwd90::plan_f32(W, N, H, G, hd, rows, out);
}
