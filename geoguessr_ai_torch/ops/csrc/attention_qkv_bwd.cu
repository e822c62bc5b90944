// K4: the small-N window-attention backward, d_qkv (W, N, 3D) in the
// activations' type (bf16, or f32) and d_bias (H, N, N) in f32 summed over
// the W windows, from the interleaved qkv tensor, the bias in the
// activations' type and the output cotangent g (W, N, D).
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
// per byte ridge, so bytes bound it (~0.7 GB).
//
// Both entries run the Hopper core of attention_bwd_sm90.cuh (K7's too),
// the bf16 one its bf16 kind and the _f32 one its f32 kind: TMA loads
// through rings of shared memory kept full by a producer warpgroup, wgmma
// products, persistent blocks.  What it does about the first design's
// time (four mma.sync launches, which both entries ran once), whose
// d_bias launch walked all 1024 windows in 96 blocks one after the other
// and whose four launches recomputed twelve N x N products a (window, head)
// on mma.sync from synchronously staged tiles:
//   * d_bias is summed per window group: G groups (a function of W, N and
//     H, 21 at stage 1) in G times as many items, each summing its group's
//     windows in order in registers, then the G partials in group order;
//   * the row statistics take one online pass (t's sum rescaled with the
//     max as the row sum is), so eleven products a (window, head), each a
//     wgmma on tiles that TMA brought in ahead;
//   * the bias tiles come through shared memory with a swizzle instead of
//     scattered loads, and every launch spreads its items over all SMs:
//     12288 items of four 64-key steps at stage 1.
// The TPU kernel keeps a whole (N, N) score row in VMEM; here the scores
// of a 64 x 64 tile live only in registers, and only the three row
// statistics go through device memory.
#include "attention_bwd_sm90.cuh"

namespace {

// qkv, g, dqkv bf16 (or f32 for the _f32 entry); bias in the same type;
// dbias and stats f32; partial (G, H, N, N) f32 scratch when G > 1.
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

extern "C" int attention_qkv_bwd_bf16(const void* qkv, const void* bias, const void* g, void* dqkv,
                                      void* dbias, void* stats, void* partial, int W, int N, int H,
                                      int hd, int G, float scale, void* stream) {
  return (int)gg::bwd90::launch(args<gg::bf16>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                static_cast<const gg::bf16*>(bias), static_cast<float*>(partial), G,
                                hd, 1, static_cast<cudaStream_t>(stream));
}

// The 64-row kind of the core (window_attention.BWD_Q_ROWS = 64, hd 32):
// each consumer warpgroup on 64-row items of its own.
extern "C" int attention_qkv_bwd_q64_bf16(const void* qkv, const void* bias, const void* g,
                                          void* dqkv, void* dbias, void* stats, void* partial,
                                          int W, int N, int H, int hd, int G, float scale,
                                          void* stream) {
  return (int)gg::bwd90::launch(args<gg::bf16>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                static_cast<const gg::bf16*>(bias), static_cast<float*>(partial), G,
                                hd, 1, static_cast<cudaStream_t>(stream), 64);
}

// The bf16 core's plan at (W, N, H, G, hd, rows) without a launch: out[12]
// as bwd90::plan fills it.
extern "C" int attention_qkv_bwd_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::bwd90::plan<gg::bf16>(W, N, H, G, hd, rows, out);
}

// The f32 entry runs the core's f32 kind: the same launches and window
// groups (G and partial as the bf16 entry takes them), every product split
// into bf16 (hi, lo) pairs, t in the online pass.
extern "C" int attention_qkv_bwd_f32(const void* qkv, const void* bias, const void* g, void* dqkv,
                                     void* dbias, void* stats, void* partial, int W, int N, int H,
                                     int hd, int G, float scale, void* stream) {
  return (int)gg::bwd90::launch(args<float>(qkv, g, dqkv, dbias, stats, W, N, H, scale),
                                static_cast<const float*>(bias), static_cast<float*>(partial), G,
                                hd, 1, static_cast<cudaStream_t>(stream));
}

// The f32 kind's plan at (W, N, H, G, hd, rows = 128) without a launch.
extern "C" int attention_qkv_bwd_plan_f32(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::bwd90::plan_f32(W, N, H, G, hd, rows, out);
}
