// K8a and K8b: head-major window attention
//
//     out[w, h] = softmax(q[w, h] k[w, h]^T * scale + bias[h]) v[w, h]
//
// q, k, v, out (W, H, N, hd) bf16 (or f32, the _f32 twins) with hd 16, 32
// or 64, bias (H, N, N) f32.  Replaces the two
// Pallas kernels behind the JAX package's window_attention
// (geoguessr_ai_tpu/ops/window_attention.py): K8a _attention_qtiled
// (_qtiled_kernel), chosen at N >= 512 or when W is not a multiple of
// BLOCK_W, and K8b _attention_batched (_batched_kernel), BLOCK_W windows of
// one head per grid cell.  Numerics as there: f32 scores plus the f32 bias
// (unlike K1-K4, which round the bias to bf16), f32 softmax, p rounded to
// bf16 before the p.v product (split in f32), f32 accumulation.
//
// What bounds it on an H100: at stage 2 of a serving bucket of 16
// (W=64, H=12, N=1024) the 1.03e11 flops of the two products (0.104 ms at
// the bf16 peak) and the 8.05e8 exponentials (~0.2 ms of the SMs'
// special-function units); at stage 1 (W=1024, H=6, N=256) the 403 MB of
// q, k, v and out (0.120 ms at 3.35 TB/s).  Beside those sits the f32 bias:
// 50 MB at stage 2, the whole L2.
//
// The bf16 entries of both run the Hopper forward core
// (attention_fwd_sm90.cuh, which K3 shares): TMA rings, the bias in
// 128-byte-swizzled boxes, wgmma for both products, persistent
// warp-specialised blocks walking (64-query tile, window group, head)
// items.  K8b, and K8a where its f32 tile fits (N up to 704 at hd 32), keep
// the item's 64 x N bias tile resident over a group of windows
// (window_attention._headmajor_groups); K8a above streams the bias in
// 128-key chunks that each serve the four windows of an item.  That
// header's comment gives the design and the budget at stage 2.
//
// The f32 entries of both run two launches of the same header:
// split_planes writes their f32 q, k and v as the bf16 hi and lo planes (2,
// W, N, 3 H hd) of the interleaved qkv into the wrapper's scratch
// (window_attention._qkv_planes), then the core's f32 kind reads them
// through one tensor map exactly as K2's and K9's f32 attention does (split
// products, the f32 bias resident over _headmajor_groups or streamed in
// items of two windows, the online softmax in f32 over chunks of two key
// tiles, p split in registers) and stores out head-major.  No port kernel
// writes K8's operands, so the split is a pass of its own: 604 MB at stage
// 2 of a bucket of 16 (K8a), 1.21 GB at stage 1 (K8b), against the
// attention's 1.1 and 0.6 ms.  K8b's f32 entry makes K8a's two launches
// with the same groups, so on the same inputs the two give the same bits.
#include "attention_fwd_sm90.cuh"

// C entry points: shapes validated by the Python wrapper (N a multiple of
// 64, head dim 16, 32 or 64).  q, k, v and out bf16 (or f32 for the _f32
// twins), bias f32.  `groups` is the core's window groups G
// (window_attention._headmajor_groups).  Every entry takes `planes`, a (2,
// W, N, 3 H hd) bf16 scratch for the f32 twins' split pass, which the bf16
// entries do not read.  Return cudaGetLastError() after the launch.

// K8a: the Hopper core at every N, the bias resident where it fits, else
// streamed.
extern "C" int attention_qtiled_bf16(const void* q, const void* k, const void* v,
                                     const void* bias, void* /*planes*/, void* out, int W, int H,
                                     int N, int hd, int groups, float scale, cudaStream_t stream) {
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    return (int)run<kHeadMajor, float, HD, true>(q, k, v, bias, out, W, H, N, groups, scale, stream);
  })
}

// Two launches: split_planes writes q's, k's and v's bf16 hi and lo planes
// into `planes` in the interleaved layout, then the core's f32 kind reads
// them as K2's and K9's f32 attention does and stores out head-major.
extern "C" int attention_qtiled_f32(const void* q, const void* k, const void* v,
                                    const void* bias, void* planes, void* out, int W, int H, int N,
                                    int hd, int groups, float scale, cudaStream_t stream) {
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    const cudaError_t e = split_headmajor<HD>(q, k, v, planes, W, H, N, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)run_f32<HD, kHeadMajor>(planes, bias, out, W, H, N, groups, scale, stream);
  })
}

// K8b: the Hopper core with the bias resident (N below 512).
extern "C" int attention_batched_bf16(const void* q, const void* k, const void* v,
                                      const void* bias, void* /*planes*/, void* out, int W, int H,
                                      int N, int hd, int groups, float scale, cudaStream_t stream) {
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    return (int)run<kHeadMajor, float, HD, false>(q, k, v, bias, out, W, H, N, groups, scale,
                                                  stream);
  })
}

// K8a's two f32 launches (the f32 plan keeps the bias resident at K8b's N).
extern "C" int attention_batched_f32(const void* q, const void* k, const void* v,
                                     const void* bias, void* planes, void* out, int W, int H, int N,
                                     int hd, int groups, float scale, cudaStream_t stream) {
  return attention_qtiled_f32(q, k, v, bias, planes, out, W, H, N, hd, groups, scale, stream);
}

// The 128-row kind of K8a and K8b (window_attention.FWD_Q_ROWS = 128): hd
// 32, N a multiple of 128, `groups` walked a pair of windows at a time.
extern "C" int attention_qtiled_q128_bf16(const void* q, const void* k, const void* v,
                                          const void* bias, void* /*planes*/, void* out, int W,
                                          int H, int N, int hd, int groups, float scale,
                                          cudaStream_t stream) {
  using namespace gg::fwd90;
  if (hd != kRows128HeadDim) return (int)cudaErrorInvalidValue;
  return (int)run<kHeadMajor, float, kRows128HeadDim, true>(q, k, v, bias, out, W, H, N, groups,
                                                            scale, stream, 2 * kRows);
}

extern "C" int attention_batched_q128_bf16(const void* q, const void* k, const void* v,
                                           const void* bias, void* /*planes*/, void* out, int W,
                                           int H, int N, int hd, int groups, float scale,
                                           cudaStream_t stream) {
  using namespace gg::fwd90;
  if (hd != kRows128HeadDim) return (int)cudaErrorInvalidValue;
  return (int)run<kHeadMajor, float, kRows128HeadDim, false>(q, k, v, bias, out, W, H, N, groups,
                                                             scale, stream, 2 * kRows);
}

// The bf16 core's plans at (W, N, H, hd, G, rows) without a launch: out[8]
// as fwd90::plan fills it (the f32 bias; K8a may stream it, K8b not).
extern "C" int attention_qtiled_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::fwd90::plan(W, H, N, G, hd, 4, true, rows, out);
}

extern "C" int attention_batched_plan(int W, int N, int H, int hd, int G, int rows, int* out) {
  return (int)gg::fwd90::plan(W, H, N, G, hd, 4, false, rows, out);
}

// K8a's and K8b's f32 attention plans at (W, N, H, hd, G) without a
// launch: out[8] as fwd90::plan_f32 fills it (64-row items only; the same
// plan, since both run the same launches).
extern "C" int attention_qtiled_plan_f32(int W, int N, int H, int hd, int G, int rows, int* out) {
  if (rows != gg::fwd90::kRows) return (int)cudaErrorInvalidValue;
  return (int)gg::fwd90::plan_f32(W, H, N, G, hd, out);
}

extern "C" int attention_batched_plan_f32(int W, int N, int H, int hd, int G, int rows, int* out) {
  return attention_qtiled_plan_f32(W, N, H, hd, G, rows, out);
}
