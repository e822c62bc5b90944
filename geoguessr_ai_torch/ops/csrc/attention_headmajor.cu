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
// K8a's f32 twin runs two launches of the same header: split_planes writes
// its f32 q, k and v as the bf16 hi and lo planes (2, W, N, 3 H hd) of the
// interleaved qkv into the wrapper's scratch (window_attention.
// _qkv_planes), then the core's f32 kind reads them through one tensor map
// exactly as K2's and K9's f32 attention does (split products, the f32
// bias resident over _headmajor_groups or streamed in items of two
// windows, the online softmax in f32 over chunks of two key tiles, p split
// in registers) and stores out head-major.  No port kernel writes K8a's
// operands, so the split is a pass of its own: 604 MB at stage 2 of a
// bucket of 16, against the attention's 1.1 ms.
//
// K8b's f32 twin runs the first design: one core per 64-row q-tile, 4 warps
// of 16 query rows, k and v^T in tiles of 64 keys staged through shared
// memory by plain loads, the one-pass online softmax (running max and sum
// in f32, log2 domain) of common.cuh's window_attention_kernel on
// mma.sync.m16n8k16 with each f32 operand split into a bf16 (hi, lo) pair,
// a block's 64 bias rows staged in shared memory once for its BLOCK_W
// windows.  p is rounded relative to the running max, not the final one.
#include "attention_fwd_sm90.cuh"

namespace gg {
namespace {

constexpr int kBiasPad = 8;  // f32 pitch padding of K8b's staged bias rows

// The bias as K8b's f32 twin reads it: a pair of f32 values of query row
// `row`, key columns col, col + 1, from the block's 64 query rows staged in
// shared memory.
struct SharedBias {
  const float* base;
  int ld, row0;
  __device__ __forceinline__ float2 pair(int row, int col) const {
    return *reinterpret_cast<const float2*>(base + (long)(row - row0) * ld + col);
  }
};

// One 64-row q-tile of one (window, head): q, k, v and out point at that
// pair's (N, HD) slab.
template <int HD, class E, class BIAS>
__device__ __forceinline__ void attend_tile(const E* __restrict__ q, const E* __restrict__ k,
                                            const E* __restrict__ v, E* __restrict__ out,
                                            const BIAS& bias, int N, int q0, float scale, E* ks,
                                            E* vt) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  using T = HeadDim<HD>;
  constexpr int KP = T::kPad;

  Frag<E> qa[T::kSteps][4];
#pragma unroll
  for (int s = 0; s < T::kSteps; ++s) {
    const E* p0 = q + (long)r0 * HD + s * 16 + 2 * c;
    const E* p1 = q + (long)r1 * HD + s * 16 + 2 * c;
    qa[s][0] = frag(p0);
    qa[s][1] = frag(p1);
    qa[s][2] = frag(p0 + 8);
    qa[s][3] = frag(p1 + 8);
  }

  float o[T::kTiles][4];
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  const float sl2 = scale * kLog2e;

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // previous tile consumed (and K8b's bias staged)
    for (int i = tid; i < kBk * T::kVecs; i += 128) {
      const int key = i / T::kVecs, ch = i % T::kVecs;
      const long off = (long)(k0 + key) * HD + ch * 8;
      store8(&ks[key * KP + ch * 8], load8(k + off));
      const Vec8<E> vv = load8(v + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(ch * 8 + j) * kVPad + key] = vv[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const E* kr = &ks[(nt * 8 + g) * KP + 2 * c];
#pragma unroll
      for (int st = 0; st < T::kSteps; ++st)
        mma(s[nt], qa[st], frag(kr + st * 16), frag(kr + st * 16 + 8));
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * c;
      const float2 b0 = bias.pair(r0, col);
      const float2 b1 = bias.pair(r1, col);
      s[nt][0] = s[nt][0] * sl2 + b0.x * kLog2e;
      s[nt][1] = s[nt][1] * sl2 + b0.y * kLog2e;
      s[nt][2] = s[nt][2] * sl2 + b1.x * kLog2e;
      s[nt][3] = s[nt][3] * sl2 + b1.y * kLog2e;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int d = 0; d < T::kTiles; ++d) {
      o[d][0] *= alpha0;
      o[d][1] *= alpha0;
      o[d][2] *= alpha1;
      o[d][3] *= alpha1;
    }

    // o += bf16(p) v (p split in f32): the s accumulators of n-tiles 2kk
    // and 2kk+1 are the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag<E> pa[4];
      pa[0] = pack_frag<E>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_frag<E>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_frag<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_frag<E>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d) {
        const E* vr = &vt[(d * 8 + g) * kVPad + kk * 16 + 2 * c];
        mma(o[d], pa, frag(vr), frag(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  E* orow0 = out + (long)r0 * HD + 2 * c;
  E* orow1 = out + (long)r1 * HD + 2 * c;
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d) {
    store2(orow0 + d * 8, o[d][0] * inv0, o[d][1] * inv0);
    store2(orow1 + d * 8, o[d][2] * inv1, o[d][3] * inv1);
  }
}

// K8b: grid (N/64, H, W / bw); the block stages its 64 bias rows once and
// walks its bw windows in order.
template <class E, int HD>
__global__ void __launch_bounds__(128)
attention_batched_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const float* __restrict__ bias,
                         E* __restrict__ out, int H, int N, int bw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = N + kBiasPad;
  float* bs = reinterpret_cast<float*>(smem);
  E* ks = reinterpret_cast<E*>(bs + kBq * ld);
  E* vt = ks + kBk * HeadDim<HD>::kPad;
  const int q0 = blockIdx.x * kBq, h = blockIdx.y;

  const float* src = bias + ((long)h * N + q0) * N;
  const int quads = N / 4;
  for (int i = threadIdx.x; i < kBq * quads; i += 128) {
    const int r = i / quads, c4 = i - r * quads;
    *reinterpret_cast<float4*>(&bs[r * ld + c4 * 4]) =
        *reinterpret_cast<const float4*>(src + (long)r * N + c4 * 4);
  }
  const SharedBias sb{bs, ld, q0};
  const int w0 = blockIdx.z * bw;
  for (int w = w0; w < w0 + bw; ++w) {
    const long slab = ((long)w * H + h) * N * HD;
    attend_tile<HD>(q + slab, k + slab, v + slab, out + slab, sb, N, q0, scale, ks, vt);
  }
}

template <class E, int HD>
size_t batched_smem_bytes(int N) {
  return sizeof(float) * kBq * (N + kBiasPad) +
         sizeof(E) * (kBk * HeadDim<HD>::kPad + HD * kVPad);
}

template <class E>
int batched(const void* q, const void* k, const void* v, const void* bias, void* out, int W,
            int H, int N, int hd, int block_w, float scale, cudaStream_t stream) {
  if (block_w < 1 || W % block_w) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBq, H, W / block_w);
  GG_HEAD_DIM_SWITCH(hd, {
    const size_t smem = batched_smem_bytes<E, HD>(N);
    cudaError_t e = cudaFuncSetAttribute(attention_batched_kernel<E, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_batched_kernel<E, HD><<<grid, 128, smem, stream>>>(
        static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
        static_cast<const float*>(bias), static_cast<E*>(out), H, N, block_w, scale);
    return (int)cudaGetLastError();
  })
}

}  // namespace
}  // namespace gg

// C entry points: shapes validated by the Python wrapper (N a multiple of
// 64, head dim 16, 32 or 64).  q, k, v and out bf16 (or f32 for the _f32
// twins), bias f32.  `groups` is the core's window groups G
// (window_attention._headmajor_groups); K8b's f32 twin takes BLOCK_W
// windows a block there instead.  K8a's entries take `planes`, a (2, W, N,
// 3 H hd) bf16 scratch for the f32 twin's split pass, which the bf16
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
                                      const void* bias, void* out, int W, int H, int N, int hd,
                                      int groups, float scale, cudaStream_t stream) {
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    return (int)run<kHeadMajor, float, HD, false>(q, k, v, bias, out, W, H, N, groups, scale,
                                                  stream);
  })
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
                                           const void* bias, void* out, int W, int H, int N,
                                           int hd, int groups, float scale, cudaStream_t stream) {
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

// K8a's f32 attention plan at (W, N, H, hd, G) without a launch: out[8] as
// fwd90::plan_f32 fills it (64-row items only).
extern "C" int attention_qtiled_plan_f32(int W, int N, int H, int hd, int G, int rows, int* out) {
  if (rows != gg::fwd90::kRows) return (int)cudaErrorInvalidValue;
  return (int)gg::fwd90::plan_f32(W, H, N, G, hd, out);
}

extern "C" int attention_batched_f32(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int W, int H, int N, int hd,
                                     int block_w, float scale, cudaStream_t stream) {
  return gg::batched<float>(q, k, v, bias, out, W, H, N, hd, block_w, scale, stream);
}
