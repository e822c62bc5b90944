// Device code shared by the two window-attention backward kernels of the
// port (K4 attention_qkv_bwd.cu, K5 attention_bwd_merged.cu).  Both compute
// the cotangents of
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
// The two kernels differ only in the bias type: K4 reads it as bf16 (the
// Pallas call casts it), K5 as f32.
//
// A Pallas kernel walks its grid in order on one core and can keep a whole
// (N, N) score row and a d_bias block resident in VMEM.  On Hopper the
// blocks run in parallel and an N=1024 row of f32 scores does not fit
// beside the rest, so the work is split into four launches that each
// recompute the scores of their 64x64 tiles (FlashAttention-2 style) and
// own their outputs, so nothing but d_bias needs a cross-block sum:
//
//   1. row statistics, per (q-tile, head, window): the row max m, 1/sum and
//      t = sum_row dp * p (two passes over the k-tiles);
//   2. dk, dv, per (k-tile, head, window): loops over the q-tiles;
//   3. dq, per (q-tile, head, window): loops over the k-tiles;
//   4. d_bias, per (k-tile, q-tile, head, window group): loops over the
//      windows of its group and sums ds in registers; groups are added with
//      f32 atomicAdd into a zeroed d_bias (one group per head and tile when
//      the grid is large enough: then the sum is deterministic).
//
// Every launch is one block of 4 warps; a warp owns 16 rows of a 64-row
// tile and uses mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Tiles of
// 64 rows x 32 dims go through shared memory either row-major (pitch
// kKPad, the B operand of a product over dims) or transposed (pitch
// kVPad, the B operand of a product over rows), as in common.cuh.
#pragma once

#include "common.cuh"

namespace gg {

constexpr int kBwdTile = 64;       // rows of a q-tile and of a k-tile
constexpr int kBiasPitch = 68;     // f32 pitch of the staged bias tile

__device__ __forceinline__ float2 bias_pair(const bf16* p) { return unpack_bf16(ld32(p)); }
__device__ __forceinline__ float2 bias_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float bias_one(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float bias_one(const float* p) { return *p; }

// 16 rows x 32 dims of a row-major bf16 matrix (row pitch ld) as the A
// fragments of the two k-steps over dims 0-15 and 16-31.
__device__ __forceinline__ void load_a16x32(uint32_t a[2][4], const bf16* p, long ld, int g,
                                            int c) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const bf16* r0 = p + (long)g * ld + s * 16 + 2 * c;
    const bf16* r1 = r0 + 8 * ld;
    a[s][0] = ld32(r0);
    a[s][1] = ld32(r1);
    a[s][2] = ld32(r0 + 8);
    a[s][3] = ld32(r1 + 8);
  }
}

// Copies 64 rows x 32 dims (row pitch ld) into shared memory: row-major
// into rowt (pitch kKPad) and/or transposed into trt (pitch kVPad).
template <bool ROW, bool TRANS>
__device__ __forceinline__ void stage64x32(bf16* rowt, bf16* trt, const bf16* src, long ld,
                                           int tid) {
  for (int i = tid; i < kBwdTile * 4; i += 128) {
    const int r = i >> 2, ch = i & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (long)r * ld + ch * 8);
    if (ROW) *reinterpret_cast<uint4*>(&rowt[r * kKPad + ch * 8]) = v;
    if (TRANS) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) trt[(ch * 8 + j) * kVPad + r] = e[j];
    }
  }
}

// acc (16 x 64) = A (16 x 32) . B^T, B the 64 row-major rows of rowt.
__device__ __forceinline__ void mma_16x64_k32(float acc[8][4], const uint32_t a[2][4],
                                              const bf16* rowt, int g, int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    const bf16* r = &rowt[(nt * 8 + g) * kKPad + 2 * c];
#pragma unroll
    for (int st = 0; st < 2; ++st) mma_bf16_16816(acc[nt], a[st], ld32(r + st * 16), ld32(r + st * 16 + 8));
  }
}

// acc (16 x 32) += bf16(x) (16 x 64, an accumulator tile) . B (64 x 32),
// B held transposed in trt.  The accumulators of n-tiles 2kk and 2kk+1 are
// exactly the A fragment of k-step kk.
__device__ __forceinline__ void mma_16x32_k64(float acc[4][4], const float x[8][4],
                                              const bf16* trt, int g, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const bf16* r = &trt[(d * 8 + g) * kVPad + kk * 16 + 2 * c];
      mma_bf16_16816(acc[d], a, ld32(r), ld32(r + 8));
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shape of one call: qkv (W, N, 3D), g (W, N, D), D = H * kHd; stats are
// three (W, H, N) f32 planes: row max, 1 / row sum, t.
struct BwdArgs {
  const bf16* qkv;
  const bf16* g;
  bf16* dqkv;
  float* dbias;
  float* stats;
  int W, N, H;
  float scale;
};

__device__ __forceinline__ long stat_index(const BwdArgs& a, int w, int h, int row) {
  return ((long)w * a.H + h) * a.N + row;
}

// s (16 queries x 64 keys) of one tile -> scaled + bias, in place.
template <typename BiasT>
__device__ __forceinline__ void add_bias(float s[8][4], const BiasT* brow0, const BiasT* brow1,
                                         int k0, float scale, int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = k0 + nt * 8 + 2 * c;
    const float2 b0 = bias_pair(brow0 + col);
    const float2 b1 = bias_pair(brow1 + col);
    s[nt][0] = s[nt][0] * scale + b0.x;
    s[nt][1] = s[nt][1] * scale + b0.y;
    s[nt][2] = s[nt][2] * scale + b1.x;
    s[nt][3] = s[nt][3] * scale + b1.y;
  }
}

// ---------------------------------------------------------------------------
// 1. Row statistics.  grid (N/64, H, W).
// ---------------------------------------------------------------------------
template <typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_stats_kernel(BwdArgs a, const BiasT* __restrict__ bias) {
  __shared__ __align__(16) bf16 ks[kBwdTile * kKPad];
  __shared__ __align__(16) bf16 vs[kBwdTile * kKPad];
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * kHd;
  const long ld = 3L * D;
  const bf16* base = a.qkv + (long)w * N * ld + (long)h * 3 * kHd;
  const int q0 = blockIdx.x * kBwdTile + warp * 16;

  uint32_t qa[2][4], ga[2][4];
  load_a16x32(qa, base + (long)q0 * ld, ld, g, c);
  load_a16x32(ga, a.g + ((long)w * N + q0) * D + h * kHd, D, g, c);
  const BiasT* brow0 = bias + ((long)h * N + q0 + g) * N;
  const BiasT* brow1 = brow0 + 8L * N;

  // Pass 1: running row max and this thread's share of the row sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < N; k0 += kBwdTile) {
    __syncthreads();
    stage64x32<true, false>(ks, nullptr, base + (long)k0 * ld + kHd, ld, tid);
    __syncthreads();
    mma_16x64_k32(s, qa, ks, g, c);
    add_bias(s, brow0, brow1, k0, a.scale, c);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      r0 += __expf(s[nt][0] - mx0) + __expf(s[nt][1] - mx0);
      r1 += __expf(s[nt][2] - mx1) + __expf(s[nt][3] - mx1);
    }
    l0 = l0 * __expf(m0 - mx0) + r0;
    l1 = l1 * __expf(m1 - mx1) + r1;
    m0 = mx0;
    m1 = mx1;
  }
  const float il0 = 1.f / quad_sum(l0), il1 = 1.f / quad_sum(l1);

  // Pass 2: t = sum_row dp * p with the final p.
  float t0 = 0.f, t1 = 0.f;
  for (int k0 = 0; k0 < N; k0 += kBwdTile) {
    __syncthreads();
    stage64x32<true, false>(ks, nullptr, base + (long)k0 * ld + kHd, ld, tid);
    stage64x32<true, false>(vs, nullptr, base + (long)k0 * ld + 2 * kHd, ld, tid);
    __syncthreads();
    mma_16x64_k32(s, qa, ks, g, c);
    mma_16x64_k32(dp, ga, vs, g, c);
    add_bias(s, brow0, brow1, k0, a.scale, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      t0 += __expf(s[nt][0] - m0) * il0 * dp[nt][0] + __expf(s[nt][1] - m0) * il0 * dp[nt][1];
      t1 += __expf(s[nt][2] - m1) * il1 * dp[nt][2] + __expf(s[nt][3] - m1) * il1 * dp[nt][3];
    }
  }
  t0 = quad_sum(t0);
  t1 = quad_sum(t1);
  if (c == 0) {
    const long plane = (long)a.W * a.H * N;
    const long i0 = stat_index(a, w, h, q0 + g), i1 = i0 + 8;
    a.stats[i0] = m0;
    a.stats[i1] = m1;
    a.stats[plane + i0] = il0;
    a.stats[plane + i1] = il1;
    a.stats[2 * plane + i0] = t0;
    a.stats[2 * plane + i1] = t1;
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv.  grid (N/64, H, W); a warp owns 16 keys and loops over all
// q-tiles, so its dk and dv rows are complete in registers.
// ---------------------------------------------------------------------------
template <typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_kernel(BwdArgs a, const BiasT* __restrict__ bias) {
  __shared__ __align__(16) bf16 qs[kBwdTile * kKPad];
  __shared__ __align__(16) bf16 gs[kBwdTile * kKPad];
  __shared__ __align__(16) bf16 qt[kHd * kVPad];
  __shared__ __align__(16) bf16 gt[kHd * kVPad];
  __shared__ float bsm[kBwdTile * kBiasPitch];
  __shared__ float ms[kBwdTile], ils[kBwdTile], ts[kBwdTile];
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * kHd;
  const long ld = 3L * D;
  const bf16* base = a.qkv + (long)w * N * ld + (long)h * 3 * kHd;
  const bf16* gbase = a.g + (long)w * N * D + h * kHd;
  const int kb = blockIdx.x * kBwdTile;     // the block's first key
  const int kr = warp * 16;                 // the warp's first key within the tile
  const long plane = (long)a.W * a.H * N;
  const float* st = a.stats + stat_index(a, w, h, 0);

  uint32_t ka[2][4], va[2][4];
  load_a16x32(ka, base + (long)(kb + kr) * ld + kHd, ld, g, c);
  load_a16x32(va, base + (long)(kb + kr) * ld + 2 * kHd, ld, g, c);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[d][i] = dv[d][i] = 0.f;

  float s[8][4], dp[8][4];
  for (int q0 = 0; q0 < N; q0 += kBwdTile) {
    __syncthreads();
    stage64x32<true, true>(qs, qt, base + (long)q0 * ld, ld, tid);
    stage64x32<true, true>(gs, gt, gbase + (long)q0 * D, D, tid);
    for (int i = tid; i < kBwdTile * kBwdTile; i += 128) {
      const int r = i >> 6, col = i & 63;
      bsm[r * kBiasPitch + col] = bias_one(bias + ((long)h * N + q0 + r) * N + kb + col);
    }
    if (tid < kBwdTile) {
      ms[tid] = st[q0 + tid];
      ils[tid] = st[plane + q0 + tid];
      ts[tid] = st[2 * plane + q0 + tid];
    }
    __syncthreads();
    // s^T (16 keys x 64 queries) and dp^T.
    mma_16x64_k32(s, ka, qs, g, c);
    mma_16x64_k32(dp, va, gs, g, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = nt * 8 + 2 * c + (i & 1);
        const int key = kr + g + (i >> 1) * 8;
        const float p = __expf(s[nt][i] * a.scale + bsm[q * kBiasPitch + key] - ms[q]) * ils[q];
        s[nt][i] = p;
        dp[nt][i] = p * (dp[nt][i] - ts[q]);
      }
    }
    mma_16x32_k64(dv, s, gt, g, c);
    mma_16x32_k64(dk, dp, qt, g, c);
  }

  bf16* out0 = a.dqkv + ((long)w * N + kb + kr + g) * ld + (long)h * 3 * kHd + 2 * c;
  bf16* out1 = out0 + 8 * ld;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float sc = a.scale;
    *reinterpret_cast<uint32_t*>(out0 + kHd + d * 8) = pack_bf16(dk[d][0] * sc, dk[d][1] * sc);
    *reinterpret_cast<uint32_t*>(out1 + kHd + d * 8) = pack_bf16(dk[d][2] * sc, dk[d][3] * sc);
    *reinterpret_cast<uint32_t*>(out0 + 2 * kHd + d * 8) = pack_bf16(dv[d][0], dv[d][1]);
    *reinterpret_cast<uint32_t*>(out1 + 2 * kHd + d * 8) = pack_bf16(dv[d][2], dv[d][3]);
  }
}

// ---------------------------------------------------------------------------
// 3. dq.  grid (N/64, H, W); a warp owns 16 queries and loops over k-tiles.
// ---------------------------------------------------------------------------
template <typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(BwdArgs a, const BiasT* __restrict__ bias) {
  __shared__ __align__(16) bf16 ks[kBwdTile * kKPad];
  __shared__ __align__(16) bf16 vs[kBwdTile * kKPad];
  __shared__ __align__(16) bf16 kt[kHd * kVPad];
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * kHd;
  const long ld = 3L * D;
  const bf16* base = a.qkv + (long)w * N * ld + (long)h * 3 * kHd;
  const int q0 = blockIdx.x * kBwdTile + warp * 16;
  const long plane = (long)a.W * a.H * N;
  const long i0 = stat_index(a, w, h, q0 + g), i1 = i0 + 8;
  const float m0 = a.stats[i0], m1 = a.stats[i1];
  const float il0 = a.stats[plane + i0], il1 = a.stats[plane + i1];
  const float t0 = a.stats[2 * plane + i0], t1 = a.stats[2 * plane + i1];

  uint32_t qa[2][4], ga[2][4];
  load_a16x32(qa, base + (long)q0 * ld, ld, g, c);
  load_a16x32(ga, a.g + ((long)w * N + q0) * D + h * kHd, D, g, c);
  const BiasT* brow0 = bias + ((long)h * N + q0 + g) * N;
  const BiasT* brow1 = brow0 + 8L * N;
  float dq[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[d][i] = 0.f;

  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < N; k0 += kBwdTile) {
    __syncthreads();
    stage64x32<true, true>(ks, kt, base + (long)k0 * ld + kHd, ld, tid);
    stage64x32<true, false>(vs, nullptr, base + (long)k0 * ld + 2 * kHd, ld, tid);
    __syncthreads();
    mma_16x64_k32(s, qa, ks, g, c);
    mma_16x64_k32(dp, ga, vs, g, c);
    add_bias(s, brow0, brow1, k0, a.scale, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p;
      p = __expf(s[nt][0] - m0) * il0;
      s[nt][0] = p * (dp[nt][0] - t0);
      p = __expf(s[nt][1] - m0) * il0;
      s[nt][1] = p * (dp[nt][1] - t0);
      p = __expf(s[nt][2] - m1) * il1;
      s[nt][2] = p * (dp[nt][2] - t1);
      p = __expf(s[nt][3] - m1) * il1;
      s[nt][3] = p * (dp[nt][3] - t1);
    }
    mma_16x32_k64(dq, s, kt, g, c);
  }

  bf16* out0 = a.dqkv + ((long)w * N + q0 + g) * ld + (long)h * 3 * kHd + 2 * c;
  bf16* out1 = out0 + 8 * ld;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    *reinterpret_cast<uint32_t*>(out0 + d * 8) = pack_bf16(dq[d][0] * a.scale, dq[d][1] * a.scale);
    *reinterpret_cast<uint32_t*>(out1 + d * 8) = pack_bf16(dq[d][2] * a.scale, dq[d][3] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// 4. d_bias.  grid (N/64 k-tiles, N/64 q-tiles, H * groups); the block sums
// ds of one 64x64 tile over the windows of its group in registers.
// ---------------------------------------------------------------------------
template <typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_dbias_kernel(BwdArgs a, const BiasT* __restrict__ bias, int per_group) {
  __shared__ __align__(16) bf16 ks[kBwdTile * kKPad];
  __shared__ __align__(16) bf16 vs[kBwdTile * kKPad];
  const int h = blockIdx.z % a.H, grp = blockIdx.z / a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * kHd;
  const long ld = 3L * D;
  const int k0 = blockIdx.x * kBwdTile;
  const int q0 = blockIdx.y * kBwdTile + warp * 16;
  const long plane = (long)a.W * a.H * N;
  const BiasT* brow0 = bias + ((long)h * N + q0 + g) * N;
  const BiasT* brow1 = brow0 + 8L * N;
  const int w_end = min(a.W, (grp + 1) * per_group);

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  float s[8][4], dp[8][4];
  for (int w = grp * per_group; w < w_end; ++w) {
    const bf16* base = a.qkv + (long)w * N * ld + (long)h * 3 * kHd;
    __syncthreads();
    stage64x32<true, false>(ks, nullptr, base + (long)k0 * ld + kHd, ld, tid);
    stage64x32<true, false>(vs, nullptr, base + (long)k0 * ld + 2 * kHd, ld, tid);
    __syncthreads();
    uint32_t qa[2][4], ga[2][4];
    load_a16x32(qa, base + (long)q0 * ld, ld, g, c);
    load_a16x32(ga, a.g + ((long)w * N + q0) * D + h * kHd, D, g, c);
    const long i0 = stat_index(a, w, h, q0 + g), i1 = i0 + 8;
    const float m0 = a.stats[i0], m1 = a.stats[i1];
    const float il0 = a.stats[plane + i0], il1 = a.stats[plane + i1];
    const float t0 = a.stats[2 * plane + i0], t1 = a.stats[2 * plane + i1];
    mma_16x64_k32(s, qa, ks, g, c);
    mma_16x64_k32(dp, ga, vs, g, c);
    add_bias(s, brow0, brow1, k0, a.scale, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] += __expf(s[nt][0] - m0) * il0 * (dp[nt][0] - t0);
      acc[nt][1] += __expf(s[nt][1] - m0) * il0 * (dp[nt][1] - t0);
      acc[nt][2] += __expf(s[nt][2] - m1) * il1 * (dp[nt][2] - t1);
      acc[nt][3] += __expf(s[nt][3] - m1) * il1 * (dp[nt][3] - t1);
    }
  }

  float* d0 = a.dbias + ((long)h * N + q0 + g) * N + k0 + 2 * c;
  float* d1 = d0 + 8L * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    atomicAdd(d0 + nt * 8, acc[nt][0]);
    atomicAdd(d0 + nt * 8 + 1, acc[nt][1]);
    atomicAdd(d1 + nt * 8, acc[nt][2]);
    atomicAdd(d1 + nt * 8 + 1, acc[nt][3]);
  }
}

// d_bias blocks the launcher aims for (8 per SM of an H100's 132).
constexpr int kDbiasTargetBlocks = 1056;

template <typename BiasT>
inline cudaError_t launch_attention_bwd(const BwdArgs& a, const BiasT* bias,
                                        cudaStream_t stream) {
  const dim3 rows(a.N / kBwdTile, a.H, a.W);
  attn_bwd_stats_kernel<BiasT><<<rows, 128, 0, stream>>>(a, bias);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<BiasT><<<rows, 128, 0, stream>>>(a, bias);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn_bwd_dq_kernel<BiasT><<<rows, 128, 0, stream>>>(a, bias);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = cudaMemsetAsync(a.dbias, 0, sizeof(float) * a.H * a.N * a.N, stream);
  if (e != cudaSuccess) return e;
  const int tiles = (a.N / kBwdTile) * (a.N / kBwdTile) * a.H;
  int groups = (kDbiasTargetBlocks + tiles - 1) / tiles;
  groups = groups < 1 ? 1 : (groups > a.W ? a.W : groups);
  const int per_group = (a.W + groups - 1) / groups;
  groups = (a.W + per_group - 1) / per_group;
  const dim3 tiles_grid(a.N / kBwdTile, a.N / kBwdTile, a.H * groups);
  attn_bwd_dbias_kernel<BiasT><<<tiles_grid, 128, 0, stream>>>(a, bias, per_group);
  return cudaGetLastError();
}

}  // namespace gg
