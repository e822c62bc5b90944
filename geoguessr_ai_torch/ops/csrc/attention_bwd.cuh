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
// The two kernels differ only in the bias type: K4 reads it in the
// activations' type (the Pallas call casts it), K5 as f32.  Every kernel
// here is a template over that type E (common.cuh "Element types"): in
// f32, qkv, g and d_qkv are f32, the products split their operands into
// bf16 (hi, lo) pairs, and p and ds are split, not rounded.
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
//   4. d_bias, per (k-tile, q-tile, head): walks all W windows in order and
//      sums ds in registers, then stores its tile.  No atomics, so d_bias
//      is bitwise the same from run to run, as the Pallas kernels' sum in
//      grid order is (K7's second launch is this kernel too).
//
// Every launch is one block of 4 warps; a warp owns 16 rows of a 64-row
// tile and uses mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Tiles of
// 64 rows x HD dims (HD = 16, 32 or 64, common.cuh HeadDim) go through
// shared memory either row-major (pitch HD + 8, the B operand of a product
// over dims) or transposed (pitch kVPad, the B operand of a product over
// rows), as in common.cuh.
#pragma once

#include "common.cuh"

namespace gg {

constexpr int kBwdTile = 64;       // rows of a q-tile and of a k-tile
constexpr int kBiasPitch = 68;     // f32 pitch of the staged bias tile

// 16 rows x HD dims of a row-major matrix (row pitch ld) as the A
// fragments of the k-steps over dims 0-15, 16-31, ...
template <class E, int HD>
__device__ __forceinline__ void load_a16(Frag<E> a[HeadDim<HD>::kSteps][4], const E* p, long ld,
                                         int g, int c) {
#pragma unroll
  for (int s = 0; s < HeadDim<HD>::kSteps; ++s) {
    const E* r0 = p + (long)g * ld + s * 16 + 2 * c;
    const E* r1 = r0 + 8 * ld;
    a[s][0] = frag(r0);
    a[s][1] = frag(r1);
    a[s][2] = frag(r0 + 8);
    a[s][3] = frag(r1 + 8);
  }
}

// Copies 64 rows x HD dims (row pitch ld) into shared memory: row-major
// into rowt (pitch HD + 8) and/or transposed into trt (pitch kVPad).
template <class T>
struct NonDeduced {
  using type = T;
};

template <int HD, bool ROW, bool TRANS, class E>
__device__ __forceinline__ void stage64(E* rowt, typename NonDeduced<E>::type* trt, const E* src,
                                        long ld, int tid) {
  using T = HeadDim<HD>;
  for (int i = tid; i < kBwdTile * T::kVecs; i += 128) {
    const int r = i / T::kVecs, ch = i % T::kVecs;
    const Vec8<E> v = load8(src + (long)r * ld + ch * 8);
    if (ROW) store8(&rowt[r * T::kPad + ch * 8], v);
    if (TRANS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) trt[(ch * 8 + j) * kVPad + r] = v[j];
    }
  }
}

// acc (16 x 64) = A (16 x HD) . B^T, B the 64 row-major rows of rowt.
template <int HD, class E>
__device__ __forceinline__ void mma_16x64(float acc[8][4],
                                          const Frag<E> a[HeadDim<HD>::kSteps][4],
                                          const E* rowt, int g, int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    const E* r = &rowt[(nt * 8 + g) * HeadDim<HD>::kPad + 2 * c];
#pragma unroll
    for (int st = 0; st < HeadDim<HD>::kSteps; ++st)
      mma(acc[nt], a[st], frag(r + st * 16), frag(r + st * 16 + 8));
  }
}

// acc (16 x HD) += bf16(x) (16 x 64, an accumulator tile; split in f32) .
// B (64 x HD), B held transposed in trt.  The accumulators of n-tiles 2kk
// and 2kk+1 are exactly the A fragment of k-step kk.
template <int HD, class E>
__device__ __forceinline__ void mma_16xhd_k64(float acc[HeadDim<HD>::kTiles][4],
                                              const float x[8][4], const E* trt, int g, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Frag<E> a[4];
    a[0] = pack_frag<E>(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_frag<E>(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_frag<E>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_frag<E>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int d = 0; d < HeadDim<HD>::kTiles; ++d) {
      const E* r = &trt[(d * 8 + g) * kVPad + kk * 16 + 2 * c];
      mma(acc[d], a, frag(r), frag(r + 8));
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

// s (16 queries x 64 keys) of one tile -> scaled + bias, in place.
template <typename BiasT>
__device__ __forceinline__ void add_bias(float s[8][4], const BiasT* brow0, const BiasT* brow1,
                                         int k0, float scale, int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = k0 + nt * 8 + 2 * c;
    const float2 b0 = load2(brow0 + col);
    const float2 b1 = load2(brow1 + col);
    s[nt][0] = s[nt][0] * scale + b0.x;
    s[nt][1] = s[nt][1] * scale + b0.y;
    s[nt][2] = s[nt][2] * scale + b1.x;
    s[nt][3] = s[nt][3] * scale + b1.y;
  }
}

// Bytes of dynamic shared memory of the dk/dv phase (K4/K5's launch 2, K7's
// launch 1): q and g row-major and transposed, a 64 x 64 f32 bias tile and
// the 64 rows' statistics; 55 KB at HD = 64 in bf16 and 92 KB in f32,
// over the 48 KB a block gets without
// cudaFuncAttributeMaxDynamicSharedMemorySize.
template <class E, int HD>
struct DkdvSmem {
  static constexpr int kRowTile =
      kBwdTile * HeadDim<HD>::kPad * sizeof(E);                 // a row-major 64 x HD tile
  static constexpr int kTrTile = HD * kVPad * sizeof(E);        // a transposed one
  static constexpr int bytes =
      2 * kRowTile + 2 * kTrTile + kBwdTile * kBiasPitch * 4 + 3 * kBwdTile * 4;
};

// Bytes of shared memory of the dq phase: k row-major and transposed, v
// row-major; 55 KB at HD = 64 in f32, so the dq kernel takes it dynamic.
template <class E, int HD>
struct DqSmem {
  static constexpr int bytes =
      2 * DkdvSmem<E, HD>::kRowTile + DkdvSmem<E, HD>::kTrTile;
};

// ---------------------------------------------------------------------------
// 1. Row statistics.  grid (N/64, H, W).
// ---------------------------------------------------------------------------
template <class E, int HD, typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_stats_kernel(BwdArgs<E> a, const BiasT* __restrict__ bias) {
  using T = HeadDim<HD>;
  __shared__ __align__(16) E ks[kBwdTile * T::kPad];
  __shared__ __align__(16) E vs[kBwdTile * T::kPad];
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * HD;
  const long ld = 3L * D;
  const E* base = a.qkv + (long)w * N * ld + (long)h * 3 * HD;
  const int q0 = blockIdx.x * kBwdTile + warp * 16;

  Frag<E> qa[T::kSteps][4], ga[T::kSteps][4];
  load_a16<E, HD>(qa, base + (long)q0 * ld, ld, g, c);
  load_a16<E, HD>(ga, a.g + ((long)w * N + q0) * D + h * HD, D, g, c);
  const BiasT* brow0 = bias + ((long)h * N + q0 + g) * N;
  const BiasT* brow1 = brow0 + 8L * N;

  // Pass 1: running row max and this thread's share of the row sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < N; k0 += kBwdTile) {
    __syncthreads();
    stage64<HD, true, false>(ks, nullptr, base + (long)k0 * ld + HD, ld, tid);
    __syncthreads();
    mma_16x64<HD>(s, qa, ks, g, c);
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
    stage64<HD, true, false>(ks, nullptr, base + (long)k0 * ld + HD, ld, tid);
    stage64<HD, true, false>(vs, nullptr, base + (long)k0 * ld + 2 * HD, ld, tid);
    __syncthreads();
    mma_16x64<HD>(s, qa, ks, g, c);
    mma_16x64<HD>(dp, ga, vs, g, c);
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
// q-tiles, so its dk and dv rows are complete in registers.  Dynamic shared
// memory of DkdvSmem<HD>::bytes.
// ---------------------------------------------------------------------------
template <class E, int HD, typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_kernel(BwdArgs<E> a, const BiasT* __restrict__ bias) {
  using T = HeadDim<HD>;
  using S = DkdvSmem<E, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* qs = reinterpret_cast<E*>(smem);
  E* gs = reinterpret_cast<E*>(smem + S::kRowTile);
  E* qt = reinterpret_cast<E*>(smem + 2 * S::kRowTile);
  E* gt = reinterpret_cast<E*>(smem + 2 * S::kRowTile + S::kTrTile);
  float* bsm = reinterpret_cast<float*>(smem + 2 * S::kRowTile + 2 * S::kTrTile);
  float* ms = bsm + kBwdTile * kBiasPitch;
  float* ils = ms + kBwdTile;
  float* ts = ils + kBwdTile;
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * HD;
  const long ld = 3L * D;
  const E* base = a.qkv + (long)w * N * ld + (long)h * 3 * HD;
  const E* gbase = a.g + (long)w * N * D + h * HD;
  const int kb = blockIdx.x * kBwdTile;     // the block's first key
  const int kr = warp * 16;                 // the warp's first key within the tile
  const long plane = (long)a.W * a.H * N;
  const float* st = a.stats + stat_index(a, w, h, 0);

  Frag<E> ka[T::kSteps][4], va[T::kSteps][4];
  load_a16<E, HD>(ka, base + (long)(kb + kr) * ld + HD, ld, g, c);
  load_a16<E, HD>(va, base + (long)(kb + kr) * ld + 2 * HD, ld, g, c);
  float dk[T::kTiles][4], dv[T::kTiles][4];
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[d][i] = dv[d][i] = 0.f;

  float s[8][4], dp[8][4];
  for (int q0 = 0; q0 < N; q0 += kBwdTile) {
    __syncthreads();
    stage64<HD, true, true>(qs, qt, base + (long)q0 * ld, ld, tid);
    stage64<HD, true, true>(gs, gt, gbase + (long)q0 * D, D, tid);
    for (int i = tid; i < kBwdTile * kBwdTile; i += 128) {
      const int r = i >> 6, col = i & 63;
      bsm[r * kBiasPitch + col] = to_f(bias[((long)h * N + q0 + r) * N + kb + col]);
    }
    if (tid < kBwdTile) {
      ms[tid] = st[q0 + tid];
      ils[tid] = st[plane + q0 + tid];
      ts[tid] = st[2 * plane + q0 + tid];
    }
    __syncthreads();
    // s^T (16 keys x 64 queries) and dp^T.
    mma_16x64<HD>(s, ka, qs, g, c);
    mma_16x64<HD>(dp, va, gs, g, c);
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
    mma_16xhd_k64<HD>(dv, s, gt, g, c);
    mma_16xhd_k64<HD>(dk, dp, qt, g, c);
  }

  E* out0 = a.dqkv + ((long)w * N + kb + kr + g) * ld + (long)h * 3 * HD + 2 * c;
  E* out1 = out0 + 8 * ld;
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d) {
    const float sc = a.scale;
    store2(out0 + HD + d * 8, dk[d][0] * sc, dk[d][1] * sc);
    store2(out1 + HD + d * 8, dk[d][2] * sc, dk[d][3] * sc);
    store2(out0 + 2 * HD + d * 8, dv[d][0], dv[d][1]);
    store2(out1 + 2 * HD + d * 8, dv[d][2], dv[d][3]);
  }
}

// ---------------------------------------------------------------------------
// 3. dq.  grid (N/64, H, W); a warp owns 16 queries and loops over k-tiles.
// Dynamic shared memory of DqSmem<E, HD>::bytes.
// ---------------------------------------------------------------------------
template <class E, int HD, typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(BwdArgs<E> a, const BiasT* __restrict__ bias) {
  using T = HeadDim<HD>;
  constexpr int kRowTile = DkdvSmem<E, HD>::kRowTile;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = reinterpret_cast<E*>(smem + kRowTile);
  E* kt = reinterpret_cast<E*>(smem + 2 * kRowTile);
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * HD;
  const long ld = 3L * D;
  const E* base = a.qkv + (long)w * N * ld + (long)h * 3 * HD;
  const int q0 = blockIdx.x * kBwdTile + warp * 16;
  const long plane = (long)a.W * a.H * N;
  const long i0 = stat_index(a, w, h, q0 + g), i1 = i0 + 8;
  const float m0 = a.stats[i0], m1 = a.stats[i1];
  const float il0 = a.stats[plane + i0], il1 = a.stats[plane + i1];
  const float t0 = a.stats[2 * plane + i0], t1 = a.stats[2 * plane + i1];

  Frag<E> qa[T::kSteps][4], ga[T::kSteps][4];
  load_a16<E, HD>(qa, base + (long)q0 * ld, ld, g, c);
  load_a16<E, HD>(ga, a.g + ((long)w * N + q0) * D + h * HD, D, g, c);
  const BiasT* brow0 = bias + ((long)h * N + q0 + g) * N;
  const BiasT* brow1 = brow0 + 8L * N;
  float dq[T::kTiles][4];
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[d][i] = 0.f;

  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < N; k0 += kBwdTile) {
    __syncthreads();
    stage64<HD, true, true>(ks, kt, base + (long)k0 * ld + HD, ld, tid);
    stage64<HD, true, false>(vs, nullptr, base + (long)k0 * ld + 2 * HD, ld, tid);
    __syncthreads();
    mma_16x64<HD>(s, qa, ks, g, c);
    mma_16x64<HD>(dp, ga, vs, g, c);
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
    mma_16xhd_k64<HD>(dq, s, kt, g, c);
  }

  E* out0 = a.dqkv + ((long)w * N + q0 + g) * ld + (long)h * 3 * HD + 2 * c;
  E* out1 = out0 + 8 * ld;
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d) {
    store2(out0 + d * 8, dq[d][0] * a.scale, dq[d][1] * a.scale);
    store2(out1 + d * 8, dq[d][2] * a.scale, dq[d][3] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// 4. d_bias.  grid (N/64 k-tiles, N/64 q-tiles, H); the block sums ds of its
// 64 x 64 tile over all W windows, in window order, and stores it.
// ---------------------------------------------------------------------------
template <class E, int HD, typename BiasT>
__global__ void __launch_bounds__(128)
attn_bwd_dbias_kernel(BwdArgs<E> a, const BiasT* __restrict__ bias) {
  using T = HeadDim<HD>;
  __shared__ __align__(16) E ks[kBwdTile * T::kPad];
  __shared__ __align__(16) E vs[kBwdTile * T::kPad];
  const int h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * HD;
  const long ld = 3L * D;
  const int k0 = blockIdx.x * kBwdTile;
  const int q0 = blockIdx.y * kBwdTile + warp * 16;
  const long plane = (long)a.W * a.H * N;
  const BiasT* brow0 = bias + ((long)h * N + q0 + g) * N;
  const BiasT* brow1 = brow0 + 8L * N;

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  float s[8][4], dp[8][4];
  for (int w = 0; w < a.W; ++w) {
    const E* base = a.qkv + (long)w * N * ld + (long)h * 3 * HD;
    __syncthreads();
    stage64<HD, true, false>(ks, nullptr, base + (long)k0 * ld + HD, ld, tid);
    stage64<HD, true, false>(vs, nullptr, base + (long)k0 * ld + 2 * HD, ld, tid);
    __syncthreads();
    Frag<E> qa[T::kSteps][4], ga[T::kSteps][4];
    load_a16<E, HD>(qa, base + (long)q0 * ld, ld, g, c);
    load_a16<E, HD>(ga, a.g + ((long)w * N + q0) * D + h * HD, D, g, c);
    const long i0 = stat_index(a, w, h, q0 + g), i1 = i0 + 8;
    const float m0 = a.stats[i0], m1 = a.stats[i1];
    const float il0 = a.stats[plane + i0], il1 = a.stats[plane + i1];
    const float t0 = a.stats[2 * plane + i0], t1 = a.stats[2 * plane + i1];
    mma_16x64<HD>(s, qa, ks, g, c);
    mma_16x64<HD>(dp, ga, vs, g, c);
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
    *reinterpret_cast<float2*>(d0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(d1 + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int HD, class E, typename BiasT>
inline cudaError_t launch_dbias(const BwdArgs<E>& a, const BiasT* bias, cudaStream_t stream) {
  attn_bwd_dbias_kernel<E, HD, BiasT>
      <<<dim3(a.N / kBwdTile, a.N / kBwdTile, a.H), 128, 0, stream>>>(a, bias);
  return cudaGetLastError();
}

template <int HD, class E, typename BiasT>
inline cudaError_t launch_attention_bwd_hd(const BwdArgs<E>& a, const BiasT* bias,
                                           cudaStream_t stream) {
  const dim3 rows(a.N / kBwdTile, a.H, a.W);
  attn_bwd_stats_kernel<E, HD, BiasT><<<rows, 128, 0, stream>>>(a, bias);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int smem = DkdvSmem<E, HD>::bytes;
  e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<E, HD, BiasT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<E, HD, BiasT><<<rows, 128, smem, stream>>>(a, bias);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  constexpr int dq_smem = DqSmem<E, HD>::bytes;
  e = cudaFuncSetAttribute(attn_bwd_dq_kernel<E, HD, BiasT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<E, HD, BiasT><<<rows, 128, dq_smem, stream>>>(a, bias);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_dbias<HD>(a, bias, stream);
}

template <class E, typename BiasT>
inline cudaError_t launch_attention_bwd(const BwdArgs<E>& a, const BiasT* bias, int hd,
                                        cudaStream_t stream) {
  GG_HEAD_DIM_SWITCH(hd, { return launch_attention_bwd_hd<HD>(a, bias, stream); })
}

}  // namespace gg
