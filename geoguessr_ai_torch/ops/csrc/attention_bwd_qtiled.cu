// K7: the two-kernel large-N window-attention backward, d_qkv (W, N, 3D)
// in bf16 and d_bias (H, N, N) in f32 summed over the W windows, with an
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
// The first design (the _f32 twin below) ran the three d_qkv phases in
// series in one block per (head, window), 768 blocks each carrying a
// chain of ~800 mma.sync tile steps, at about 6 % of the bf16 peak.
// The _f32 twin takes qkv, g and d_qkv in f32; its dk/dv phase needs 92 KB
// of shared memory at head dim 64.
#include "attention_bwd_sm90.cuh"

namespace gg {
namespace {

// Shared memory of launch 1 is one dynamic buffer reused by its three
// phases: the dk/dv phase needs the most (DkdvSmem, attention_bwd.cuh).
template <class E, int HD>
__global__ void __launch_bounds__(128)
bwd_qtiled_k1_kernel(BwdArgs<E> a, const float* __restrict__ bias) {
  using T = HeadDim<HD>;
  constexpr int kRowTile = DkdvSmem<E, HD>::kRowTile;
  constexpr int kTrTile = DkdvSmem<E, HD>::kTrTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, w = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int N = a.N, D = a.H * HD;
  const long ld = 3L * D;
  const E* base = a.qkv + (long)w * N * ld + (long)h * 3 * HD;
  const E* gbase = a.g + (long)w * N * D + h * HD;
  const long plane = (long)a.W * a.H * N;
  float* st = a.stats + stat_index(a, w, h, 0);  // query r: st[r], st[plane + r], st[2 plane + r]
  E* out = a.dqkv + (long)w * N * ld + (long)h * 3 * HD;
  float s[8][4], dp[8][4];

  // 1. Row statistics, per 64-query tile: two passes over the k-tiles.
  {
    E* ks = reinterpret_cast<E*>(smem);
    E* vs = reinterpret_cast<E*>(smem + kRowTile);
    for (int qt0 = 0; qt0 < N; qt0 += kBwdTile) {
      const int q0 = qt0 + warp * 16;
      Frag<E> qa[T::kSteps][4], ga[T::kSteps][4];
      load_a16<E, HD>(qa, base + (long)q0 * ld, ld, g, c);
      load_a16<E, HD>(ga, gbase + (long)q0 * D, D, g, c);
      const float* brow0 = bias + ((long)h * N + q0 + g) * N;
      const float* brow1 = brow0 + 8L * N;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
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
        const int r = q0 + g;
        st[r] = m0;
        st[r + 8] = m1;
        st[plane + r] = il0;
        st[plane + r + 8] = il1;
        st[2 * plane + r] = t0;
        st[2 * plane + r + 8] = t1;
      }
    }
  }
  __syncthreads();  // every row's statistics written and visible to the block

  // 2. dk and dv, per 64-key tile: a warp owns 16 keys and loops over all
  // q-tiles, so its rows are complete in registers.
  {
    E* qs = reinterpret_cast<E*>(smem);
    E* gs = reinterpret_cast<E*>(smem + kRowTile);
    E* qt = reinterpret_cast<E*>(smem + 2 * kRowTile);
    E* gt = reinterpret_cast<E*>(smem + 2 * kRowTile + kTrTile);
    float* bsm = reinterpret_cast<float*>(smem + 2 * kRowTile + 2 * kTrTile);
    float* ms = bsm + kBwdTile * kBiasPitch;
    float* ils = ms + kBwdTile;
    float* ts = ils + kBwdTile;
    const int kr = warp * 16;
    for (int kb = 0; kb < N; kb += kBwdTile) {
      Frag<E> ka[T::kSteps][4], va[T::kSteps][4];
      load_a16<E, HD>(ka, base + (long)(kb + kr) * ld + HD, ld, g, c);
      load_a16<E, HD>(va, base + (long)(kb + kr) * ld + 2 * HD, ld, g, c);
      float dk[T::kTiles][4], dv[T::kTiles][4];
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[d][i] = dv[d][i] = 0.f;
      for (int q0 = 0; q0 < N; q0 += kBwdTile) {
        __syncthreads();
        stage64<HD, true, true>(qs, qt, base + (long)q0 * ld, ld, tid);
        stage64<HD, true, true>(gs, gt, gbase + (long)q0 * D, D, tid);
        for (int i = tid; i < kBwdTile * kBwdTile; i += 128) {
          const int r = i >> 6, col = i & 63;
          bsm[r * kBiasPitch + col] = bias[((long)h * N + q0 + r) * N + kb + col];
        }
        if (tid < kBwdTile) {
          ms[tid] = st[q0 + tid];
          ils[tid] = st[plane + q0 + tid];
          ts[tid] = st[2 * plane + q0 + tid];
        }
        __syncthreads();
        // s^T (16 keys x 64 queries) and dp^T
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
      E* out0 = out + (long)(kb + kr + g) * ld + 2 * c;
      E* out1 = out0 + 8 * ld;
      const float sc = a.scale;
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d) {
        store2(out0 + HD + d * 8, dk[d][0] * sc, dk[d][1] * sc);
        store2(out1 + HD + d * 8, dk[d][2] * sc, dk[d][3] * sc);
        store2(out0 + 2 * HD + d * 8, dv[d][0], dv[d][1]);
        store2(out1 + 2 * HD + d * 8, dv[d][2], dv[d][3]);
      }
    }
  }

  // 3. dq, per 64-query tile: a warp owns 16 queries and loops over the
  // k-tiles.
  {
    E* ks = reinterpret_cast<E*>(smem);
    E* vs = reinterpret_cast<E*>(smem + kRowTile);
    E* kt = reinterpret_cast<E*>(smem + 2 * kRowTile);
    for (int qt0 = 0; qt0 < N; qt0 += kBwdTile) {
      const int q0 = qt0 + warp * 16;
      const int r = q0 + g;
      const float m0 = st[r], m1 = st[r + 8];
      const float il0 = st[plane + r], il1 = st[plane + r + 8];
      const float t0 = st[2 * plane + r], t1 = st[2 * plane + r + 8];
      Frag<E> qa[T::kSteps][4], ga[T::kSteps][4];
      load_a16<E, HD>(qa, base + (long)q0 * ld, ld, g, c);
      load_a16<E, HD>(ga, gbase + (long)q0 * D, D, g, c);
      const float* brow0 = bias + ((long)h * N + r) * N;
      const float* brow1 = brow0 + 8L * N;
      float dq[T::kTiles][4];
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[d][i] = 0.f;
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
          s[nt][0] = __expf(s[nt][0] - m0) * il0 * (dp[nt][0] - t0);
          s[nt][1] = __expf(s[nt][1] - m0) * il0 * (dp[nt][1] - t0);
          s[nt][2] = __expf(s[nt][2] - m1) * il1 * (dp[nt][2] - t1);
          s[nt][3] = __expf(s[nt][3] - m1) * il1 * (dp[nt][3] - t1);
        }
        mma_16xhd_k64<HD>(dq, s, kt, g, c);
      }
      E* out0 = out + (long)r * ld + 2 * c;
      E* out1 = out0 + 8 * ld;
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d) {
        store2(out0 + d * 8, dq[d][0] * a.scale, dq[d][1] * a.scale);
        store2(out1 + d * 8, dq[d][2] * a.scale, dq[d][3] * a.scale);
      }
    }
  }
}

template <int HD, class E>
cudaError_t launch(const BwdArgs<E>& a, const float* bias, cudaStream_t s) {
  constexpr int smem = DkdvSmem<E, HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(bwd_qtiled_k1_kernel<E, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bwd_qtiled_k1_kernel<E, HD><<<dim3(a.H, a.W), 128, smem, s>>>(a, bias);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_dbias<HD>(a, bias, s);  // launch 2, attention_bwd.cuh
}

template <class E>
BwdArgs<E> args(const void* qkv, const void* g, void* dqkv, void* dbias, void* stats, int W, int N,
                int H, float scale) {
  return BwdArgs<E>{static_cast<const E*>(qkv), static_cast<const E*>(g),
                    static_cast<E*>(dqkv),        static_cast<float*>(dbias),
                    static_cast<float*>(stats),   W,
                    N,                            H,
                    scale};
}

int run_f32(const void* qkv, const void* bias, const void* g, void* dqkv, void* dbias, void* stats,
            int W, int N, int H, int hd, float scale, void* stream) {
  const BwdArgs<float> a = args<float>(qkv, g, dqkv, dbias, stats, W, N, H, scale);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GG_HEAD_DIM_SWITCH(hd, { return (int)launch<HD>(a, b, s); })
}

}  // namespace
}  // namespace gg

// Shapes validated by the Python wrapper (N a multiple of 64, head dim 16,
// 32 or 64, 1 <= W <= 65535, 1 <= G <= W).  stats is (3, W, H, N) f32
// scratch and partial (G, H, N, N) f32 scratch when the bf16 entry runs
// with G > 1; every element of dqkv and dbias is written.  qkv, g and dqkv
// bf16 (or f32 for the _f32 twin, which takes no groups); bias and dbias
// f32.
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

extern "C" int attention_bwd_qtiled_f32(const void* qkv, const void* bias, const void* g,
                                        void* dqkv, void* dbias, void* stats, void* partial, int W,
                                        int N, int H, int hd, int G, float scale, void* stream) {
  return gg::run_f32(qkv, bias, g, dqkv, dbias, stats, W, N, H, hd, scale, stream);
}
