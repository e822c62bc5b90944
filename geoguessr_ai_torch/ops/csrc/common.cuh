// Device code shared by the window-attention kernels of the port (K1
// fused_block.cu, K2 fb_s2.cu, K3 attention_qkv.cu, K9 fb4d.cu).  Each .cu file is
// compiled on its own into its own shared library, so the __global__
// templates below are instantiated once per library.
//
// Layouts follow the JAX package (geoguessr_ai_tpu/ops/window_attention.py):
//   x    (W, N, C) bf16 window tokens, row-major
//   qkv  (W, N, 3D) bf16, TinyViT channel layout: head h owns channels
//        [h*3*hd, (h+1)*3*hd), with q|k|v slots of hd channels inside
//   bias (H, N, N) bf16 additive attention bias
//   out  (W, N, D) bf16, head h at channels [h*hd, (h+1)*hd)
// Weights arrive in PyTorch's (out, in) layout, which is the column-major
// B operand that mma.sync wants: two consecutive k of one output column are
// one 32-bit word.
//
// Both kernels use the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Fragment layout, with
// g = lane / 4 and c = lane % 4:
//   A (16x16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 8+2c..),
//                         a3 = (g+8, 8+2c..)
//   B (16x8, k-major):    b0 = (k 2c..2c+1, n g), b1 = (k 8+2c.., n g)
//   C (16x8, f32):        c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gg {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Packs two floats into one bf16x2 word, lo in the low half (round to
// nearest even, as XLA's convert does).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Where token n of window w lives: the row of the qkv tensor (row stride 3D)
// and of the output (row stride D).
// ---------------------------------------------------------------------------

// Windows stored one after another, (W, N, .): row w * N + n.
struct WindowRows {
  __device__ __forceinline__ long operator()(int w, int n, int N) const {
    return (long)w * N + n;
  }
};

// Windows of side ws cut from a (B, nwh * ws, nww * ws, .) map in raster
// order (the order window_partition gives them): window w = (b, i, j),
// token n = (r, c) lives at map row (b, i * ws + r, j * ws + c).  This is
// the whole of the window partition on the card: no copy is made.
struct MapRows {
  int ws, nwh, nww;
  __device__ __forceinline__ long operator()(int w, int n, int /*N*/) const {
    const int per_image = nwh * nww;
    const int b = w / per_image, rem = w - b * per_image;
    const int i = rem / nww, j = rem - i * nww;
    const int r = n / ws, c = n - r * ws;
    const long map_w = (long)nww * ws;
    return ((long)b * nwh * ws + (long)i * ws + r) * map_w + (long)j * ws + c;
  }
};

// ---------------------------------------------------------------------------
// Window attention over the interleaved qkv tensor.
//
// One block of 4 warps per (q-tile of 64 rows, head, window); each warp owns
// 16 query rows.  ROWS maps (window, token) to the row of qkv and out.  k and v stream through shared memory in tiles of 64 keys
// and the softmax is the online (running max / running sum) form, kept in
// f32.  p is rounded to bf16 before the p.v product, as the Pallas kernels
// round it before their MXU dot; the row sum uses the unrounded p, as the
// Pallas kernels' f32 denominator does.
// ---------------------------------------------------------------------------

constexpr int kHd = 32;            // head dim; TinyViT uses 32 at every stage
constexpr int kBq = 64;            // query rows per block
constexpr int kBk = 64;            // keys per tile
constexpr int kKPad = kHd + 8;     // K tile row pitch (bf16): conflict-free b-fragment reads
constexpr int kVPad = kBk + 8;     // V^T tile row pitch (bf16)

template <class ROWS>
__global__ void __launch_bounds__(128)
window_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                        bf16* __restrict__ out, int N, int H, float scale, ROWS rows) {
  __shared__ __align__(16) bf16 ks[kBk * kKPad];
  __shared__ __align__(16) bf16 vt[kHd * kVPad];

  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int D = H * kHd;
  const long row_stride = 3L * D;
  const bf16* base = qkv + (long)h * 3 * kHd;
  const int q0 = blockIdx.x * kBq + warp * 16;
  const long qrow0 = rows(w, q0 + g, N), qrow1 = rows(w, q0 + g + 8, N);

  // This warp's 16 query rows as two A fragments (dims 0-15, 16-31).
  uint32_t qa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const bf16* r0 = base + qrow0 * row_stride + s * 16 + 2 * c;
    const bf16* r1 = base + qrow1 * row_stride + s * 16 + 2 * c;
    qa[s][0] = ld32(r0);
    qa[s][1] = ld32(r1);
    qa[s][2] = ld32(r0 + 8);
    qa[s][3] = ld32(r1 + 8);
  }

  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain, rows g / g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  const bf16* brow0 = bias + ((long)h * N + q0 + g) * N;
  const bf16* brow1 = brow0 + 8L * N;
  const float sl2 = scale * kLog2e;

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBk * 4; i += 128) {
      const int key = i >> 2, ch = i & 3;
      const bf16* src = base + rows(w, k0 + key, N) * row_stride + ch * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(src + kHd);
      *reinterpret_cast<uint4*>(&ks[key * kKPad + ch * 8]) = kv;
      uint4 vv = *reinterpret_cast<const uint4*>(src + 2 * kHd);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(ch * 8 + j) * kVPad + key] = ve[j];
    }
    __syncthreads();

    // s = q k^T for 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const bf16* kr = &ks[(nt * 8 + g) * kKPad + 2 * c];
#pragma unroll
      for (int st = 0; st < 2; ++st)
        mma_bf16_16816(s[nt], qa[st], ld32(kr + st * 16), ld32(kr + st * 16 + 8));
    }

    // scale + bias, into the log2 domain; running max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * c;
      const float2 b0 = unpack_bf16(ld32(brow0 + col));
      const float2 b1 = unpack_bf16(ld32(brow1 + col));
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
    for (int d = 0; d < 4; ++d) {
      o[d][0] *= alpha0;
      o[d][1] *= alpha0;
      o[d][2] *= alpha1;
      o[d][3] *= alpha1;
    }

    // o += bf16(p) v: 4 k-steps of 16 keys; the s accumulators of n-tiles
    // 2kk and 2kk+1 are exactly the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const bf16* vr = &vt[(d * 8 + g) * kVPad + kk * 16 + 2 * c];
        mma_bf16_16816(o[d], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* orow0 = out + qrow0 * D + h * kHd + 2 * c;
  bf16* orow1 = out + qrow1 * D + h * kHd + 2 * c;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    *reinterpret_cast<uint32_t*>(orow0 + d * 8) = pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(orow1 + d * 8) = pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
}

template <class ROWS = WindowRows>
inline cudaError_t launch_window_attention(const bf16* qkv, const bf16* bias, bf16* out,
                                           int W, int N, int H, float scale,
                                           cudaStream_t stream, ROWS rows = ROWS()) {
  dim3 grid(N / kBq, H, W);
  window_attention_kernel<ROWS><<<grid, 128, 0, stream>>>(qkv, bias, out, N, H, scale, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// y[M, Nout] = epilogue(a[M, K] @ wt[Nout, K]^T + b), a = LN(x) when LN.
//
// Block tile 64x64, 4 warps in 2x2, each warp 32x32; k steps of 32 through
// shared memory.  With LN the block first computes its 64 rows' mean and
// rstd in f32 (two passes: mean, then mean of squared deviations, as the
// JAX kernels do), then normalises each A tile on its way into shared
// memory and rounds it to bf16 there: the normalised rows never touch
// device memory.
//   ROUND_FIRST: y = bf16(bf16(acc) + b)  (the qkv GEMM: dot -> bf16, + bf16 bias)
//   otherwise:   y = bf16(acc + b)        (the out-proj: f32 bias on the f32 sum)
// ---------------------------------------------------------------------------

constexpr int kGemmTile = 64;
constexpr int kGemmK = 32;
constexpr int kGemmPad = kGemmK + 8;

template <bool LN, bool ROUND_FIRST>
__global__ void __launch_bounds__(128)
ln_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ wt,
               const float* __restrict__ bvec, bf16* __restrict__ y, int M, int K,
               int Nout, float eps) {
  __shared__ __align__(16) bf16 as[kGemmTile * kGemmPad];
  __shared__ __align__(16) bf16 bs[kGemmTile * kGemmPad];
  __shared__ float mean_s[kGemmTile], rstd_s[kGemmTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const long m0 = (long)blockIdx.x * kGemmTile;
  const long n0 = (long)blockIdx.y * kGemmTile;

  if (LN) {
    for (int r = warp; r < kGemmTile; r += 4) {
      const bf16* xr = x + (m0 + r) * K;
      float sum = 0.f;
      for (int k = lane; k < K; k += 32) sum += __bfloat162float(xr[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float mu = sum / K;
      float sq = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = __bfloat162float(xr[k]) - mu;
        sq += d * d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) {
        mean_s[r] = mu;
        rstd_s[r] = rsqrtf(sq / K + eps);
      }
    }
    __syncthreads();
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmK) {
    for (int i = tid; i < kGemmTile * 4; i += 128) {
      const int r = i >> 2, ch = i & 3;
      uint4 av = *reinterpret_cast<const uint4*>(x + (m0 + r) * K + k0 + ch * 8);
      if (LN) {
        bf16* e = reinterpret_cast<bf16*>(&av);
        const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + ch * 8 + j;
          e[j] = __float2bfloat16_rn((__bfloat162float(e[j]) - mu) * rs * gamma[k] + beta[k]);
        }
      }
      *reinterpret_cast<uint4*>(&as[r * kGemmPad + ch * 8]) = av;
      *reinterpret_cast<uint4*>(&bs[r * kGemmPad + ch * 8]) =
          *reinterpret_cast<const uint4*>(wt + (n0 + r) * K + k0 + ch * 8);
    }
    __syncthreads();
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ar = &as[(wm * 32 + mt * 16 + g) * kGemmPad + st * 16 + 2 * c];
        a[mt][0] = ld32(ar);
        a[mt][1] = ld32(ar + 8 * kGemmPad);
        a[mt][2] = ld32(ar + 8);
        a[mt][3] = ld32(ar + 8 * kGemmPad + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* br = &bs[(wn * 32 + nt * 8 + g) * kGemmPad + st * 16 + 2 * c];
        const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const long r0 = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long col = n0 + wn * 32 + nt * 8 + 2 * c;
      const float b0 = bvec[col], b1 = bvec[col + 1];
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = ROUND_FIRST ? round_bf16(acc[mt][nt][t]) : acc[mt][nt][t];
      *reinterpret_cast<uint32_t*>(y + r0 * Nout + col) = pack_bf16(v[0] + b0, v[1] + b1);
      *reinterpret_cast<uint32_t*>(y + (r0 + 8) * Nout + col) = pack_bf16(v[2] + b0, v[3] + b1);
    }
  }
}

template <bool LN, bool ROUND_FIRST>
inline cudaError_t launch_ln_gemm(const bf16* x, const float* gamma, const float* beta,
                                  const bf16* wt, const float* b, bf16* y, int M, int K,
                                  int Nout, float eps, cudaStream_t stream) {
  dim3 grid(M / kGemmTile, Nout / kGemmTile);
  ln_gemm_kernel<LN, ROUND_FIRST><<<grid, 128, 0, stream>>>(x, gamma, beta, wt, b, y, M, K,
                                                            Nout, eps);
  return cudaGetLastError();
}

}  // namespace gg
