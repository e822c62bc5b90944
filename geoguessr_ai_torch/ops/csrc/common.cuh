// Device code shared by the port's kernels: the bf16 pack and split
// helpers, mma.sync fragments, the head-dim dispatch every attention kernel
// uses, and the first design's window attention, which K3's f32 twin
// (attention_qkv.cu) still runs.  Each .cu file is compiled on its own into
// its own shared library, so the __global__ templates below are
// instantiated once per library.
//
// Layouts follow the JAX package (geoguessr_ai_tpu/ops/window_attention.py),
// in the element type E of the activations (bf16 or float, see "Element
// types" below):
//   x    (W, N, C) window tokens, row-major
//   qkv  (W, N, 3D), TinyViT channel layout: head h owns channels
//        [h*3*hd, (h+1)*3*hd), with q|k|v slots of hd channels inside
//        (hd 16, 32 or 64)
//   bias (H, N, N) additive attention bias
//   out  (W, N, D), head h at channels [h*hd, (h+1)*hd)
// The window attention uses the warp-level tensor-core instruction
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
// Element types.  Every kernel of the port that has an f32 twin is a
// template over the type E of its activations, weights and outputs: bf16
// (the default compute dtype) or float (BackboneConfig dtype "float32").
// Both keep mma.sync.m16n8k16 and its fragment layout.  In f32 each operand
// value x is split, as it is loaded into a fragment, into two bf16 values
// hi = bf16(x) and lo = bf16(x - hi), and each product sums
// hi.hi + hi.lo + lo.hi in the f32 accumulator (three MMAs for one): about
// 16 mantissa bits an operand, a relative error near 2^-17 a product
// against bf16's 2^-9, finer than TF32's 2^-11.  Tiles stay in shared
// memory in E (twice the bytes in f32), so the fragment addresses are the
// bf16 path's.  What the bf16 path rounds to bf16 between steps (p before
// p.v, ds, LayerNorm's output, the qkv GEMM before its bias) stays f32.
// ---------------------------------------------------------------------------

// One 32-bit fragment register of the bf16 path: one bf16 pair, or in f32
// the (hi, lo) pair of bf16 pairs of two floats.
template <class E>
struct Frag;
template <>
struct Frag<bf16> {
  uint32_t hi;
};
template <>
struct Frag<float> {
  uint32_t hi, lo;
};

__device__ __forceinline__ Frag<float> split_pair(float a, float b) {
  Frag<float> f;
  f.hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(f.hi);
  f.lo = pack_bf16(a - h.x, b - h.y);
  return f;
}

// The fragment register of two consecutive elements at p.
__device__ __forceinline__ Frag<bf16> frag(const bf16* p) { return {ld32(p)}; }
__device__ __forceinline__ Frag<float> frag(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return split_pair(v.x, v.y);
}

// The fragment register of two f32 values (an accumulator tile that feeds
// the next product): rounded to bf16, or split in f32.
template <class E>
__device__ __forceinline__ Frag<E> pack_frag(float a, float b);
template <>
__device__ __forceinline__ Frag<bf16> pack_frag<bf16>(float a, float b) {
  return {pack_bf16(a, b)};
}
template <>
__device__ __forceinline__ Frag<float> pack_frag<float>(float a, float b) {
  return split_pair(a, b);
}

__device__ __forceinline__ void mma(float c[4], const Frag<bf16> a[4], Frag<bf16> b0,
                                    Frag<bf16> b1) {
  const uint32_t aw[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  mma_bf16_16816(c, aw, b0.hi, b1.hi);
}
__device__ __forceinline__ void mma(float c[4], const Frag<float> a[4], Frag<float> b0,
                                    Frag<float> b1) {
  const uint32_t hi[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t lo[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  mma_bf16_16816(c, lo, b0.hi, b1.hi);
  mma_bf16_16816(c, hi, b0.lo, b1.lo);
  mma_bf16_16816(c, hi, b0.hi, b1.hi);
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// Two consecutive elements as floats, and stored from floats.
__device__ __forceinline__ float2 load2(const bf16* p) { return unpack_bf16(ld32(p)); }
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Eight consecutive elements, moved as 16-byte words (one in bf16, two in
// f32); p must be 16-byte aligned.
template <class E>
struct Vec8 {
  uint4 w[sizeof(E) / 2];
  __device__ __forceinline__ E& operator[](int j) { return reinterpret_cast<E*>(w)[j]; }
  __device__ __forceinline__ E operator[](int j) const {
    return reinterpret_cast<const E*>(w)[j];
  }
};
template <class E>
__device__ __forceinline__ Vec8<E> load8(const E* p) {
  Vec8<E> v;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(E) / 2); ++i) v.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return v;
}
template <class E>
__device__ __forceinline__ void store8(E* p, const Vec8<E>& v) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(E) / 2); ++i) reinterpret_cast<uint4*>(p)[i] = v.w[i];
}

// ---------------------------------------------------------------------------
// Where token n of window w lives: the row of the qkv tensor (row stride 3D)
// and of the output (row stride D).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Head dims.  Every attention kernel is a template over the head dim HD, a
// multiple of the 16 that one mma.sync.m16n8k16 k-step covers, and is
// instantiated for 16, 32 and 64 (TinyViT uses 32 at every stage, CLIP
// ViT-L/14 and ViT-B/32 use 64).  GG_HEAD_DIM_SWITCH picks the instance.
// ---------------------------------------------------------------------------

template <int HD>
struct HeadDim {
  static_assert(HD == 16 || HD == 32 || HD == 64, "head dims 16, 32, 64");
  static constexpr int kSteps = HD / 16;  // mma k-steps over the head dim
  static constexpr int kTiles = HD / 8;   // mma n-tiles of 8 dims
  static constexpr int kVecs = HD / 8;    // 16-byte vectors per head row
  static constexpr int kPad = HD + 8;     // row pitch (elements) of a (rows, HD) tile:
                                          // conflict-free fragment reads
};

// The body runs with HD a constant for hd in {16, 32, 64} and must return;
// another hd returns cudaErrorInvalidValue.
#define GG_HEAD_DIM_SWITCH(hd, ...)      \
  switch (hd) {                          \
    case 16: {                           \
      constexpr int HD = 16;             \
      __VA_ARGS__                        \
    }                                    \
    case 32: {                           \
      constexpr int HD = 32;             \
      __VA_ARGS__                        \
    }                                    \
    case 64: {                           \
      constexpr int HD = 64;             \
      __VA_ARGS__                        \
    }                                    \
    default:                             \
      return cudaErrorInvalidValue;      \
  }

// ---------------------------------------------------------------------------
// Window attention over the interleaved qkv tensor.
//
// One block of 4 warps per (q-tile of 64 rows, head, window); each warp owns
// 16 query rows; window w's token n is row w * N + n of qkv and out.  k and
// v stream through shared memory in tiles of 64 keys
// and the softmax is the online (running max / running sum) form, kept in
// f32.  In bf16, p is rounded to bf16 before the p.v product, as the Pallas
// kernels round it before their MXU dot; the row sum uses the unrounded p,
// as the Pallas kernels' f32 denominator does.  In f32 p is split, not
// rounded.
// ---------------------------------------------------------------------------

constexpr int kBq = 64;            // query rows per block
constexpr int kBk = 64;            // keys per tile
constexpr int kVPad = kBk + 8;     // V^T tile row pitch (elements)

template <class E, int HD>
__global__ void __launch_bounds__(128)
window_attention_kernel(const E* __restrict__ qkv, const E* __restrict__ bias,
                        E* __restrict__ out, int N, int H, float scale) {
  using T = HeadDim<HD>;
  constexpr int KP = T::kPad;
  __shared__ __align__(16) E ks[kBk * KP];
  __shared__ __align__(16) E vt[HD * kVPad];

  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int D = H * HD;
  const long row_stride = 3L * D;
  const E* base = qkv + (long)h * 3 * HD;
  const int q0 = blockIdx.x * kBq + warp * 16;
  const long qrow0 = (long)w * N + q0 + g, qrow1 = qrow0 + 8;

  // This warp's 16 query rows as A fragments, one per 16 dims.
  Frag<E> qa[T::kSteps][4];
#pragma unroll
  for (int s = 0; s < T::kSteps; ++s) {
    const E* r0 = base + qrow0 * row_stride + s * 16 + 2 * c;
    const E* r1 = base + qrow1 * row_stride + s * 16 + 2 * c;
    qa[s][0] = frag(r0);
    qa[s][1] = frag(r1);
    qa[s][2] = frag(r0 + 8);
    qa[s][3] = frag(r1 + 8);
  }

  float o[T::kTiles][4];
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain, rows g / g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  const E* brow0 = bias + ((long)h * N + q0 + g) * N;
  const E* brow1 = brow0 + 8L * N;
  const float sl2 = scale * kLog2e;

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBk * T::kVecs; i += 128) {
      const int key = i / T::kVecs, ch = i % T::kVecs;
      const E* src = base + ((long)w * N + k0 + key) * row_stride + ch * 8;
      store8(&ks[key * KP + ch * 8], load8(src + HD));
      const Vec8<E> vv = load8(src + 2 * HD);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(ch * 8 + j) * kVPad + key] = vv[j];
    }
    __syncthreads();

    // s = q k^T for 64 keys: 8 n-tiles of 8 keys.
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

    // scale + bias, into the log2 domain; running max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * c;
      const float2 b0 = load2(brow0 + col);
      const float2 b1 = load2(brow1 + col);
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

    // o += bf16(p) v (p split in f32): 4 k-steps of 16 keys; the s
    // accumulators of n-tiles 2kk and 2kk+1 are exactly the A fragment of
    // k-step kk.
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
  E* orow0 = out + qrow0 * D + h * HD + 2 * c;
  E* orow1 = out + qrow1 * D + h * HD + 2 * c;
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d) {
    store2(orow0 + d * 8, o[d][0] * inv0, o[d][1] * inv0);
    store2(orow1 + d * 8, o[d][2] * inv1, o[d][3] * inv1);
  }
}

template <class E>
inline cudaError_t launch_window_attention(const E* qkv, const E* bias, E* out, int W, int N,
                                           int H, int hd, float scale, cudaStream_t stream) {
  const dim3 grid(N / kBq, H, W);
  GG_HEAD_DIM_SWITCH(hd, {
    window_attention_kernel<E, HD><<<grid, 128, 0, stream>>>(qkv, bias, out, N, H, scale);
    return cudaGetLastError();
  })
}

}  // namespace gg
