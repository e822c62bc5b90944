// Device code of the first design of the fused MBConv, which only K10's
// f32 twin (mbconv.cu, folded BatchNorm, TinyViT's stage 0) runs now: K10's
// bf16 entry and the experimental K12a / K12b run the Hopper kernel of
// mbconv_sm90.cuh.  The design is described in mbconv.cu: one (image, 8 x
// 16 output tile) at a time, its (10, 18, C) halo of x in shared memory, E
// walked in chunks of 64 channels through the expand GEMM, the depthwise
// MACs and the project GEMM, the 4x-expanded tensor never in device memory.
// The tile is a template over the element type ET of x, the 1x1 weights,
// the expanded chunk and out (common.cuh "Element types"); K10's twin
// instantiates it in f32, where round_e rounds nothing.
#pragma once

#include "common.cuh"

namespace gg {
namespace mb {

constexpr int kTh = 8;                  // output tile rows: one per warp
constexpr int kTw = 16;                 // output tile cols: one m16 row tile
constexpr int kHw = kTw + 2;            // halo cols
constexpr int kHalo = (kTh + 2) * kHw;  // 180 halo pixels
constexpr int kHaloRows = 192;          // 12 m-tiles of the expand GEMM
constexpr int kEc = 64;                 // expanded channels per chunk
constexpr int kHPitch = kEc + 8;        // pitch (elements) of the expanded chunk and w3 chunk
constexpr int kThreads = 256;

// Byte offsets into dynamic shared memory (190 KB at C = 96 in f32).  Row
// pitches of C + 8 and 72 elements make every fragment read and write below
// free of bank conflicts.
template <int C, class ET>
struct Smem {
  static constexpr int kXPitch = C + 8;
  static constexpr size_t kE = sizeof(ET);
  static constexpr size_t xs = 0;                                // ET [kHaloRows][kXPitch]
  static constexpr size_t w1s = xs + kHaloRows * kXPitch * kE;   // ET [kEc][kXPitch]
  static constexpr size_t hs = w1s + kEc * kXPitch * kE;         // ET [kHalo][kHPitch]
  static constexpr size_t w3s = hs + kHalo * kHPitch * kE;       // ET [C][kHPitch]
  static constexpr size_t w2s = w3s + C * kHPitch * kE;          // f32 [9][kEc]
  static constexpr size_t sb12 = w2s + 9 * kEc * 4;             // f32 [4][kEc]: s1 b1 s2 b2
  static constexpr size_t sb3 = sb12 + 4 * kEc * 4;             // f32 [2][C]
  static constexpr size_t bytes = sb3 + 2 * C * 4;
};

template <bool EXACT>
__device__ __forceinline__ float gelu(float x) {
  if (EXACT) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  // 0.5 x (1 + tanh(u)) = x * sigmoid(2u), u = sqrt(2/pi) (x + 0.044715 x^3)
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return x / (1.f + __expf(-2.f * u));
}

// Loads the (10, 18) halo of x around the output tile at (ty0, tx0) into
// xs, zero outside the image and in the 12 pad rows.
template <int C, class ET>
__device__ __forceinline__ void load_halo(ET* xs, const ET* __restrict__ ximg, int ty0, int tx0,
                                          int H, int W) {
  constexpr int XP = Smem<C, ET>::kXPitch;
  constexpr int kVec = C / 8;  // vectors of 8 channels per pixel of x
  for (int i = threadIdx.x; i < kHaloRows * kVec; i += kThreads) {
    const int row = i / kVec, v = i - row * kVec;
    Vec8<ET> val{};
    if (row < kHalo) {
      const int hy = row / kHw, hx = row - hy * kHw;
      const int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        val = load8(ximg + ((long)iy * W + ix) * C + v * 8);
    }
    store8(xs + row * XP + v * 8, val);
  }
}

// One (8 x 16) output tile from the halo in xs: the chunk loop over E and
// the epilogue.  Every thread of the block calls it; it synchronises the
// block before its first shared-memory write, so xs must be complete and
// visible when it is called.  The (s, b) pairs are folded BatchNorms; each
// is applied in f32 and rounded to ET before its GELU, and the residual add
// rounds to ET before the last GELU.  In f32 (ET = float) nothing is
// rounded, and the expanded chunk and the project GEMM's A fragments are
// split (common.cuh "Element types").
template <int C, bool EXACT, class ET>
__device__ __forceinline__ void mbconv_tile(unsigned char* smem, const ET* xs,
                                            const ET* __restrict__ w1t,
                                            const float* __restrict__ sb1,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ sb2,
                                            const ET* __restrict__ w3t,
                                            const float* __restrict__ sb3,
                                            ET* __restrict__ out_img, int ty0, int tx0, int H,
                                            int W, int E) {
  using S = Smem<C, ET>;
  constexpr int XP = S::kXPitch;
  constexpr int kVec = C / 8;
  ET* w1s = reinterpret_cast<ET*>(smem + S::w1s);
  ET* hs = reinterpret_cast<ET*>(smem + S::hs);
  ET* w3s = reinterpret_cast<ET*>(smem + S::w3s);
  float* w2s = reinterpret_cast<float*>(smem + S::w2s);
  float* sb12s = reinterpret_cast<float*>(smem + S::sb12);
  float* sb3s = reinterpret_cast<float*>(smem + S::sb3);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;

  float acc3[C / 8][4];
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc3[nt][t] = 0.f;

  // Expand roles: warp pairs split the chunk's 64 channels in halves of 32,
  // and the 12 m-tiles of halo pixels 3 to a pair.
  const int nh = warp & 1;
  const int m_first = warp >> 1;

  for (int e0 = 0; e0 < E; e0 += kEc) {
    __syncthreads();  // the previous chunk (or tile) is consumed
    if (e0 == 0)
      for (int i = tid; i < 2 * C; i += kThreads) sb3s[i] = sb3[i];
    for (int i = tid; i < kEc * kVec; i += kThreads) {
      const int n = i / kVec, v = i - n * kVec;
      store8(w1s + n * XP + v * 8, load8(w1t + (long)(e0 + n) * C + v * 8));
    }
    for (int i = tid; i < C * (kEc / 8); i += kThreads) {
      const int n = i / (kEc / 8), v = i - n * (kEc / 8);
      store8(w3s + n * kHPitch + v * 8, load8(w3t + (long)n * E + e0 + v * 8));
    }
    for (int i = tid; i < 9 * kEc; i += kThreads) {
      const int t = i / kEc, e = i - t * kEc;
      w2s[i] = w2[(long)t * E + e0 + e];
    }
    if (tid < kEc) {
      sb12s[tid] = sb1[e0 + tid];
      sb12s[kEc + tid] = sb1[E + e0 + tid];
      sb12s[2 * kEc + tid] = sb2[e0 + tid];
      sb12s[3 * kEc + tid] = sb2[E + e0 + tid];
    }
    __syncthreads();

    // 1. Expand the halo, (192 x C) . (C x 64), then (s1, b1), GELU and the
    //    image-padding mask, into hs.
#pragma unroll 1
    for (int mi = 0; mi < 3; ++mi) {
      const int mt = m_first + 4 * mi;
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[nt][t] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        Frag<ET> a[4];
        const ET* ar = xs + (mt * 16 + g) * XP + ks * 16 + 2 * c;
        a[0] = frag(ar);
        a[1] = frag(ar + 8 * XP);
        a[2] = frag(ar + 8);
        a[3] = frag(ar + 8 * XP + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const ET* br = w1s + (nh * 32 + nt * 8 + g) * XP + ks * 16 + 2 * c;
          mma(acc[nt], a, frag(br), frag(br + 8));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + 8 * half;
        if (row >= kHalo) continue;
        const int hy = row / kHw, hx = row - hy * kHw;
        const int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int ch = nh * 32 + nt * 8 + 2 * c;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = gelu<EXACT>(round_e<ET>(acc[nt][2 * half] * sb12s[ch] + sb12s[kEc + ch]));
            v1 = gelu<EXACT>(
                round_e<ET>(acc[nt][2 * half + 1] * sb12s[ch + 1] + sb12s[kEc + ch + 1]));
          }
          store2(hs + row * kHPitch + ch, v0, v1);
        }
      }
    }
    __syncthreads();

    // 2. Depthwise 3x3, (s2, b2) and GELU for this warp's 16 pixels, built
    //    as the A fragments of
    // 3. the project GEMM, (16 x 64) . (64 x C), summed into acc3.
#pragma unroll
    for (int ks = 0; ks < kEc / 16; ++ks) {
      Frag<ET> a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int px = g + 8 * (q & 1);
        const int ch = ks * 16 + 8 * (q >> 1) + 2 * c;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float2 hv = load2(hs + ((warp + di) * kHw + px + dj) * kHPitch + ch);
            const float2 wv = *reinterpret_cast<const float2*>(w2s + (di * 3 + dj) * kEc + ch);
            s0 += hv.x * wv.x;
            s1 += hv.y * wv.y;
          }
        const float y0 =
            gelu<EXACT>(round_e<ET>(s0 * sb12s[2 * kEc + ch] + sb12s[3 * kEc + ch]));
        const float y1 = gelu<EXACT>(
            round_e<ET>(s1 * sb12s[2 * kEc + ch + 1] + sb12s[3 * kEc + ch + 1]));
        a[q] = pack_frag<ET>(y0, y1);
      }
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt) {
        const ET* br = w3s + (nt * 8 + g) * kHPitch + ks * 16 + 2 * c;
        mma(acc3[nt], a, frag(br), frag(br + 8));
      }
    }
  }

  // 4. (s3, b3), the residual from the halo centre, GELU.
  const int oy = ty0 + warp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int px = g + 8 * half;
    const int ox = tx0 + px;
    if (oy >= H || ox >= W) continue;
    const ET* xc = xs + ((warp + 1) * kHw + px + 1) * XP;
    ET* orow = out_img + ((long)oy * W + ox) * C;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int ch = nt * 8 + 2 * c;
      const float p0 = round_e<ET>(acc3[nt][2 * half] * sb3s[ch] + sb3s[C + ch]);
      const float p1 = round_e<ET>(acc3[nt][2 * half + 1] * sb3s[ch + 1] + sb3s[C + ch + 1]);
      const float2 xv = load2(xc + ch);
      store2(orow + ch, gelu<EXACT>(round_e<ET>(xv.x + p0)),
             gelu<EXACT>(round_e<ET>(xv.y + p1)));
    }
  }
}

// One block of 8 warps per (image, 8 x 16 output tile): the halo, then the
// tile, one block an SM (190 KB of shared memory at C = 96 in f32).
template <int C, bool EXACT, class ET>
__global__ void __launch_bounds__(kThreads, 1)
mbconv_kernel(const ET* __restrict__ x, const ET* __restrict__ w1t,
              const float* __restrict__ sb1, const float* __restrict__ w2,
              const float* __restrict__ sb2, const ET* __restrict__ w3t,
              const float* __restrict__ sb3, ET* __restrict__ out, int H, int W, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  ET* xs = reinterpret_cast<ET*>(smem + Smem<C, ET>::xs);
  const int ty0 = blockIdx.y * kTh, tx0 = blockIdx.x * kTw;
  const long img = (long)blockIdx.z * H * W * C;
  load_halo<C>(xs, x + img, ty0, tx0, H, W);
  mbconv_tile<C, EXACT>(smem, xs, w1t, sb1, w2, sb2, w3t, sb3, out + img, ty0, tx0, H, W, E);
}
}  // namespace mb
}  // namespace gg
