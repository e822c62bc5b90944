// K10: TinyViT's stage-0 MBConv with folded BatchNorm, in one kernel:
//   1x1 expand (C -> E) + BN1 + GELU
//   depthwise 3x3 ('same' zero padding of the EXPANDED tensor) + BN2 + GELU
//   1x1 project (E -> C) + BN3
//   residual add + GELU
//
// Replaces geoguessr_ai_tpu/ops/mbconv.py:164 _mbconv_pallas (kernel
// _mbconv_kernel): stage 0 of TinyViT-21M-512 with fused_mbconv, x
// (B, 128, 128, 96), E = 384.  Inference only: each BN arrives folded into a
// per-channel f32 (scale, bias) pair from the running statistics.
//
// Layouts: x and out (B, H, W, C) bf16; w1t (E, C) bf16 (the 1x1 expand
// conv's OI weight, the column-major B operand mma.sync wants); w2 (9, E) f32
// holding the depthwise taps already rounded to bf16; w3t (C, E) bf16; sb1,
// sb2 (2, E) and sb3 (2, C) f32, scale row then bias row.
//
// What bounds it on the H100: 2.53e9 flops per image (two 1.21e9 GEMMs and
// 1.1e8 of depthwise MACs) against 6.3 MB of x in and out: 400 flops per
// byte, above the card's ~295 ridge, so the tensor cores bound it, and the
// 4x-expanded tensor (25 MB per image) must never reach device memory.  The
// design: one block of 8 warps per (image, 8 x 16 output tile).  The block
// holds the (10, 18, C) halo of x in shared memory and walks E in chunks of
// 64 channels.  For each chunk it
//   1. expands the 180 halo pixels with mma.sync (f32 accumulate), applies
//      BN1 and GELU, and ZEROES the halo pixels that are image padding (the
//      depthwise conv pads the expanded tensor with zeros, and
//      gelu(bn1(0)) != 0), keeping the chunk in shared memory (23 KB);
//   2. runs the 3x3 depthwise MACs in f32 straight into the A fragments of
//      the project GEMM: warp w owns output row w of the tile, 16 pixels,
//      which is one m16 tile, so the depthwise output never touches shared
//      memory either;
//   3. adds the chunk's (16 x 64) . (64 x C) slice of the project GEMM into
//      f32 registers that live across chunks.
// It ends with BN3, the residual from the halo centre and GELU.  Device
// memory sees x once (plus the 1.4x halo re-read, mostly from L2), the
// weights from L2, and the output once.  The Pallas kernel's full-width row
// strips and its W+2 -> 8 and C -> 128 padding are Mosaic's alignment rules
// and are not carried over; the halo here is masked, never padded in memory.
//
// Rounding follows _mbconv_xla (the JAX CPU path, which the plain PyTorch
// version mirrors): each GEMM sums in f32, BN is applied in f32 and the
// result rounded to bf16, GELU is evaluated in f32 on that bf16 value and
// rounded to bf16; the depthwise MACs are f32 over bf16 taps, in the same
// (di, dj) order; the residual add rounds to bf16 before the last GELU.
// The Pallas kernel instead rounds each GEMM output to bf16 before applying
// BN in bf16.
#include "common.cuh"

namespace gg {
namespace mb {

constexpr int kTh = 8;                  // output tile rows: one per warp
constexpr int kTw = 16;                 // output tile cols: one m16 row tile
constexpr int kHw = kTw + 2;            // halo cols
constexpr int kHalo = (kTh + 2) * kHw;  // 180 halo pixels
constexpr int kHaloRows = 192;          // 12 m-tiles of the expand GEMM
constexpr int kEc = 64;                 // expanded channels per chunk
constexpr int kHPitch = kEc + 8;        // bf16 pitch of the expanded chunk and w3 chunk
constexpr int kThreads = 256;

// Byte offsets into dynamic shared memory.  Row pitches of C + 8 and 72
// bf16 make every fragment read and write below free of bank conflicts.
template <int C>
struct Smem {
  static constexpr int kXPitch = C + 8;
  static constexpr size_t xs = 0;                               // bf16 [kHaloRows][kXPitch]
  static constexpr size_t w1s = xs + kHaloRows * kXPitch * 2;   // bf16 [kEc][kXPitch]
  static constexpr size_t hs = w1s + kEc * kXPitch * 2;         // bf16 [kHalo][kHPitch]
  static constexpr size_t w3s = hs + kHalo * kHPitch * 2;       // bf16 [C][kHPitch]
  static constexpr size_t w2s = w3s + C * kHPitch * 2;          // f32 [9][kEc]
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

template <int C, bool EXACT>
__global__ void __launch_bounds__(kThreads, 2)
mbconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
              const float* __restrict__ sb1, const float* __restrict__ w2,
              const float* __restrict__ sb2, const bf16* __restrict__ w3t,
              const float* __restrict__ sb3, bf16* __restrict__ out, int H, int W, int E) {
  using S = Smem<C>;
  constexpr int XP = S::kXPitch;
  constexpr int kVec = C / 8;  // 16-byte vectors per pixel of x
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + S::w1s);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::hs);
  bf16* w3s = reinterpret_cast<bf16*>(smem + S::w3s);
  float* w2s = reinterpret_cast<float*>(smem + S::w2s);
  float* sb12s = reinterpret_cast<float*>(smem + S::sb12);
  float* sb3s = reinterpret_cast<float*>(smem + S::sb3);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int ty0 = blockIdx.y * kTh, tx0 = blockIdx.x * kTw;
  const bf16* ximg = x + (long)blockIdx.z * H * W * C;

  // The halo of x; zero outside the image and in the 12 pad rows.
  for (int i = tid; i < kHaloRows * kVec; i += kThreads) {
    const int row = i / kVec, v = i - row * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < kHalo) {
      const int hy = row / kHw, hx = row - hy * kHw;
      const int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        val = *reinterpret_cast<const uint4*>(ximg + ((long)iy * W + ix) * C + v * 8);
    }
    *reinterpret_cast<uint4*>(xs + row * XP + v * 8) = val;
  }
  for (int i = tid; i < 2 * C; i += kThreads) sb3s[i] = sb3[i];

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
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kEc * kVec; i += kThreads) {
      const int n = i / kVec, v = i - n * kVec;
      *reinterpret_cast<uint4*>(w1s + n * XP + v * 8) =
          *reinterpret_cast<const uint4*>(w1t + (long)(e0 + n) * C + v * 8);
    }
    for (int i = tid; i < C * (kEc / 8); i += kThreads) {
      const int n = i / (kEc / 8), v = i - n * (kEc / 8);
      *reinterpret_cast<uint4*>(w3s + n * kHPitch + v * 8) =
          *reinterpret_cast<const uint4*>(w3t + (long)n * E + e0 + v * 8);
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

    // 1. Expand the halo, (192 x C) . (C x 64), then BN1, GELU and the
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
        uint32_t a[4];
        const bf16* ar = xs + (mt * 16 + g) * XP + ks * 16 + 2 * c;
        a[0] = ld32(ar);
        a[1] = ld32(ar + 8 * XP);
        a[2] = ld32(ar + 8);
        a[3] = ld32(ar + 8 * XP + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* br = w1s + (nh * 32 + nt * 8 + g) * XP + ks * 16 + 2 * c;
          mma_bf16_16816(acc[nt], a, ld32(br), ld32(br + 8));
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
            v0 = gelu<EXACT>(round_bf16(acc[nt][2 * half] * sb12s[ch] + sb12s[kEc + ch]));
            v1 = gelu<EXACT>(
                round_bf16(acc[nt][2 * half + 1] * sb12s[ch + 1] + sb12s[kEc + ch + 1]));
          }
          *reinterpret_cast<uint32_t*>(hs + row * kHPitch + ch) = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // 2. Depthwise 3x3, BN2 and GELU for this warp's 16 pixels, built as
    //    the A fragments of
    // 3. the project GEMM, (16 x 64) . (64 x C), summed into acc3.
#pragma unroll
    for (int ks = 0; ks < kEc / 16; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int px = g + 8 * (q & 1);
        const int ch = ks * 16 + 8 * (q >> 1) + 2 * c;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float2 hv =
                unpack_bf16(ld32(hs + ((warp + di) * kHw + px + dj) * kHPitch + ch));
            const float2 wv = *reinterpret_cast<const float2*>(w2s + (di * 3 + dj) * kEc + ch);
            s0 += hv.x * wv.x;
            s1 += hv.y * wv.y;
          }
        const float y0 =
            gelu<EXACT>(round_bf16(s0 * sb12s[2 * kEc + ch] + sb12s[3 * kEc + ch]));
        const float y1 =
            gelu<EXACT>(round_bf16(s1 * sb12s[2 * kEc + ch + 1] + sb12s[3 * kEc + ch + 1]));
        a[q] = pack_bf16(y0, y1);
      }
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt) {
        const bf16* br = w3s + (nt * 8 + g) * kHPitch + ks * 16 + 2 * c;
        mma_bf16_16816(acc3[nt], a, ld32(br), ld32(br + 8));
      }
    }
  }

  // 4. BN3, the residual from the halo centre, GELU.
  const int oy = ty0 + warp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int px = g + 8 * half;
    const int ox = tx0 + px;
    if (oy >= H || ox >= W) continue;
    const bf16* xc = xs + ((warp + 1) * kHw + px + 1) * XP;
    bf16* orow = out + (((long)blockIdx.z * H + oy) * W + ox) * C;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int ch = nt * 8 + 2 * c;
      const float p0 = round_bf16(acc3[nt][2 * half] * sb3s[ch] + sb3s[C + ch]);
      const float p1 = round_bf16(acc3[nt][2 * half + 1] * sb3s[ch + 1] + sb3s[C + ch + 1]);
      const float2 xv = unpack_bf16(ld32(xc + ch));
      *reinterpret_cast<uint32_t*>(orow + ch) =
          pack_bf16(gelu<EXACT>(round_bf16(xv.x + p0)), gelu<EXACT>(round_bf16(xv.y + p1)));
    }
  }
}

template <int C, bool EXACT>
cudaError_t launch(const void* x, const void* w1t, const void* sb1, const void* w2,
                   const void* sb2, const void* w3t, const void* sb3, void* out, int B, int H,
                   int W, int E, cudaStream_t stream) {
  const int smem = (int)Smem<C>::bytes;
  cudaError_t e = cudaFuncSetAttribute(mbconv_kernel<C, EXACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + kTw - 1) / kTw, (H + kTh - 1) / kTh, B);
  mbconv_kernel<C, EXACT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1t),
      static_cast<const float*>(sb1), static_cast<const float*>(w2),
      static_cast<const float*>(sb2), static_cast<const bf16*>(w3t),
      static_cast<const float*>(sb3), static_cast<bf16*>(out), H, W, E);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(bool exact, const void* x, const void* w1t, const void* sb1,
                     const void* w2, const void* sb2, const void* w3t, const void* sb3,
                     void* out, int B, int H, int W, int E, cudaStream_t stream) {
  return exact ? launch<C, true>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, stream)
               : launch<C, false>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, stream);
}

}  // namespace mb
}  // namespace gg

// C in {32, 64, 96}, E a multiple of 64, 1 <= B <= 65535.
extern "C" int mbconv_bf16(const void* x, const void* w1t, const void* sb1, const void* w2,
                           const void* sb2, const void* w3t, const void* sb3, void* out, int B,
                           int H, int W, int C, int E, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E % gg::mb::kEc || B < 1 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 32:
      return (int)gg::mb::launch_c<32>(exact, x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, s);
    case 64:
      return (int)gg::mb::launch_c<64>(exact, x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, s);
    case 96:
      return (int)gg::mb::launch_c<96>(exact, x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
