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
// BN in bf16.  The _f32 twin (BackboneConfig dtype "float32") rounds
// nothing: f32 x, weights, taps, hidden chunk and output, its products on
// split operands (common.cuh "Element types"), in 190 KB of shared memory
// (one block an SM).
#include "mbconv.cuh"

namespace gg {
namespace mb {

template <class ET, int C, bool EXACT>
cudaError_t launch(const void* x, const void* w1t, const void* sb1, const void* w2,
                   const void* sb2, const void* w3t, const void* sb3, void* out, int B, int H,
                   int W, int E, cudaStream_t stream) {
  const int smem = (int)Smem<C, ET>::bytes;
  cudaError_t e = cudaFuncSetAttribute(mbconv_kernel<C, EXACT, false, ET>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + kTw - 1) / kTw, (H + kTh - 1) / kTh, B);
  mbconv_kernel<C, EXACT, false, ET><<<grid, kThreads, smem, stream>>>(
      static_cast<const ET*>(x), static_cast<const ET*>(w1t), static_cast<const float*>(sb1),
      static_cast<const float*>(w2), static_cast<const float*>(sb2),
      static_cast<const ET*>(w3t), static_cast<const float*>(sb3), static_cast<ET*>(out), H, W,
      E);
  return cudaGetLastError();
}

template <class ET, int C>
cudaError_t launch_c(bool exact, const void* x, const void* w1t, const void* sb1,
                     const void* w2, const void* sb2, const void* w3t, const void* sb3,
                     void* out, int B, int H, int W, int E, cudaStream_t stream) {
  return exact ? launch<ET, C, true>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, stream)
               : launch<ET, C, false>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, stream);
}

template <class ET>
int run(const void* x, const void* w1t, const void* sb1, const void* w2, const void* sb2,
        const void* w3t, const void* sb3, void* out, int B, int H, int W, int C, int E,
        int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E % kEc || B < 1 || B > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 32:
      return (int)launch_c<ET, 32>(exact, x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, s);
    case 64:
      return (int)launch_c<ET, 64>(exact, x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, s);
    case 96:
      return (int)launch_c<ET, 96>(exact, x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mb
}  // namespace gg

// C in {32, 64, 96}, E a multiple of 64, 1 <= B <= 65535.  x, w1t, w3t and
// out bf16 (or f32 for the _f32 twin, with the taps unrounded).
extern "C" int mbconv_bf16(const void* x, const void* w1t, const void* sb1, const void* w2,
                           const void* sb2, const void* w3t, const void* sb3, void* out, int B,
                           int H, int W, int C, int E, int exact, void* stream) {
  return gg::mb::run<gg::bf16>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, C, E, exact,
                               stream);
}

extern "C" int mbconv_f32(const void* x, const void* w1t, const void* sb1, const void* w2,
                          const void* sb2, const void* w3t, const void* sb3, void* out, int B,
                          int H, int W, int C, int E, int exact, void* stream) {
  return gg::mb::run<float>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, C, E, exact, stream);
}
