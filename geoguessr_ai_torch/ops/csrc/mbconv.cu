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
// Both entries run the Hopper kernel of mbconv_sm90.cuh (TMA, wgmma,
// persistent warp-specialised blocks; its notes say what bounds each
// kind): the bf16 entry its bf16 kind over 16 x 16 tiles, as the
// experimental K12a / K12b do in its PLAIN kind; the f32 twin its f32 kind
// over 8 x 16 tiles.
//
// Layouts: x and out (B, H, W, C) bf16 (f32); w1t (E, C) bf16 (the 1x1
// expand conv's OI weight, the K-major B operand wgmma reads; in f32 the
// stacked (hi, lo) bf16 pair of the f32 weight, (2, E, C)); w2 (9, E) f32
// holding the depthwise taps (rounded to bf16 for the bf16 entry); w3t
// (C, E) bf16 (f32: (2, C, E) as w1t); sb1, sb2 (2, E) and sb3 (2, C) f32,
// scale row then bias row.
//
// What bounds it on the H100: 2.53e9 flops per image (two 1.21e9 GEMMs and
// 1.1e8 of depthwise MACs) against 6.3 MB of x in and out: 400 flops per
// byte, above the card's ~295 ridge, so the tensor cores bound it, and the
// 4x-expanded tensor (25 MB per image) must never reach device memory: the
// kernel walks E in chunks of 64 channels through the expand, the
// depthwise and the project, each chunk's expanded tile only in shared
// memory and registers.
//
// Rounding follows _mbconv_xla (the JAX CPU path, which the plain PyTorch
// version mirrors): each GEMM sums in f32, BN is applied in f32 and the
// result rounded to bf16, GELU is evaluated in f32 on that bf16 value and
// rounded to bf16; the depthwise MACs are f32 over bf16 taps, in the same
// (di, dj) order; the residual add rounds to bf16 before the last GELU.
// The Pallas kernel instead rounds each GEMM output to bf16 before applying
// BN in bf16.  The _f32 twin (BackboneConfig dtype "float32") rounds
// nothing: f32 x, taps, hidden chunk and output, its products on bf16
// (hi, lo) splits of every operand.
#include "mbconv_sm90.cuh"

// C in {32, 64, 96}, E a multiple of 64, 1 <= B <= 65535.
extern "C" int mbconv_bf16(const void* x, const void* w1t, const void* sb1, const void* w2,
                           const void* sb2, const void* w3t, const void* sb3, void* out, int B,
                           int H, int W, int C, int E, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 32:
      return (int)gg::mb90::run<32>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, exact, s);
    case 64:
      return (int)gg::mb90::run<64>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, exact, s);
    case 96:
      return (int)gg::mb90::run<96>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, exact, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same with x, w2 and out f32 and w1t, w3t the stacked (hi, lo) bf16
// pairs of the f32 weights.
extern "C" int mbconv_f32(const void* x, const void* w1t, const void* sb1, const void* w2,
                          const void* sb2, const void* w3t, const void* sb3, void* out, int B,
                          int H, int W, int C, int E, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 32:
      return (int)gg::mb90::run_f32<32>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, exact, s);
    case 64:
      return (int)gg::mb90::run_f32<64>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, exact, s);
    case 96:
      return (int)gg::mb90::run_f32<96>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, exact, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
