// K12a and K12b: the experimental fused MBConv with plain biases,
//   1x1 expand (C -> E) + b1, tanh GELU, rounded to bf16
//   depthwise 3x3 ('same' zero padding of the EXPANDED tensor) in f32 over
//     the bf16 hidden with f32 taps, + b2, GELU, rounded
//   1x1 project (E -> C) + b3, the residual added in f32, GELU, rounded.
//
// Replaces geoguessr_ai_tpu/ops/experimental/fused_mbconv.py:68
// fused_mbconv (K12a, kernel body `kernel`, :23: a blocking halo DMA per
// grid cell) and :199 fused_mbconv_v2 (K12b, body `_kernel_v2`, :131: the
// next grid cell's halo DMA in flight while the current cell computes).
// Neither is wired into the JAX model; both run at stage 0's shapes, x
// (B, 128, 128, 96), E = 384.
//
// Layouts: x and out (B, H, W, C) bf16, C in {32, 64, 96}; w1t (E, C) bf16
// (w1 transposed); w2 (9, E) f32 taps in (dy, dx) order; w3t (C, E) bf16;
// sb1, sb2 (2, E) and sb3 (2, C) f32: a row of ones, then the bias.  Each
// contiguous with a 16-byte aligned base; E a multiple of 64, at most
// 2^31 - 1 16 x 16 tiles.
//
// Both run K10's Hopper kernel (mbconv_sm90.cuh) in its PLAIN kind: the
// numerics differ from K10 as the JAX kernel differs from _mbconv_xla
// (plain biases, f32 taps, GELU and the residual reading the f32 sums
// unrounded).  The Pallas kernels' TH = 16 full-width row strips and their
// C -> 128 and W + 2 -> 8 padding are Mosaic's tiling, not the function.
// The two entries differ only in the grid, which keeps the JAX v1 / v2
// contrast on one kernel:
//   K12a: one block for each 16 x 16 tile; it loads its halo by TMA, waits
//     and computes.
//   K12b: persistent blocks, one an SM, walk the tiles; the next tile's
//     halo loads by TMA under this tile's last depthwise.
// Every tile runs the same code in the same order, so K12b is bitwise K12a.
#include "mbconv_sm90.cuh"

namespace {

int run_k12(const void* x, const void* w1t, const void* sb1, const void* w2, const void* sb2,
            const void* w3t, const void* sb3, void* out, int B, int H, int W, int C, int E,
            bool one_tile_a_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 32:
      return (int)gg::mb90::run<32, true>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, false,
                                          s, one_tile_a_block);
    case 64:
      return (int)gg::mb90::run<64, true>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, false,
                                          s, one_tile_a_block);
    case 96:
      return (int)gg::mb90::run<96, true>(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, E, false,
                                          s, one_tile_a_block);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K12a: a block for each tile.
extern "C" int fused_mbconv_bf16(const void* x, const void* w1t, const void* sb1, const void* w2,
                                 const void* sb2, const void* w3t, const void* sb3, void* out,
                                 int B, int H, int W, int C, int E, void* stream) {
  return run_k12(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, C, E, true, stream);
}

// K12b: persistent blocks.  The same arguments as K12a.
extern "C" int fused_mbconv_v2_bf16(const void* x, const void* w1t, const void* sb1,
                                    const void* w2, const void* sb2, const void* w3t,
                                    const void* sb3, void* out, int B, int H, int W, int C, int E,
                                    void* stream) {
  return run_k12(x, w1t, sb1, w2, sb2, w3t, sb3, out, B, H, W, C, E, false, stream);
}
