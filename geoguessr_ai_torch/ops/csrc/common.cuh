// Device code shared by the port's kernels: the bf16 pack and split
// helpers of the f32 kinds, the loads and stores of two elements, and the
// head-dim dispatch every attention entry uses.  Each .cu file is compiled
// on its own into its own shared library.
//
// Layouts follow the JAX package (geoguessr_ai_tpu/ops/window_attention.py):
//   x    (W, N, C) window tokens, row-major
//   qkv  (W, N, 3D), TinyViT channel layout: head h owns channels
//        [h*3*hd, (h+1)*3*hd), with q|k|v slots of hd channels inside
//        (hd 16, 32 or 64)
//   bias (H, N, N) additive attention bias
//   out  (W, N, D), head h at channels [h*hd, (h+1)*hd)
// A register A operand of wgmma gives each warp 16 rows in the A layout of
// mma.sync.m16n8k16 (bf16), with g = lane / 4 and c = lane % 4:
//   a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 8+2c..), a3 = (g+8, 8+2c..)
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

// ---------------------------------------------------------------------------
// Element types.  Every Hopper core has a bf16 kind and an f32 kind, the
// latter for the f32 compute dtype (BackboneConfig dtype "float32"): each
// f32 operand value x is split into two bf16 values hi = bf16(x) and lo =
// bf16(x - hi), both rounded to nearest, and each product sums lo.hi +
// hi.lo + hi.hi in the f32 accumulator (three wgmma for one): about 16
// mantissa bits an operand, a relative error near 2^-17 a product against
// bf16's 2^-9, finer than TF32's 2^-11.  What the bf16 kinds round to bf16
// between steps (p before p.v, ds, LayerNorm's output, the qkv GEMM before
// its bias) stays f32 in the f32 kinds.
// ---------------------------------------------------------------------------

// One 32-bit fragment register in f32: the (hi, lo) pair of bf16 pairs of
// two floats.
template <class E>
struct Frag;
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

// The fragment register of two consecutive f32 elements at p, split.
__device__ __forceinline__ Frag<float> frag(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return split_pair(v.x, v.y);
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

// ---------------------------------------------------------------------------
// Head dims.  Every attention kernel is a template over the head dim HD, a
// multiple of the 16 that one bf16 wgmma k-step covers, and is
// instantiated for 16, 32 and 64 (TinyViT uses 32 at every stage, CLIP
// ViT-L/14 and ViT-B/32 use 64).  GG_HEAD_DIM_SWITCH picks the instance.
// ---------------------------------------------------------------------------

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

}  // namespace gg
