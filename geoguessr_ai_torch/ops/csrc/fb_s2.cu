// K2: the stage-2 "no-proj" fused block, LayerNorm -> qkv GEMM -> window
// attention, returning the pre-projection (W, N, D) output.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:1485 _fb_s2_pallas
// (kernel _fb_s2_kernel), stage 2 of TinyViT-21M-512 (N=1024, C=384,
// H=12, hd=32).
//
// What bounds it on the H100: the attention's 4*N*N*hd flops per
// (window, head), 103 GFLOP at 64 windows, against 0.23 GB of qkv, bias
// and output traffic; at hd=32 the N*N exponentials (MUFU, 16/clk/SM) cost
// about as much as the tensor-core work.  The design runs two kernels: the
// LayerNorm + GEMM kernel normalises each row tile in shared memory (the
// normalised x never reaches device memory) and writes qkv once; the
// attention kernel keeps scores and probabilities in registers.  The qkv
// tensor's round trip through device memory (W*N*3D*2 bytes each way) is
// the known gap against the TPU kernel, which kept qkv in VMEM.
#include "common.cuh"

extern "C" int fb_s2_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w_qkv_t, const void* b_qkv, const void* bias,
                          void* qkv_scratch, void* out, int W, int N, int C, int H,
                          float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * gg::kHd;
  cudaError_t e = gg::launch_ln_gemm<true, true>(
      static_cast<const gg::bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const gg::bf16*>(w_qkv_t),
      static_cast<const float*>(b_qkv), static_cast<gg::bf16*>(qkv_scratch), W * N, C, 3 * D,
      eps, s);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::launch_window_attention(
      static_cast<const gg::bf16*>(qkv_scratch), static_cast<const gg::bf16*>(bias),
      static_cast<gg::bf16*>(out), W, N, H, scale, s);
}
