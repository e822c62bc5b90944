// K3: window attention read straight from the fused (W, N, 3D) qkv tensor.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:351
// _attention_qkv_fused_pallas (kernel _qkv_fused_kernel), the stage-3
// attention of TinyViT-21M-512 (N=256, H=18, hd=32).
//
// What bounds it on the H100: per (window, head) it reads N*3*hd qkv
// values and H*N*N bias values and does 4*N*N*hd flops.  At hd=32 that is
// 64 flops per bias byte, under the card's ~295 flops/byte ridge, so the
// bias read and the N*N exponentials weigh as much as the two products.
// The design keeps the N x N scores and probabilities in registers (never
// in device memory), streams k/v through shared memory per 64-key tile,
// and reads each bias element once per window; the bias (2.4 MB at stage
// 3) stays in the 50 MB L2 across windows.  See common.cuh for the tile
// math.
#include "common.cuh"

extern "C" int attention_qkv_bf16(const void* qkv, const void* bias, void* out, int W,
                                  int N, int H, float scale, void* stream) {
  return (int)gg::launch_window_attention(
      static_cast<const gg::bf16*>(qkv), static_cast<const gg::bf16*>(bias),
      static_cast<gg::bf16*>(out), W, N, H, scale, static_cast<cudaStream_t>(stream));
}
