// K6: CLIP self-attention softmax(q k^T * scale) v read straight from the
// fused token-major (B, N, 3D) qkv tensor, no bias or mask, hd = 64 (and
// 16 or 32).
//
// Replaces geoguessr_ai_tpu/ops/clip_attention.py:134 _flash_pallas
// (kernel _flash_kernel), which every encoder layer of CLIP ViT-L/14-336
// launches (B images, N = 577, H = 16; 24 launches per forward).
//
// What bounds it on the H100: per (image, head) it reads 3*N*hd qkv
// values and writes N*hd, and does 4*N*N*hd flops: N/2 ~ 288 flops per byte
// at N = 577, just under the card's ~295 flops per byte ridge, so the ideal
// kernel is bound about equally by bytes and by the tensor cores (~0.09 ms
// each at B = 64, H = 16).
//
// The bf16 entry launches the Hopper kernel of clip_flash_sm90.cuh (TMA
// loads, wgmma products, warp-specialised persistent blocks), which K11's
// bf16 entry launches too.
//
// The f32 twin (clip_flash_f32) keeps the first design, which K11's f32
// twin (clip_flash_proj.cu) shares: the one-pass online softmax over 64-key
// tiles of clip_flash.cuh, one block of 4 warps per (64-query tile, head,
// image), q in registers, k and v^T of each tile staged through 37 KB of
// shared memory, mma.sync with each f32 operand split into a bf16 (hi, lo)
// pair (common.cuh "Element types").  Its scores never reach device memory
// either; it already beats f32 SDPA on the card.
#include "clip_flash.cuh"
#include "clip_flash_sm90.cuh"

namespace gg {
namespace clip {

template <int HD>
__global__ void __launch_bounds__(128)
clip_flash_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int H,
                      float sl2) {
  using E = float;
  __shared__ __align__(16) KVTile<E, HD> t;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int D = H * HD;
  const E* head = qkv + (long)b * N * 3 * D + h * HD;
  const int q_row0 = blockIdx.x * kRows + warp * 16;

  float o[HeadDim<HD>::kTiles][4];
  attend_rows<HD>(head, D, N, q_row0, sl2, t, threadIdx.x, o);

  const int r0 = q_row0 + g, r1 = r0 + 8;
  E* orow0 = out + ((long)b * N + r0) * D + h * HD + 2 * c;
  E* orow1 = orow0 + 8L * D;
#pragma unroll
  for (int d = 0; d < HeadDim<HD>::kTiles; ++d) {
    if (r0 < N) store2(orow0 + d * 8, o[d][0], o[d][1]);
    if (r1 < N) store2(orow1 + d * 8, o[d][2], o[d][3]);
  }
}

int run_f32(const void* qkv, void* out, int B, int N, int H, int hd, float scale, void* stream) {
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  GG_HEAD_DIM_SWITCH(hd, {
    clip_flash_f32_kernel<HD><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), N, H, scale * kLog2e);
    return (int)cudaGetLastError();
  })
}

}  // namespace clip
}  // namespace gg

// qkv (B, N, 3D) and out (B, N, D), contiguous, bf16 through the Hopper
// kernel (qkv 16-byte aligned, as its tensor map needs) or f32 through the
// mma.sync twin.
extern "C" int clip_flash_bf16(const void* qkv, void* out, int B, int N, int H, int hd,
                               float scale, void* stream) {
  GG_HEAD_DIM_SWITCH(hd, {
    return gg::clip::sm90::run<HD>(qkv, out, B, N, H, scale, static_cast<cudaStream_t>(stream));
  })
}

extern "C" int clip_flash_f32(const void* qkv, void* out, int B, int N, int H, int hd,
                              float scale, void* stream) {
  return gg::clip::run_f32(qkv, out, B, N, H, hd, scale, stream);
}
