// K6: CLIP self-attention softmax(q k^T * scale) v read straight from the
// fused token-major (B, N, 3D) qkv tensor, no bias or mask, hd = 64 (and
// 16 or 32).
//
// Replaces geoguessr_ai_tpu/ops/clip_attention.py:134 _flash_pallas
// (kernel _flash_kernel), which every encoder layer of CLIP ViT-L/14-336
// launches (B images, N = 577, H = 16; 24 launches per forward).
//
// What bounds it on the H100: per (image, head) it reads 3*N*64 qkv values
// and writes N*64, and does 4*N*N*64 flops: N/2 ~ 288 flops per byte at
// N = 577, just under the card's ~295 flops per byte ridge, so the ideal
// kernel is bound about equally by bytes and by the tensor cores (~0.09 ms
// each at B = 64).  The TPU kernel held one head-chunk's whole
// (HB, 577, 577) f32 score block in VMEM; one head's 577 f32 scores per
// query row already outgrow what a Hopper SM can keep per row block, so
// this design (clip_flash.cuh) is the one-pass online softmax over 64-key
// tiles: one block of 4 warps per (64-query tile, head, image), q in
// registers, k and v^T of each tile staged through 18 KB of shared memory
// (37 KB in f32), the scores never in device memory.  The k/v of one
// (image, head) are read by all ceil(N/64) = 10 query tiles, mostly from
// the 50 MB L2.  No TMA, wgmma or pipelining yet: the gap to the bound is
// later work.  The _f32 twin runs the same design in f32 (common.cuh
// "Element types"): twice the bytes, three MMAs a product.
#include "clip_flash.cuh"

namespace gg {
namespace clip {

template <class E, int HD>
__global__ void __launch_bounds__(128)
clip_flash_kernel(const E* __restrict__ qkv, E* __restrict__ out, int N, int H, float sl2) {
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

template <class E>
int run(const void* qkv, void* out, int B, int N, int H, int hd, float scale, void* stream) {
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  GG_HEAD_DIM_SWITCH(hd, {
    clip_flash_kernel<E, HD><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(qkv), static_cast<E*>(out), N, H, scale * kLog2e);
    return (int)cudaGetLastError();
  })
}

}  // namespace clip
}  // namespace gg

// qkv and out bf16 (or f32 for the _f32 twin).
extern "C" int clip_flash_bf16(const void* qkv, void* out, int B, int N, int H, int hd,
                               float scale, void* stream) {
  return gg::clip::run<gg::bf16>(qkv, out, B, N, H, hd, scale, stream);
}

extern "C" int clip_flash_f32(const void* qkv, void* out, int B, int N, int H, int hd,
                              float scale, void* stream) {
  return gg::clip::run<float>(qkv, out, B, N, H, hd, scale, stream);
}
