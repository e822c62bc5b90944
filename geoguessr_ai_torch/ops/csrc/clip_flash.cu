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
// registers, k and v^T of each tile staged through 18 KB of shared memory,
// the scores never in device memory.  The k/v of one (image, head) are
// read by all ceil(N/64) = 10 query tiles, mostly from the 50 MB L2.  No
// TMA, wgmma or pipelining yet: the gap to the bound is later work.
#include "clip_flash.cuh"

namespace gg {
namespace clip {

template <int HD>
__global__ void __launch_bounds__(128)
clip_flash_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                  float sl2) {
  __shared__ __align__(16) KVTile<HD> t;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int D = H * HD;
  const bf16* head = qkv + (long)b * N * 3 * D + h * HD;
  const int q_row0 = blockIdx.x * kRows + warp * 16;

  float o[HeadDim<HD>::kTiles][4];
  attend_rows<HD>(head, D, N, q_row0, sl2, t, threadIdx.x, o);

  const int r0 = q_row0 + g, r1 = r0 + 8;
  bf16* orow0 = out + ((long)b * N + r0) * D + h * HD + 2 * c;
  bf16* orow1 = orow0 + 8L * D;
#pragma unroll
  for (int d = 0; d < HeadDim<HD>::kTiles; ++d) {
    if (r0 < N) *reinterpret_cast<uint32_t*>(orow0 + d * 8) = pack_bf16(o[d][0], o[d][1]);
    if (r1 < N) *reinterpret_cast<uint32_t*>(orow1 + d * 8) = pack_bf16(o[d][2], o[d][3]);
  }
}

}  // namespace clip
}  // namespace gg

extern "C" int clip_flash_bf16(const void* qkv, void* out, int B, int N, int H, int hd,
                               float scale, void* stream) {
  using namespace gg::clip;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  GG_HEAD_DIM_SWITCH(hd, {
    clip_flash_kernel<HD><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const gg::bf16*>(qkv), static_cast<gg::bf16*>(out), N, H,
        scale * gg::kLog2e);
    return (int)cudaGetLastError();
  })
}
