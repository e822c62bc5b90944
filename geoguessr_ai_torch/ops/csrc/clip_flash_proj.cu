// K11: K6 with CLIP's attention out-projection inside the kernel:
// out = softmax(q k^T * scale) v @ W_out, hd = 64, no bias (the bias add and
// the residual stay outside, as in the JAX package).
//
// Replaces geoguessr_ai_tpu/ops/clip_attention.py:247 _flash_proj_pallas
// (kernel _flash_proj_kernel, the out-projection at :224-244), which every
// encoder layer of CLIP ViT-L/14-336 launches with pallas_fuse_proj=True.
//
// The TPU grid runs in order, so the Pallas kernel adds each head chunk's
// partial o_chunk @ W[chunk rows] into one f32 VMEM accumulator and writes
// it on the last chunk.  Hopper's blocks run in parallel, so this kernel
// takes the first of the three ways around that: ONE block owns a 64-query
// tile of one image and loops over ALL heads.  Its 8 warps run two heads at
// a time (warps 0-3 the even head, 4-7 the odd one; attend_rows in
// clip_flash.cuh), and each head's normalised output is rounded to bf16
// (as the Pallas kernel rounds o_chunk before its dot) into a (64, D)
// shared-memory tile: 129 KB at D = 1024.  Then the same block multiplies
// that tile by W_out in slabs of 128 output columns, summing over all D
// input channels in f32 registers and rounding each output once.  Cost of
// the choice: no atomics, no partial sums in device memory and no
// recomputed attention; but each block's 169 KB of shared memory allows
// one block (8 warps) per SM, ceil(N/64) * B = 640 blocks at bucket 16,
// and W_out (2 MB) is re-read from L2 by every block.
//
// What bounds it on the H100: K6's work plus 2*N*D*D flops per image for
// the projection, about 1.65e11 flops against K6's ~303 MB at B = 64: the
// tensor cores (~0.17 ms).
#include "clip_flash.cuh"

namespace gg {
namespace clip {

constexpr int kProjCols = 128;  // output columns per slab
constexpr int kProjK = 64;      // input channels per W tile
constexpr int kWPitch = kProjK + 8;

__global__ void __launch_bounds__(256)
clip_flash_proj_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wt,
                       bf16* __restrict__ out, int N, int H, float sl2) {
  extern __shared__ __align__(16) unsigned char smem[];
  KVTile* tiles = reinterpret_cast<KVTile*>(smem);  // one per group of 4 warps
  bf16* os = reinterpret_cast<bf16*>(smem + 2 * sizeof(KVTile));
  bf16* ws = reinterpret_cast<bf16*>(smem);  // the W tile reuses the k/v tiles

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int grp = warp >> 2, gw = warp & 3;
  const int D = H * kHd;
  const int o_pitch = D + 8;  // conflict-free A-fragment reads
  const int row0 = blockIdx.x * kRows;
  const bf16* image = qkv + (long)b * N * 3 * D;

  // 1. attention, two heads at a time, into os (bf16).
  for (int h0 = 0; h0 < H; h0 += 2) {
    const int h = h0 + grp;
    float o[8][4];
    attend_rows(image + h * kHd, D, N, row0 + gw * 16, sl2, tiles[grp], tid & 127, o);
    bf16* orow = os + (gw * 16 + g) * o_pitch + h * kHd + 2 * c;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      *reinterpret_cast<uint32_t*>(orow + d * 8) = pack_bf16(o[d][0], o[d][1]);
      *reinterpret_cast<uint32_t*>(orow + 8 * o_pitch + d * 8) = pack_bf16(o[d][2], o[d][3]);
    }
  }

  // 2. out[64, D] = os[64, D] @ W: per slab of 128 columns, warp (wr, wc)
  // owns rows wr*16.. and columns wc*64.. of the slab.
  const int wr = warp & 3, wc = warp >> 2;
  const int r0 = row0 + wr * 16 + g, r1 = r0 + 8;
  for (int n0 = 0; n0 < D; n0 += kProjCols) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kProjK) {
      __syncthreads();  // os complete / the previous W tile consumed
      for (int i = tid; i < kProjCols * (kProjK / 8); i += 256) {
        const int r = i >> 3, ch = i & 7;
        *reinterpret_cast<uint4*>(&ws[r * kWPitch + ch * 8]) =
            *reinterpret_cast<const uint4*>(wt + (long)(n0 + r) * D + k0 + ch * 8);
      }
      __syncthreads();
#pragma unroll
      for (int st = 0; st < kProjK / 16; ++st) {
        const bf16* ar = os + (wr * 16 + g) * o_pitch + k0 + st * 16 + 2 * c;
        uint32_t a[4];
        a[0] = ld32(ar);
        a[1] = ld32(ar + 8 * o_pitch);
        a[2] = ld32(ar + 8);
        a[3] = ld32(ar + 8 * o_pitch + 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* br = &ws[(wc * 64 + nt * 8 + g) * kWPitch + st * 16 + 2 * c];
          mma_bf16_16816(acc[nt], a, ld32(br), ld32(br + 8));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wc * 64 + nt * 8 + 2 * c;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(out + ((long)b * N + r0) * D + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(out + ((long)b * N + r1) * D + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
}

}  // namespace clip
}  // namespace gg

// wt is W_out transposed, (D_out, D_in) row-major: PyTorch's Linear layout.
extern "C" int clip_flash_proj_bf16(const void* qkv, const void* wt, void* out, int B, int N,
                                    int H, float scale, void* stream) {
  using namespace gg::clip;
  const int D = H * kHd;
  const size_t smem = 2 * sizeof(KVTile) + (size_t)kRows * (D + 8) * sizeof(gg::bf16);
  cudaError_t err = cudaFuncSetAttribute(
      clip_flash_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kRows - 1) / kRows, B);
  clip_flash_proj_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const gg::bf16*>(qkv), static_cast<const gg::bf16*>(wt),
      static_cast<gg::bf16*>(out), N, H, scale * gg::kLog2e);
  return (int)cudaGetLastError();
}
