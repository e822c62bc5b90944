// K11: K6 with CLIP's attention out-projection inside the kernel:
// out = softmax(q k^T * scale) v @ W_out, hd = 64 (and 16 or 32), no bias
// (the bias add and the residual stay outside, as in the JAX package).
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
// The _f32 twin (common.cuh "Element types") keeps the attention rows in
// f32, and a (64, 1024) f32 tile beside the k/v tiles is over the 227 KB a
// block may have.  So it walks the heads in chunks of Dc channels: the
// attention of a chunk's heads into a (64, Dc) tile, then that tile's
// share of the projection, out = sum over chunks of o[:, chunk] @
// W[chunk, :], added in f32 into the output rows the block owns (the first
// chunk stores them).  At D = 1024 that is two chunks of 512 channels and
// 202 KB.  The bf16 entry takes one chunk of D: the design above.
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
constexpr size_t kSmemLimit = 232448;  // the most a block may opt into

// Bytes of the shared-memory region that holds the two k/v tiles during the
// attention and the W tile during the projection.
template <class E, int HD>
struct TilesBytes {
  static constexpr size_t kW = kProjCols * kWPitch * sizeof(E);
  static constexpr size_t value = 2 * sizeof(KVTile<E, HD>) > kW ? 2 * sizeof(KVTile<E, HD>) : kW;
};

// Dynamic shared memory of a block whose attention tile holds dc channels.
template <class E, int HD>
size_t smem_bytes(int dc) {
  return TilesBytes<E, HD>::value + (size_t)kRows * (dc + 8) * sizeof(E);
}

// The channels of one head chunk: D for bf16; for f32 the widest whole
// number of head pairs that divides D, is a multiple of kProjK and fits
// in shared memory.  0 when none does.
template <class E, int HD>
int chunk_channels(int H) {
  const int D = H * HD;
  if (sizeof(E) == 2) return D;
  for (int n = 1; n <= H / 2; ++n) {
    if ((H / 2) % n) continue;
    const int dc = D / n;
    if (dc % kProjK == 0 && smem_bytes<E, HD>(dc) <= kSmemLimit) return dc;
  }
  return 0;
}

template <class E, int HD>
__global__ void __launch_bounds__(256)
clip_flash_proj_kernel(const E* __restrict__ qkv, const E* __restrict__ wt, E* __restrict__ out,
                       int N, int H, int dc, float sl2) {
  extern __shared__ __align__(16) unsigned char smem[];
  KVTile<E, HD>* tiles = reinterpret_cast<KVTile<E, HD>*>(smem);  // one per group of 4 warps
  E* os = reinterpret_cast<E*>(smem + TilesBytes<E, HD>::value);
  E* ws = reinterpret_cast<E*>(smem);  // the W tile reuses the k/v tiles

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int grp = warp >> 2, gw = warp & 3;
  const int D = H * HD;
  const int o_pitch = dc + 8;  // conflict-free A-fragment reads
  const int row0 = blockIdx.x * kRows;
  const E* image = qkv + (long)b * N * 3 * D;
  const int wr = warp & 3, wc = warp >> 2;
  const int r0 = row0 + wr * 16 + g, r1 = r0 + 8;

  for (int c0 = 0; c0 < D; c0 += dc) {
    // 1. attention of the chunk's heads, two at a time, into os (in E).
    for (int h0 = c0 / HD; h0 < (c0 + dc) / HD; h0 += 2) {
      const int h = h0 + grp;
      float o[HeadDim<HD>::kTiles][4];
      attend_rows<HD>(image + h * HD, D, N, row0 + gw * 16, sl2, tiles[grp], tid & 127, o);
      E* orow = os + (gw * 16 + g) * o_pitch + h * HD - c0 + 2 * c;
#pragma unroll
      for (int d = 0; d < HeadDim<HD>::kTiles; ++d) {
        store2(orow + d * 8, o[d][0], o[d][1]);
        store2(orow + 8 * o_pitch + d * 8, o[d][2], o[d][3]);
      }
    }

    // 2. out[64, D] (+)= os[64, dc] @ W[c0:c0+dc, :]: per slab of 128
    // columns, warp (wr, wc) owns rows wr*16.. and columns wc*64.. of the
    // slab.
    for (int n0 = 0; n0 < D; n0 += kProjCols) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      for (int k0 = 0; k0 < dc; k0 += kProjK) {
        __syncthreads();  // os complete / the previous W tile consumed
        for (int i = tid; i < kProjCols * (kProjK / 8); i += 256) {
          const int r = i >> 3, ch = i & 7;
          store8(&ws[r * kWPitch + ch * 8], load8(wt + (long)(n0 + r) * D + c0 + k0 + ch * 8));
        }
        __syncthreads();
#pragma unroll
        for (int st = 0; st < kProjK / 16; ++st) {
          const E* ar = os + (wr * 16 + g) * o_pitch + k0 + st * 16 + 2 * c;
          Frag<E> a[4];
          a[0] = frag(ar);
          a[1] = frag(ar + 8 * o_pitch);
          a[2] = frag(ar + 8);
          a[3] = frag(ar + 8 * o_pitch + 8);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const E* br = &ws[(wc * 64 + nt * 8 + g) * kWPitch + st * 16 + 2 * c];
            mma(acc[nt], a, frag(br), frag(br + 8));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wc * 64 + nt * 8 + 2 * c;
        E* p0 = out + ((long)b * N + r0) * D + col;
        E* p1 = out + ((long)b * N + r1) * D + col;
        float2 v0 = make_float2(acc[nt][0], acc[nt][1]);
        float2 v1 = make_float2(acc[nt][2], acc[nt][3]);
        if (c0 > 0) {  // a later chunk: add to the earlier chunks' sum
          if (r0 < N) {
            const float2 s = load2(p0);
            v0.x += s.x;
            v0.y += s.y;
          }
          if (r1 < N) {
            const float2 s = load2(p1);
            v1.x += s.x;
            v1.y += s.y;
          }
        }
        if (r0 < N) store2(p0, v0.x, v0.y);
        if (r1 < N) store2(p1, v1.x, v1.y);
      }
    }
  }
}

template <class E>
int run(const void* qkv, const void* wt, void* out, int B, int N, int H, int hd, float scale,
        void* stream) {
  const dim3 grid((N + kRows - 1) / kRows, B);
  GG_HEAD_DIM_SWITCH(hd, {
    const int dc = chunk_channels<E, HD>(H);
    if (dc == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<E, HD>(dc);
    cudaError_t err = cudaFuncSetAttribute(
        clip_flash_proj_kernel<E, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    clip_flash_proj_kernel<E, HD><<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(qkv), static_cast<const E*>(wt), static_cast<E*>(out), N, H, dc,
        scale * kLog2e);
    return (int)cudaGetLastError();
  })
}

}  // namespace clip
}  // namespace gg

// wt is W_out transposed, (D_out, D_in) row-major: PyTorch's Linear layout.
// D = H * hd a multiple of 128 (so H is even).  qkv, wt and out bf16 (or
// f32 for the _f32 twin).
extern "C" int clip_flash_proj_bf16(const void* qkv, const void* wt, void* out, int B, int N,
                                    int H, int hd, float scale, void* stream) {
  return gg::clip::run<gg::bf16>(qkv, wt, out, B, N, H, hd, scale, stream);
}

extern "C" int clip_flash_proj_f32(const void* qkv, const void* wt, void* out, int B, int N,
                                   int H, int hd, float scale, void* stream) {
  return gg::clip::run<float>(qkv, wt, out, B, N, H, hd, scale, stream);
}
