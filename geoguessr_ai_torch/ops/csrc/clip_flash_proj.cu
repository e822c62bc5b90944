// K11: K6 with CLIP's attention out-projection:
// out = softmax(q k^T * scale) v @ W_out, hd = 64 (and 16 or 32), no bias
// (the bias add and the residual stay outside, as in the JAX package).
//
// Replaces geoguessr_ai_tpu/ops/clip_attention.py:247 _flash_proj_pallas
// (kernel _flash_proj_kernel, the out-projection at :224-244), which every
// encoder layer of CLIP ViT-L/14-336 launches with pallas_fuse_proj=True.
//
// The TPU grid runs in order, so the Pallas kernel adds each head chunk's
// partial o_chunk @ W[chunk rows] into one f32 VMEM accumulator and writes
// it on the last chunk.  Hopper's blocks run in parallel and a block has
// 227 KB of shared memory: a 128-row tile's attention output over all D
// channels (256 KB at D = 1024) does not fit beside K6's k/v ring.
//
// What bounds it on the H100: K6's work plus 2*N*D*D flops per image for
// the projection, about 1.65e11 flops against K6's ~303 MB at B = 64: the
// tensor cores (~0.17 ms).
//
// Each entry is two launches of the port's Hopper kernels, in one C call
// (three in f32, counting the split of k and v): K6's kernel writes the
// attention output o into a scratch the wrapper allocates, then the GEMM
// core (gemm_sm90.cuh: TMA ring of o and W_out k-boxes, wgmma.m64n256k16
// on two consumer warpgroups, persistent blocks in clusters of two)
// computes o @ W_out summed in f32.  In bf16 o is (B, N, D) bf16, rounded
// as the Pallas kernel rounds o_chunk before its dot (K6's bits), and the
// core's kBf16Bf16 kind rounds the sum once; in f32 K6's f32 kind writes
// o's bf16 hi / lo planes (2, B N, D) and the core's kSplitF32 kind sums
// lo.hi + hi.lo + hi.hi of o's and W_out's planes into the f32 output, so
// nothing is rounded on the way.  o's round trip through device memory
// costs about 151 MB (0.045 ms at 3.35 TB/s) at CLIP-L bucket 16 in either
// dtype, and W_out is read once from device memory into L2.  The first
// design (one block a 64-query tile looping over all heads with mma.sync,
// the projection from a (64, D) shared-memory tile, in head chunks in f32)
// read 2.07 ms there in bf16 and 4.88 in f32 on an H100.
#include "clip_flash_sm90.cuh"
#include "gemm_sm90.cuh"

// wt is W_out transposed, (D_out, D_in) row-major: PyTorch's Linear layout.
// D = H * hd a multiple of 128 (so H is even).  qkv, wt and out bf16 with
// 16-byte aligned bases; attn a (B, N, D) bf16 scratch for K6's output.
extern "C" int clip_flash_proj_bf16(const void* qkv, const void* wt, void* attn, void* out, int B,
                                    int N, int H, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  if (D % 128) return (int)cudaErrorInvalidValue;
  int e = (int)cudaErrorInvalidValue;
  GG_HEAD_DIM_SWITCH(hd, {
    e = gg::clip::sm90::run<HD>(qkv, attn, B, N, H, scale, s);
    break;
  })
  if (e != (int)cudaSuccess) return e;
  return (int)gg::gemm90::run<gg::gemm90::kBf16Bf16>(attn, wt, out, B * N, D, D, s);
}

// The f32 entry: qkv and out f32; wt W_out^T's bf16 (hi, lo) planes (2, D,
// D); attn a bf16 scratch of 6 B N D elements: k's and v's planes (2, B, N,
// 2D), then o's planes (2, B N, D).
extern "C" int clip_flash_proj_f32(const void* qkv, const void* wt, void* attn, void* out, int B, int N,
                                   int H, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  if (D % 128) return (int)cudaErrorInvalidValue;
  void* o2 = static_cast<gg::bf16*>(attn) + 4L * B * N * D;
  int e = (int)cudaErrorInvalidValue;
  GG_HEAD_DIM_SWITCH(hd, {
    e = gg::clip::sm90::run_f32<HD, true>(qkv, attn, o2, B, N, H, scale, s);
    break;
  })
  if (e != (int)cudaSuccess) return e;
  return (int)gg::gemm90::run<gg::gemm90::kSplitF32>(o2, wt, out, B * N, D, D, s);
}

// The f32 entry's last launch alone: the core's kSplitF32 kind on o's
// planes o2 (2, M, D) and wt (2, D, D), out (M, D) f32.  No wrapper counts
// it: it is not on any path; chip_smoke.py holds clip_flash_proj_f32
// against it applied to the split of K6's f32 output.
extern "C" int clip_flash_proj_gemm_f32(const void* o2, const void* wt, void* out, int M, int D,
                                        void* stream) {
  return (int)gg::gemm90::run<gg::gemm90::kSplitF32>(o2, wt, out, M, D, D, static_cast<cudaStream_t>(stream));
}
