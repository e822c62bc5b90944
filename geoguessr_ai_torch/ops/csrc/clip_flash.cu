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
// Both entries launch the Hopper kernel of clip_flash_sm90.cuh (TMA loads,
// wgmma products, warp-specialised persistent blocks), which K11's entries
// launch too: the bf16 entry its bf16 kind, the f32 entry its f32 kind
// (k and v of the f32 qkv split once into bf16 hi / lo planes in the
// scratch `planes`, q split in registers, every product as three wgmma:
// "The f32 kind" there).
#include "clip_flash_sm90.cuh"

// qkv (B, N, 3D) and out (B, N, D), contiguous with 16-byte aligned bases
// (the tensor maps'), bf16; planes is not read.
extern "C" int clip_flash_bf16(const void* qkv, void* /*planes*/, void* out, int B, int N, int H, int hd,
                               float scale, void* stream) {
  GG_HEAD_DIM_SWITCH(hd, {
    return gg::clip::sm90::run<HD>(qkv, out, B, N, H, scale, static_cast<cudaStream_t>(stream));
  })
}

// The same in f32; planes a (2, B, N, 2D) bf16 scratch for k's and v's
// split.
extern "C" int clip_flash_f32(const void* qkv, void* planes, void* out, int B, int N, int H, int hd,
                              float scale, void* stream) {
  GG_HEAD_DIM_SWITCH(hd, {
    return gg::clip::sm90::run_f32<HD, false>(qkv, planes, out, B, N, H, scale,
                                             static_cast<cudaStream_t>(stream));
  })
}
