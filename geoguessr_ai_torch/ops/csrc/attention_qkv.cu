// K3: window attention read straight from the fused (W, N, 3D) qkv tensor.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:351
// _attention_qkv_fused_pallas (kernel _qkv_fused_kernel), the stage-3
// attention of TinyViT-21M-512 (N=256, H=18, hd=32).  Numerics as there:
// f32 scores plus the bias in the activations' dtype (bf16 in the bf16
// entry), upcast at use, the softmax in f32, p normalised in f32 before it
// is rounded to bf16 for the p.v product (up to N = 256, where a chunk is
// the whole score row; above, the online softmax in chunks of key tiles).
//
// What bounds it on the H100: per (window, head) it reads N*3*hd qkv
// values and H*N*N bias values and does 4*N*N*hd flops.  At hd=32 that is
// 64 flops per bias byte, under the card's ~295 flops/byte ridge, so the
// bias read and the N*N exponentials weigh as much as the two products.
//
// The bf16 entry runs the Hopper forward core (attention_fwd_sm90.cuh,
// which K8a and K8b share) in its interleaved layout: one TMA tensor map
// over qkv read in boxes of (hd, 64 rows) at column (3 h + slot) hd, the
// item's 64 x N bf16 bias tile resident over a group of windows
// (window_attention._headmajor_groups: 14 at stage 3), wgmma for both
// products, persistent warp-specialised blocks; out (W, N, D) written by
// the thread that owns each element.  The resident tile of N = 1024 is 128
// KB, so every N up to 1024 fits at every head dim; where make_plan finds
// no room beside it (first at N = 1280 with hd 64), the entry returns
// cudaErrorInvalidValue.
//
// The _f32 twin takes qkv, the bias and out in f32 and runs common.cuh's
// first design (mma.sync, k and v^T staged through shared memory per
// 64-key tile, the online softmax; common.cuh "Element types").
#include "attention_fwd_sm90.cuh"

// `groups` is the bf16 core's window groups G (window_attention.
// _headmajor_groups); the f32 twin does not take it.
extern "C" int attention_qkv_bf16(const void* qkv, const void* bias, void* out, int W,
                                  int N, int H, int hd, int groups, float scale, void* stream) {
  using namespace gg::fwd90;
  GG_HEAD_DIM_SWITCH(hd, {
    return (int)run<kQkv, gg::bf16, HD, false>(qkv, qkv, qkv, bias, out, W, H, N, groups, scale,
                                               static_cast<cudaStream_t>(stream));
  })
}

extern "C" int attention_qkv_f32(const void* qkv, const void* bias, void* out, int W, int N,
                                 int H, int hd, int /*groups*/, float scale, void* stream) {
  return (int)gg::launch_window_attention(
      static_cast<const float*>(qkv), static_cast<const float*>(bias), static_cast<float*>(out),
      W, N, H, hd, scale, static_cast<cudaStream_t>(stream));
}
