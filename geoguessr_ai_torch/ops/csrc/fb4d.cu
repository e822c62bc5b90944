// K9: K1 (the fused TinyViT attention block, LayerNorm -> qkv GEMM ->
// window attention -> out-projection + b_proj) over the raw (B, Hm, Wm, C)
// map, with no window partition or unpartition copy.
//
// Replaces geoguessr_ai_tpu/ops/window_attention.py:1869 _fb4d_pallas
// (kernel _fb4d_kernel): stage 1 of TinyViT-21M-512 with fused_block_4d, a
// (B, 64, 64, 192) map cut into 16x16 windows (N=256, H=6).  The TPU
// kernel moved the partition into its BlockSpec index map; here it becomes
// index arithmetic (common.cuh MapRows).
//
// The LayerNorm + qkv GEMM and the out-projection work row by row, so they
// run on the map's rows in map order with K1's own device code
// (common.cuh ln_gemm_kernel).  Only the attention launch needs the
// windows: it reads token (r, c) of window (b, i, j) from map row
// (b, i*ws + r, j*ws + c) of qkv and writes its output to the same row of
// the attention scratch.  Numerics are K1's: f32 LayerNorm statistics, the
// qkv GEMM rounded to bf16 before its bf16 bias, the bias rounded to bf16,
// f32 softmax, p rounded to bf16 before p.v, the f32 b_proj added to the f32
// out-projection sum.
//
// What bounds it on the H100: the same work as K1 at stage 1, bytes and
// the attention's exponentials (see fused_block.cu); at B=512 the map is
// 805 MB in and 805 MB out.  What it saves over K1 on the partitioned path
// is the two partition copies (a read and a write of the map each); qkv and
// the attention output still make one round trip through device memory.
// The _f32 twin runs the same launches in f32 (common.cuh "Element
// types").
#include "common.cuh"

namespace {

template <class E>
int fb4d(const void* x, const void* ln_scale, const void* ln_bias, const void* w_qkv_t,
         const void* b_qkv, const void* w_proj_t, const void* b_proj, const void* bias,
         void* qkv_scratch, void* attn_scratch, void* out, int B, int Hm, int Wm, int C, int H,
         int hd, int window, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * hd;
  const int M = B * Hm * Wm;
  const int N = window * window;
  const gg::MapRows rows{window, Hm / window, Wm / window};
  const int num_windows = B * rows.nwh * rows.nww;
  cudaError_t e = gg::launch_ln_gemm<true, true>(
      static_cast<const E*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const E*>(w_qkv_t),
      static_cast<const float*>(b_qkv), static_cast<E*>(qkv_scratch), M, C, 3 * D, eps, s);
  if (e != cudaSuccess) return (int)e;
  e = gg::launch_window_attention(static_cast<const E*>(qkv_scratch),
                                  static_cast<const E*>(bias), static_cast<E*>(attn_scratch),
                                  num_windows, N, H, hd, scale, s, rows);
  if (e != cudaSuccess) return (int)e;
  return (int)gg::launch_ln_gemm<false, false>(
      static_cast<const E*>(attn_scratch), nullptr, nullptr, static_cast<const E*>(w_proj_t),
      static_cast<const float*>(b_proj), static_cast<E*>(out), M, D, C, eps, s);
}

}  // namespace

extern "C" int fb4d_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                         const void* b_proj, const void* bias, void* qkv_scratch,
                         void* attn_scratch, void* out, int B, int Hm, int Wm, int C, int H,
                         int hd, int window, float scale, float eps, void* stream) {
  return fb4d<gg::bf16>(x, ln_scale, ln_bias, w_qkv_t, b_qkv, w_proj_t, b_proj, bias,
                        qkv_scratch, attn_scratch, out, B, Hm, Wm, C, H, hd, window, scale, eps,
                        stream);
}

extern "C" int fb4d_f32(const void* x, const void* ln_scale, const void* ln_bias,
                        const void* w_qkv_t, const void* b_qkv, const void* w_proj_t,
                        const void* b_proj, const void* bias, void* qkv_scratch,
                        void* attn_scratch, void* out, int B, int Hm, int Wm, int C, int H,
                        int hd, int window, float scale, float eps, void* stream) {
  return fb4d<float>(x, ln_scale, ln_bias, w_qkv_t, b_qkv, w_proj_t, b_proj, bias, qkv_scratch,
                     attn_scratch, out, B, Hm, Wm, C, H, hd, window, scale, eps, stream);
}
