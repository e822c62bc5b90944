// Device code shared by the two CLIP attention kernels of the port (K6
// clip_flash.cu, K11 clip_flash_proj.cu).
//
// Layouts follow the JAX package (geoguessr_ai_tpu/ops/clip_attention.py):
//   qkv (B, N, 3D) bf16 (or f32, the _f32 twins: common.cuh "Element
//       types"), token-major, channels in q|k|v blocks of D:
//       q = [0, D), k = [D, 2D), v = [2D, 3D); head h at [h*hd, (h+1)*hd)
//       of each block (hd = 64 for ViT-L/14 and ViT-B/32; 16 and 32 too,
//       the HD template parameter)
//   out (B, N, D) in qkv's type, head h at channels [h*hd, (h+1)*hd)
// N need not be a multiple of anything: ViT-L/14-336 has N = 577 = 9*64 + 1.
// Query rows >= N read as zero and are never written; key columns >= N
// score -inf and their v rows read as zero.
//
// attend_rows is one warp's 16 query rows of one head: the online
// (running max / running sum) softmax over 64-key tiles staged through
// shared memory by the warp's group of four warps, in f32, with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) for q.k^T and p.v.  p is
// rounded to bf16 (split in f32) before p.v as the Pallas kernel rounds it
// before its MXU dot; unlike the Pallas kernel (which normalises first) the rounded
// p is relative to the running max and the row sum is applied at the end,
// so the two round p at different scales: a relative 2^-9 each way.
#pragma once

#include "common.cuh"

namespace gg {
namespace clip {

constexpr int kRows = 64;        // query rows per group of 4 warps
constexpr int kBk = 64;          // keys per tile
constexpr int kVtPitch = kBk + 8;  // row pitch (elements) of the v^T tile: conflict-free reads

template <class E, int HD>
struct KVTile {
  E k[kBk * HeadDim<HD>::kPad];  // k rows: [key][dim]
  E vt[HD * kVtPitch];           // v transposed: [dim][key]
};

// o (16 x HD, f32, normalised) for rows q_row0 .. q_row0+15 of one head, in
// the mma C layout: o[d][0..1] = row g, cols d*8+2c..; o[d][2..3] = row g+8.
//   head: qkv + b*N*3D + h*HD (this image's token 0, this head's q column 0)
//   gtid: the thread's index 0..127 inside its group of four warps
// Every thread of the block must call this the same number of times: it
// synchronises the block around each k/v tile.
template <int HD, class E>
__device__ __forceinline__ void attend_rows(const E* __restrict__ head, int D, int N, int q_row0,
                                            float sl2, KVTile<E, HD>& t, int gtid,
                                            float o[HeadDim<HD>::kTiles][4]) {
  using T = HeadDim<HD>;
  constexpr int KP = T::kPad;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const long rs = 3L * D;

  // This warp's 16 query rows as A fragments, one per 16 dims.
  Frag<E> qa[T::kSteps][4];
  const int r0 = q_row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int s = 0; s < T::kSteps; ++s) {
    const int col = s * 16 + 2 * c;
    qa[s][0] = r0 < N ? frag(head + r0 * rs + col) : Frag<E>{};
    qa[s][1] = r1 < N ? frag(head + r1 * rs + col) : Frag<E>{};
    qa[s][2] = r0 < N ? frag(head + r0 * rs + col + 8) : Frag<E>{};
    qa[s][3] = r1 < N ? frag(head + r1 * rs + col + 8) : Frag<E>{};
  }

#pragma unroll
  for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain, rows g / g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // the previous tile is consumed
    // 64 keys x HD/8 chunks of 8 dims; a warp takes 32 keys of one chunk,
    // so the v^T scatter hits 32 distinct banks.
    for (int i = gtid; i < kBk * T::kVecs; i += 128) {
      const int key = i & (kBk - 1), ch = i >> 6;
      Vec8<E> kv{}, vv{};
      if (k0 + key < N) {
        const E* src = head + (k0 + key) * rs + ch * 8;
        kv = load8(src + D);
        vv = load8(src + 2 * D);
      }
      store8(&t.k[key * KP + ch * 8], kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) t.vt[(ch * 8 + j) * kVtPitch + key] = vv[j];
    }
    __syncthreads();

    // s = q k^T for 64 keys: 8 n-tiles of 8 keys, HD/16 k-steps of 16 dims.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const E* kr = &t.k[(nt * 8 + g) * KP + 2 * c];
#pragma unroll
      for (int st = 0; st < T::kSteps; ++st)
        mma(s[nt], qa[st], frag(kr + st * 16), frag(kr + st * 16 + 8));
    }

    // scale into the log2 domain, mask the ragged keys, running max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * c;
      s[nt][0] = col < N ? s[nt][0] * sl2 : -INFINITY;
      s[nt][1] = col + 1 < N ? s[nt][1] * sl2 : -INFINITY;
      s[nt][2] = col < N ? s[nt][2] * sl2 : -INFINITY;
      s[nt][3] = col + 1 < N ? s[nt][3] * sl2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one key < N, so mx is finite here
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int d = 0; d < T::kTiles; ++d) {
      o[d][0] *= alpha0;
      o[d][1] *= alpha0;
      o[d][2] *= alpha1;
      o[d][3] *= alpha1;
    }

    // o += bf16(p) v (p split in f32): 4 k-steps of 16 keys; the s
    // accumulators of n-tiles 2kk and 2kk+1 are exactly the A fragment of
    // k-step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag<E> pa[4];
      pa[0] = pack_frag<E>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_frag<E>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_frag<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_frag<E>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d) {
        const E* vr = &t.vt[(d * 8 + g) * kVtPitch + kk * 16 + 2 * c];
        mma(o[d], pa, frag(vr), frag(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d) {
    o[d][0] *= inv0;
    o[d][1] *= inv0;
    o[d][2] *= inv1;
    o[d][3] *= inv1;
  }
}

}  // namespace clip
}  // namespace gg
