// K6's bf16 kernel, the Hopper (sm_90a) CLIP attention: softmax(q k^T *
// scale) v read straight from the fused token-major (B, N, 3D) qkv
// tensor, no bias or mask, hd = 64 (and 16 or 32), written to (B, N, D).
// K6's bf16 entry (clip_flash.cu) launches it alone; K11's bf16 entry
// (clip_flash_proj.cu) launches it into a scratch and then the GEMM core
// (gemm_sm90.cuh) on that scratch, so both libraries carry it and K11's
// attention is K6's bit for bit.
//
// The kernel (clip_flash_sm90 below) is built from what Hopper adds,
// so that instruction issue and latency stand in the way of neither bound:
//   * wgmma for both products.  s = q k^T is wgmma.m64n128k16 with q and
//     the k tile in shared memory (K-major); o += p v is
//     wgmma.m64n{hd}k16 with p in registers (the f32 s accumulator repacked
//     to bf16 in place: two n8 accumulator tiles are one k16 A fragment)
//     and the v tile read MN-major by the transpose bit, so v is never
//     transposed by hand.
//   * TMA for every load: one 3D tensor map over qkv (3D, N, B) with a box
//     of (hd, 128 rows, 1) and the swizzle of one row's bytes (128 B at hd
//     64, 64 B at 32, 32 B at 16), which is the layout the wgmma
//     descriptors name.  q, k and v of head h are the column coordinates
//     h*hd, D + h*hd, 2D + h*hd; rows >= N come back as zeros, so the
//     ragged tile needs no guard on its loads.
//   * Warp specialisation: warpgroup 0 gives up its registers
//     (setmaxnreg) and one of its threads keeps the loads in flight, q
//     through two buffers and k/v through a ring of kStages = 5 stages (all
//     of N = 577's tiles), each with a full and an empty mbarrier;
//     warpgroups 1 and 2 take the registers and own 64 query rows each.
//   * One persistent block per SM walks the (128-query tile, head, image)
//     items, so the producer loads the next item's q, k and v while the
//     consumers finish the current one: no block pays the latency of its
//     first loads or of its launch.  An (image, head)'s k and v are read
//     by ceil(N/128) = 5 items, mostly from the 50 MB L2: half the re-reads
//     of 64-row tiles.
// The online softmax runs in registers: the running max over the raw
// scores, p = exp2(s * scale*log2(e) - m) in one FFMA and one exp2, keys >=
// N set to -inf in the last tile only.  p is rounded to bf16 relative to
// the running max, as the f32 twin and K11 round it, and the row sums are
// applied at the end.  Exponentials (one per score, 16 a clock on an SM)
// and products take about equal time here; handing the tensor cores to
// the two consumer groups in turns (named barriers) or overlapping a
// group's softmax with its own p.v product were both slower on the card.
//
//
// Everything here has internal linkage (the unnamed namespace below), so
// each library that includes this header keeps its own opt-in flags: a
// function-local static of a function with external linkage is one
// GNU-unique object across the libraries of a process.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "sm90.cuh"

namespace gg {
namespace clip {
namespace sm90 {
namespace {

constexpr int kRowsQ = 128;    // query rows a block: two consumer warpgroups of 64
constexpr int kKeys = 128;     // keys a k/v tile
constexpr int kStages = 5;     // k/v tiles in flight: all of N = 577's five
constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// One (128 rows, HD) bf16 tile as TMA writes it and wgmma reads it: rows
// of HD*2 bytes, swizzled over that span, 8-row groups kSbo bytes apart.
template <int HD>
struct Tile {
  static constexpr int kRowBytes = HD * 2;
  static constexpr int kBytes = kKeys * kRowBytes;
  static constexpr uint32_t kSbo = 8 * kRowBytes;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = HD == 64 ? 1 : HD == 32 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      HD == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  // two q tiles, kStages k and kStages v tiles from a 1024-byte aligned
  // base, then the barriers; 1024 bytes of slack for the alignment.
  static constexpr int kBarOffset = (2 + 2 * kStages) * kBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (4 + 3 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused by these swizzled layouts: K-major, or MN-major one swizzle atom
// wide), stride byte offset between 8-row groups, layout type.
template <int HD>
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(Tile<HD>::kSbo >> 4) << 32) | (Tile<HD>::kLayout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.  Every wait in
// this kernel ends within microseconds; one that has not after 2^26 tries
// (seconds) is a fault of the pipeline, and the kernel traps rather than
// hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One TMA load of the box at (c0 columns, c1 rows, c2 image) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, shared, K-major) . B (16 x 128, shared, K-major).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 16, f32) += A (64 x 16, bf16 registers) . B (16 x 16, shared, MN-major).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 32, f32) += A (64 x 16, bf16 registers) . B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// s (64 x 128) = q k^T over HD/16 k-steps of 32 bytes inside the swizzled
// rows.
template <int HD>
__device__ __forceinline__ void wgmma_s(float (&sc)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk);
}

// o += bf16(p) v over 8 k-steps of 16 keys; the v rows of k-step kk start
// 16 rows further into the tile.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&pa)[8][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t d = dv + ((uint64_t)(kk * 16 * Tile<HD>::kRowBytes) >> 4);
    if constexpr (HD == 64) wgmma_m64n64k16_rs(o, pa[kk], d);
    else if constexpr (HD == 32) wgmma_m64n32k16_rs(o, pa[kk], d);
    else wgmma_m64n16k16_rs(o, pa[kk], d);
  }
}

// The online softmax of one consumer thread's two rows (g and g + 8).
struct Softmax {
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  float alpha0 = 1.f, alpha1 = 1.f;      // the last tile's rescale of o

  // One tile of raw scores from key k0 on: mask keys >= N when the tile
  // reaches past N, update the running max (scale > 0, so the max of the
  // raw scores scales to the max in the log2 domain) and sums, and leave
  // p = exp2(s * sl2 - m) in sc.
  __device__ __forceinline__ void tile(float (&sc)[64], int k0, int N, float sl2) {
    if (k0 + kKeys > N) {
      const int key0 = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int key = key0 + 8 * t;
        if (key >= N) sc[4 * t + 0] = sc[4 * t + 2] = -INFINITY;
        if (key + 1 >= N) sc[4 * t + 1] = sc[4 * t + 3] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * t + 0], sc[4 * t + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * t + 2], sc[4 * t + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one key < N, so the new max is finite
    const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
    alpha0 = exp2f(m0 - n0);
    alpha1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      sc[4 * t + 0] = exp2f(fmaf(sc[4 * t + 0], sl2, -n0));
      sc[4 * t + 1] = exp2f(fmaf(sc[4 * t + 1], sl2, -n0));
      sc[4 * t + 2] = exp2f(fmaf(sc[4 * t + 2], sl2, -n1));
      sc[4 * t + 3] = exp2f(fmaf(sc[4 * t + 3], sl2, -n1));
      rs0 += sc[4 * t + 0] + sc[4 * t + 1];
      rs1 += sc[4 * t + 2] + sc[4 * t + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
  }

  // o *= alpha (o holds the sum over the tiles before the last one).
  template <int ND>
  __device__ __forceinline__ void rescale(float (&o)[ND]) const {
#pragma unroll
    for (int t = 0; t < ND / 4; ++t) {
      o[4 * t + 0] *= alpha0;
      o[4 * t + 1] *= alpha0;
      o[4 * t + 2] *= alpha1;
      o[4 * t + 3] *= alpha1;
    }
  }
};

// bf16(p) as the A fragments of the 8 k-steps of p v: accumulator tiles
// 2kk and 2kk+1 are the A fragment of k-step kk.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// A persistent block walks the items (128-query tile, head, image) w =
// blockIdx.x, + gridDim.x, ...; w's query tile is fastest, so the blocks
// in flight share the k and v of a few (image, head) pairs in L2.  The
// producer runs ahead across items: q through two buffers, k/v through
// the ring of kStages stages.  Accumulator layout of a consumer thread
// (warp w of its group, lane = 4g + c), as mma.sync's C fragment in each
// 8-column tile t: d[4t + 0..1] = row 16w + g, columns 8t + 2c + 0..1;
// d[4t + 2..3] = row 16w + g + 8, the same columns.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
clip_flash_sm90(const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out, int N, int H,
                int B, float sl2) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                         // q buffer i at + i * kBytes
  const uint32_t sk = base + 2 * T::kBytes;         // stage s at + s * kBytes
  const uint32_t sv = sk + kStages * T::kBytes;
  const uint32_t full_q = base + T::kBarOffset;     // + 8 i
  const uint32_t empty_q = full_q + 16;             // + 8 i, released by the 8 consumer warps
  const uint32_t full_k = empty_q + 16;             // + 8 s
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;      // released by the 8 consumer warps

  const int D = H * HD;
  const int tiles = (N + kKeys - 1) / kKeys;
  const int qtiles = (N + kRowsQ - 1) / kRowsQ;
  const int items = qtiles * H * B;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_q + 8 * i, 1);
      mbar_init(empty_q + 8 * i, 8);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int kv = 0;  // k/v tiles loaded so far: the ring position
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int qt = w % qtiles, h = (w / qtiles) % H, b = w / (qtiles * H);
        const int qb = i & 1;
        if (i >= 2) mbar_wait(empty_q + 8 * qb, ((i >> 1) - 1) & 1);
        mbar_expect_tx(full_q + 8 * qb, T::kBytes);
        tma_load(sq + qb * T::kBytes, &qkv_map, full_q + 8 * qb, h * HD, qt * kRowsQ, b);
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int s = kv % kStages;
          if (kv >= kStages) mbar_wait(empty + 8 * s, ((kv / kStages) - 1) & 1);
          mbar_expect_tx(full_k + 8 * s, T::kBytes);
          tma_load(sk + s * T::kBytes, &qkv_map, full_k + 8 * s, D + h * HD, j * kKeys, b);
          mbar_expect_tx(full_v + 8 * s, T::kBytes);
          tma_load(sv + s * T::kBytes, &qkv_map, full_v + 8 * s, 2 * D + h * HD, j * kKeys, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cg = group - 1;  // query rows 64 cg .. of each q tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    auto dk = [&](int kv) { return desc<HD>(sk + (kv % kStages) * T::kBytes); };
    auto dv = [&](int kv) { return desc<HD>(sv + (kv % kStages) * T::kBytes); };
    auto parity = [](int kv) { return (uint32_t)(kv / kStages) & 1; };
    // this warp is done with a barrier's buffer
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int kv = 0;  // the ring position of this item's first k/v tile
    for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i, kv += tiles) {
      const int qt = w % qtiles, h = (w / qtiles) % H, b = w / (qtiles * H);
      const int qb = i & 1;
      const uint64_t dq = desc<HD>(sq + qb * T::kBytes + cg * 64 * T::kRowBytes);
      float o[HD / 2];
      zero(o);
      Softmax sm;
      float sc[64];
      uint32_t pa[8][4];

      // s_0 = q k_0^T and its softmax
      mbar_wait(full_q + 8 * qb, (i >> 1) & 1);
      zero(sc);
      mbar_wait(full_k + 8 * (kv % kStages), parity(kv));
      fence_regs(sc);
      wgmma_fence();
      wgmma_s<HD>(sc, dq, dk(kv));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if (tiles == 1) release(empty_q + 8 * qb);
      sm.tile(sc, 0, N, sl2);
      pack_p(sc, pa);
      for (int j = 1; j < tiles; ++j) {
        // s_j = q k_j^T and o += p_{j-1} v_{j-1}, then the softmax of tile j
        zero(sc);
        mbar_wait(full_k + 8 * ((kv + j) % kStages), parity(kv + j));
        mbar_wait(full_v + 8 * ((kv + j - 1) % kStages), parity(kv + j - 1));
        fence_regs(sc);
        fence_regs(o);
        wgmma_fence();
        wgmma_s<HD>(sc, dq, dk(kv + j));
        wgmma_pv<HD>(o, pa, dv(kv + j - 1));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(o);
        if (j == tiles - 1) release(empty_q + 8 * qb);  // done with q
        release(empty + 8 * ((kv + j - 1) % kStages));  // done with tile j-1
        sm.tile(sc, j * kKeys, N, sl2);
        sm.rescale(o);
        pack_p(sc, pa);
      }
      // o += p_last v_last
      mbar_wait(full_v + 8 * ((kv + tiles - 1) % kStages), parity(kv + tiles - 1));
      fence_regs(o);
      wgmma_fence();
      wgmma_pv<HD>(o, pa, dv(kv + tiles - 1));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      release(empty + 8 * ((kv + tiles - 1) % kStages));

      float l0 = sm.l0, l1 = sm.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int r0 = qt * kRowsQ + cg * 64 + warp * 16 + g, r1 = r0 + 8;
      bf16* orow0 = out + ((long)b * N + r0) * D + h * HD + 2 * c;
      bf16* orow1 = orow0 + 8L * D;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t) {
        if (r0 < N)
          *reinterpret_cast<uint32_t*>(orow0 + 8 * t) =
              pack_bf16(o[4 * t + 0] * inv0, o[4 * t + 1] * inv0);
        if (r1 < N)
          *reinterpret_cast<uint32_t*>(orow1 + 8 * t) =
              pack_bf16(o[4 * t + 2] * inv1, o[4 * t + 3] * inv1);
      }
    }
  }
}

// One launch into out (B, N, D) bf16; its opt-in flag is this library's
// own (the unnamed namespace).
template <int HD>
int run(const void* qkv, void* out, int B, int N, int H, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  // qkv (B, N, 3D) bf16, innermost first, in boxes of (HD, kKeys rows);
  // rows 6D bytes apart (a multiple of 16 as TMA needs: D is a multiple of
  // 16), images 6DN.
  CUtensorMap map;
  cudaError_t e = ::gg::sm90::encode_3d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qkv, 3L * H * HD,
                                        N, B, HD, kKeys, T::kSwizzle);
  int sms = 0;  // the card's SMs: one persistent block on each
  if (e == cudaSuccess) e = ::gg::sm90::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  static bool opted_in = false;  // one per head dim
  if (!opted_in) {
    e = cudaFuncSetAttribute(clip_flash_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const long items = (long)((N + kRowsQ - 1) / kRowsQ) * H * B;
  const int grid = (int)(items < sms ? items : sms);
  clip_flash_sm90<HD><<<grid, kThreads, T::kSmem, stream>>>(map, static_cast<bf16*>(out), N, H, B,
                                                           scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace clip
}  // namespace gg
