// K6's kernel, the Hopper (sm_90a) CLIP attention: softmax(q k^T *
// scale) v read straight from the fused token-major (B, N, 3D) qkv
// tensor, no bias or mask, hd = 64 (and 16 or 32), written to (B, N, D),
// in a bf16 kind and an f32 kind ("The f32 kind" below).  K6's entries
// (clip_flash.cu) launch it alone; K11's entries (clip_flash_proj.cu)
// launch it into a scratch and then the GEMM core (gemm_sm90.cuh) on that
// scratch, so both libraries carry it and K11's attention is K6's bit for
// bit in either dtype.
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
// the running max, as the Pallas kernel rounds it (the f32 kind splits it
// instead), and the row sums are applied at the end.  Exponentials (one
// per score, 16 a clock on an SM) and products take about equal time here;
// handing the tensor cores to the two consumer groups in turns (named
// barriers) or overlapping a group's softmax with its own p.v product were
// both slower on the card.
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

// ---------------------------------------------------------------------------
// The f32 kind (K6's and K11's f32 entries).  The numerics of the f32 kinds
// of the other cores: every product splits its f32 operands into bf16 hi =
// bf16(x) and lo = bf16(x - hi) and sums lo.hi + hi.lo + hi.hi in f32 (three
// wgmma for one, about 2^-17 of error a product); the softmax is online in
// f32 as above; p is split in registers (split_p), never rounded; o is the
// f32 sum over l.  Nothing is rounded to bf16 on the way.
//
// wgmma reads bf16 operands, and k and v are B operands, read from shared
// memory in the swizzled layout TMA writes.  So a call is two launches.
// First split_kv writes k and v of the f32 qkv as their bf16 hi and lo
// planes (2, B, N, 2D) into a scratch the wrapper allocates (CLIP's qkv
// comes from cuBLAS, so no kernel of the port can store it split as the LN
// + GEMM core's f32 kind stores K2's): at CLIP-L bucket 16 it reads and
// writes 302 MB each, about 0.18 ms at 3.35 TB/s, once, where splitting
// them inside the attention would redo it for each of the 5 q-tiles that
// read them (that cost K2's f32 attention 0.79 of 2.26 ms).  Then
// clip_flash_f32_sm90 is the bf16 kernel with every k and v tile a pair:
// the producer loads the hi tile from plane image b and the lo tile from
// plane image B + b of one tensor map over the planes, and q's 128 rows in
// f32 by a second tensor map over qkv itself (unswizzled); each consumer
// thread splits its two q rows once an item into the A fragments of the
// score products (q_frags, in registers for the whole item) and releases
// the q buffer at once, so one buffer lets the next item's q land
// meanwhile.  The score products take A from registers and k K-major
// (split_scores), the p.v products p split in registers and v MN-major
// (split_pv).  A pair is twice a bf16 tile: one q tile and kF32Stages<HD>
// k/v stages fit (3 at hd 64: 225 KB of the 227 a block may have; all 5 of
// N = 577's tiles at hd 16 and 32).  Registers of a consumer thread while
// s_j and p_{j-1}.v_{j-1} are in flight: the scores (64), p's hi and lo
// fragments (64), q's (HD / 4) and o (HD / 2).
//
// PLANES = false writes out (B, N, D) f32 (K6); PLANES = true writes each
// normalised output value's hi and lo into the planes (2, B N, D) bf16 of
// o that K11's second launch, the GEMM core's kSplitF32 kind, reads: the
// split the core would make of K6's stored f32 output (the product by
// 1 / l is __fmul_rn in both, never contracted into the split's
// subtraction), so K11's f32 entry equals that kind on split(K6-f32) bit
// for bit.
// ---------------------------------------------------------------------------

constexpr int kF32QBufs = 1;  // f32 q tiles in flight (each released once split)
constexpr int kSmemMax = 232448;

constexpr int f32_bar_bytes(int stages) { return 8 * (2 * kF32QBufs + 3 * stages); }

// The f32 kind's shared memory at head dim HD: kF32QBufs f32 q tiles of
// kRowsQ rows, then kF32Stages k/v stages of a k pair and a v pair (each
// pair a hi tile, then its lo tile, Tile<HD>::kBytes each) from the
// 1024-aligned base, then the barriers: full and empty of each q tile,
// full k, full v and empty of each stage.
template <int HD>
struct TileF32 {
  static constexpr int kQBytes = kRowsQ * HD * 4;
  static constexpr int kPair = 2 * Tile<HD>::kBytes;
  static constexpr int kFit =
      (kSmemMax - 1024 - kF32QBufs * kQBytes - f32_bar_bytes(kStages)) / (2 * kPair);
  static constexpr int kF32Stages = kFit < kStages ? kFit : kStages;
  static_assert(kF32Stages >= 2, "two k/v stages in flight");
  static constexpr int kBarOffset = kF32QBufs * kQBytes + 2 * kF32Stages * kPair;
  static constexpr int kSmem = 1024 + kBarOffset + f32_bar_bytes(kF32Stages);
};

// k and v of the f32 qkv (rows of 3D floats, d4 = D / 4) as their bf16 hi
// plane at hi and lo plane at lo, rows of 2D: n4 float4 of k and v in all.
__global__ void __launch_bounds__(256)
split_kv(const float4* __restrict__ x, uint2* __restrict__ hi, uint2* __restrict__ lo, long n4, int d4) {
  for (long i = blockIdx.x * 256L + threadIdx.x; i < n4; i += (long)gridDim.x * 256) {
    const long row = i / (2 * d4);
    const float4 v = x[row * 3 * d4 + d4 + (i - row * 2 * d4)];
    const Frag<float> a = split_pair(v.x, v.y), b = split_pair(v.z, v.w);
    hi[i] = make_uint2(a.hi, b.hi);
    lo[i] = make_uint2(a.lo, b.lo);
  }
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, shared, K-major).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// The A fragments of a consumer thread's two rows of an f32 q tile (row
// points at its row g, pitch HD; rows g and g + 8), split: k-step kk covers
// dims 16 kk .. 16 kk + 15, in mma.sync's A layout.
template <int HD>
__device__ __forceinline__ void q_frags(const float* row, int c, uint32_t (&qh)[HD / 16][4],
                                        uint32_t (&ql)[HD / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const float* r0 = row + 16 * kk + 2 * c;
    const float* r1 = r0 + 8 * HD;
    const Frag<float> f[4] = {frag(r0), frag(r1), frag(r0 + 8), frag(r1 + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qh[kk][i] = f[i].hi;
      ql[kk][i] = f[i].lo;
    }
  }
}

// s (64 x 128) = q k^T in split products: q split in registers, k's hi
// tile at dkh and lo tile at dkl (K-major); lo.hi + hi.lo + hi.hi each
// k-step.
template <int HD>
__device__ __forceinline__ void split_scores(float (&sc)[64], const uint32_t (&qh)[HD / 16][4],
                                             const uint32_t (&ql)[HD / 16][4], uint64_t dkh, uint64_t dkl) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_m64n128k16_rs(sc, ql[kk], dkh + 2 * kk);
    wgmma_m64n128k16_rs(sc, qh[kk], dkl + 2 * kk);
    wgmma_m64n128k16_rs(sc, qh[kk], dkh + 2 * kk);
  }
}

// o += p v with p split in registers (hi ph, lo pl) and v's hi tile at dvh,
// lo tile at dvl (MN-major): lo.hi + hi.lo + hi.hi.
template <int HD>
__device__ __forceinline__ void split_pv(float (&o)[HD / 2], const uint32_t (&ph)[8][4], const uint32_t (&pl)[8][4],
                                         uint64_t dvh, uint64_t dvl) {
  wgmma_pv<HD>(o, pl, dvh);
  wgmma_pv<HD>(o, ph, dvl);
  wgmma_pv<HD>(o, ph, dvh);
}

// p (the f32 scores after the softmax step) as the hi and lo A fragments of
// the 8 k-steps of p v, in pack_p's layout.
__device__ __forceinline__ void split_p(const float (&sc)[64], uint32_t (&ph)[8][4], uint32_t (&pl)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Frag<float> f = split_pair(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      ph[kk][i] = f.hi;
      pl[kk][i] = f.lo;
    }
}

// The bf16 kernel's walk and pipeline: q in f32 through q_map over qkv, k
// and v as hi / lo pairs through kv_map over their planes (2 B images of
// (N, 2D) bf16 rows, k of head h at column h HD, v at D + h HD).  out is
// (B, N, D) f32, or with PLANES the (2, B N, D) bf16 planes of o.
template <int HD, bool PLANES>
__global__ void __launch_bounds__(kThreads, 1)
clip_flash_f32_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap kv_map,
                    void* __restrict__ out, int N, int H, int B, float sl2) {
  using T = Tile<HD>;
  using F = TileF32<HD>;
  constexpr int S = F::kF32Stages, QB = kF32QBufs;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base;                         // q tile i at + i * kQBytes
  const uint32_t sk = base + QB * F::kQBytes;       // stage s: k pair at + 2 s kPair, v pair after it
  const uint32_t full_q = base + F::kBarOffset;     // + 8 i
  const uint32_t empty_q = full_q + 8 * QB;         // + 8 i, released by the 8 consumer warps
  const uint32_t full_k = empty_q + 8 * QB;         // + 8 s
  const uint32_t full_v = full_k + 8 * S;
  const uint32_t empty = full_v + 8 * S;            // released by the 8 consumer warps
  auto k_pair = [&](int s) { return sk + 2 * s * F::kPair; };
  auto v_pair = [&](int s) { return sk + (2 * s + 1) * F::kPair; };

  const int D = H * HD;
  const int tiles = (N + kKeys - 1) / kKeys;
  const int qtiles = (N + kRowsQ - 1) / kRowsQ;
  const int items = qtiles * H * B;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(full_q + 8 * i, 1);
      mbar_init(empty_q + 8 * i, 8);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // column c0 of image b: the hi tile from plane image b, the lo tile
      // from plane image B + b, both completing on bar
      auto load_pair = [&](uint32_t dst, uint32_t bar, int c0, int row, int b) {
        mbar_expect_tx(bar, F::kPair);
        tma_load(dst, &kv_map, bar, c0, row, b);
        tma_load(dst + T::kBytes, &kv_map, bar, c0, row, B + b);
      };
      int kv = 0;  // k/v tiles loaded so far: the ring position
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int qt = w % qtiles, h = (w / qtiles) % H, b = w / (qtiles * H);
        const int qb = i % QB;
        if (i >= QB) mbar_wait(empty_q + 8 * qb, ((i / QB) - 1) & 1);
        mbar_expect_tx(full_q + 8 * qb, F::kQBytes);
        tma_load(sq + qb * F::kQBytes, &q_map, full_q + 8 * qb, h * HD, qt * kRowsQ, b);
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int s = kv % S;
          if (kv >= S) mbar_wait(empty + 8 * s, ((kv / S) - 1) & 1);
          load_pair(k_pair(s), full_k + 8 * s, h * HD, j * kKeys, b);
          load_pair(v_pair(s), full_v + 8 * s, D + h * HD, j * kKeys, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cg = group - 1;  // query rows 64 cg .. of each q tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    auto parity = [](int kv) { return (uint32_t)(kv / S) & 1; };
    // the hi and lo descriptors of a pair
    auto dh = [&](uint32_t pair) { return desc<HD>(pair); };
    auto dl = [&](uint32_t pair) { return desc<HD>(pair + T::kBytes); };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int kv = 0;  // the ring position of this item's first k/v tile
    for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i, kv += tiles) {
      const int qt = w % qtiles, h = (w / qtiles) % H, b = w / (qtiles * H);
      const int qb = i % QB;
      float o[HD / 2];
      zero(o);
      Softmax sm;
      float sc[64];
      uint32_t ph[8][4], pl[8][4];
      uint32_t qh[HD / 16][4], ql[HD / 16][4];

      // this thread's q rows split into registers, the q tile released
      mbar_wait(full_q + 8 * qb, (i / QB) & 1);
      q_frags<HD>(reinterpret_cast<const float*>(smem_raw + (sq + qb * F::kQBytes - raw)) +
                      (cg * 64 + warp * 16 + g) * HD,
                  c, qh, ql);
      release(empty_q + 8 * qb);

      // s_0 = q k_0^T and its softmax
      zero(sc);
      mbar_wait(full_k + 8 * (kv % S), parity(kv));
      fence_regs(sc);
      wgmma_fence();
      split_scores<HD>(sc, qh, ql, dh(k_pair(kv % S)), dl(k_pair(kv % S)));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      sm.tile(sc, 0, N, sl2);
      split_p(sc, ph, pl);
      for (int j = 1; j < tiles; ++j) {
        // s_j = q k_j^T and o += p_{j-1} v_{j-1}, then the softmax of tile j
        const int s = (kv + j) % S, sp = (kv + j - 1) % S;
        zero(sc);
        mbar_wait(full_k + 8 * s, parity(kv + j));
        mbar_wait(full_v + 8 * sp, parity(kv + j - 1));
        fence_regs(sc);
        fence_regs(o);
        wgmma_fence();
        split_scores<HD>(sc, qh, ql, dh(k_pair(s)), dl(k_pair(s)));
        split_pv<HD>(o, ph, pl, dh(v_pair(sp)), dl(v_pair(sp)));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(o);
        release(empty + 8 * sp);  // done with tile j-1
        sm.tile(sc, j * kKeys, N, sl2);
        sm.rescale(o);
        split_p(sc, ph, pl);
      }
      // o += p_last v_last
      const int sl = (kv + tiles - 1) % S;
      mbar_wait(full_v + 8 * sl, parity(kv + tiles - 1));
      fence_regs(o);
      wgmma_fence();
      split_pv<HD>(o, ph, pl, dh(v_pair(sl)), dl(v_pair(sl)));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      release(empty + 8 * sl);

      float l0 = sm.l0, l1 = sm.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int r0 = qt * kRowsQ + cg * 64 + warp * 16 + g, r1 = r0 + 8;
      const long at0 = ((long)b * N + r0) * D + h * HD + 2 * c, at1 = at0 + 8L * D;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t) {
        const float x0 = __fmul_rn(o[4 * t + 0], inv0), y0 = __fmul_rn(o[4 * t + 1], inv0);
        const float x1 = __fmul_rn(o[4 * t + 2], inv1), y1 = __fmul_rn(o[4 * t + 3], inv1);
        if constexpr (PLANES) {
          bf16* hi = static_cast<bf16*>(out);
          bf16* lo = hi + (long)B * N * D;
          if (r0 < N) {
            const Frag<float> f = split_pair(x0, y0);
            *reinterpret_cast<uint32_t*>(hi + at0 + 8 * t) = f.hi;
            *reinterpret_cast<uint32_t*>(lo + at0 + 8 * t) = f.lo;
          }
          if (r1 < N) {
            const Frag<float> f = split_pair(x1, y1);
            *reinterpret_cast<uint32_t*>(hi + at1 + 8 * t) = f.hi;
            *reinterpret_cast<uint32_t*>(lo + at1 + 8 * t) = f.lo;
          }
        } else {
          float* of = static_cast<float*>(out);
          if (r0 < N) *reinterpret_cast<float2*>(of + at0 + 8 * t) = make_float2(x0, y0);
          if (r1 < N) *reinterpret_cast<float2*>(of + at1 + 8 * t) = make_float2(x1, y1);
        }
      }
    }
  }
}

// One call of the f32 kind: qkv (B, N, 3D) f32, kv2 the (2, B, N, 2D) bf16
// scratch of k's and v's split, out (B, N, D) f32 or (PLANES) o's (2, B N,
// D) bf16 planes; every base 16-byte aligned.  Two launches: the split,
// then the attention.  Each instance keeps its own opt-in flag (the
// unnamed namespace).
template <int HD, bool PLANES>
int run_f32(const void* qkv, void* kv2, void* out, int B, int N, int H, float scale, cudaStream_t stream) {
  using F = TileF32<HD>;
  const int D = H * HD;  // a multiple of 16
  const long n4 = (long)B * N * D / 2;
  int sms = 0;
  cudaError_t e = ::gg::sm90::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (n4 + 255) / 256;
  split_kv<<<(int)(blocks < 8L * sms ? blocks : 8L * sms), 256, 0, stream>>>(
      static_cast<const float4*>(qkv), static_cast<uint2*>(kv2), static_cast<uint2*>(kv2) + n4, n4, D / 4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // q: qkv's (N, 3D) f32 rows of B images in unswizzled boxes of (HD,
  // kRowsQ rows); k and v: both planes as 2B images of (N, 2D) bf16 rows in
  // boxes of (HD, kKeys rows), swizzled as the bf16 kernel's qkv
  CUtensorMap maps[2];
  e = ::gg::sm90::encode_3d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, qkv, 3L * D, N, B, HD, kRowsQ,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = ::gg::sm90::encode_3d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kv2, 2L * D, N, 2L * B, HD, kKeys,
                              Tile<HD>::kSwizzle);
  if (e != cudaSuccess) return (int)e;
  static bool opted_in = false;  // one per instance
  if (!opted_in) {
    e = cudaFuncSetAttribute(clip_flash_f32_sm90<HD, PLANES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const long items = (long)((N + kRowsQ - 1) / kRowsQ) * H * B;
  const int grid = (int)(items < sms ? items : sms);
  clip_flash_f32_sm90<HD, PLANES><<<grid, kThreads, F::kSmem, stream>>>(maps[0], maps[1], out, N, H, B,
                                                                        scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace clip
}  // namespace gg
