// The Hopper (sm_90a) GEMM core with A streamed along K, in four kinds:
//
//   kBf16F32   c[M, Nout] = a @ bt^T, bf16 operands, the f32 sum       (K13 bf16)
//   kS8S32     c[M, Nout] = a @ bt^T, int8 operands, the int32 sum, exact (K13 int8)
//   kBf16Bf16  c[M, Nout] = bf16(a @ bt^T), bf16 rounded once from the f32 sum
//              (K11's out-projection, as clip_attention._flash_proj_plain)
//   kSplitF32  c[M, Nout] = a @ bt^T of f32 operands handed over as their
//              bf16 (hi, lo) planes, the f32 sum of lo.hi + hi.lo + hi.hi
//              (K11's f32 out-projection)
//
// with a (M, K) and bt (Nout, K) both K-major (bt is PyTorch's (out, in)
// weight, or b transposed), c (M, Nout) row-major; kSplitF32's a and bt
// are (2, M, K) and (2, Nout, K), hi = bf16(x) then lo = bf16(x - hi).
// K13's bf16 and int8 entries (tiled_gemm.cu) run the first two; K11's
// bf16 entry (clip_flash_proj.cu) runs K6's attention into a scratch and
// then the third on it, K11's f32 entry K6's f32 kind into o's planes and
// then the fourth on them.
//
// What bounds it on the H100: 2 M K Nout operations against (M + Nout) K
// input bytes and M Nout output bytes.  K11's projection at CLIP-L bucket
// 16 (M = 36,928, K = Nout = 1024): 7.7e10 flop, 0.078 ms at the bf16
// peak, against 154 MB (0.046 ms).  K13 at (4096, 4096, 4096): 0.069 ms of
// int8 products (0.139 in bf16) against 98 MB (0.029 ms); at its MLP
// shapes (131072, 384, 1536) the int32 / f32 write of 805 MB is the bound.
// The LayerNorm + GEMM core (ln_gemm_sm90.cuh) keeps a whole 128 x K A
// tile in shared memory (K up to 576); here K is 1024 to 4096, so A comes
// through the ring beside B, box by box.
//
// The design:
//   * Persistent blocks of 384 threads, one an SM, in clusters of two
//     (kCluster) along M, walk the cluster tiles: two 128-row tiles of one
//     BN-column tile (BN = 256 where Nout allows it, else 128), the column
//     tile fastest, so the clusters in flight share a few row tiles of A
//     and all of bt in L2.
//   * A loader warpgroup gives its registers to the consumers (setmaxnreg)
//     and one of its threads keeps a ring of S stages full by TMA: each
//     stage one 128-byte k-box of the tile's 128 rows of A and of its BN
//     rows of bt (64 bf16 or 128 int8 values a row; the 128-byte swizzle,
//     the layout wgmma reads K-major), with a full and an empty mbarrier.
//     The two CTAs of a cluster need the same bt box: each loads half of
//     its rows and multicasts them to both, so a stage moves 32 KB instead
//     of 48 from L2 at BN = 256; a stage's empty barrier counts the
//     consumer warps of both CTAs, and each loader waits at its end until
//     both have released every stage, so no CTA exits while the other may
//     still arrive on its barriers.  A box past K (a K that is a multiple
//     of 64 bytes only) and rows past M or Nout come back as zeros, which
//     add nothing.
//   * Two consumer warpgroups issue the products on the stage as it
//     arrives: each takes 64 rows of the tile against all BN columns,
//     wgmma.m64n{BN}k16 (bf16) or .m64n{BN}k32.s32.s8.s8 (int8), four
//     k-steps a box, A and B from shared memory; a box's products are
//     committed as one group and the stage before it is released once they
//     are done, so one box of products is in flight while the next arrives.
//   * The epilogue leaves through shared memory: each group writes its
//     accumulators into two staging boxes of 64 rows x 128 bytes (128-byte
//     swizzle: conflict-free stores) and one thread stores each by TMA
//     (rows past M are dropped), as ln_gemm_sm90.cuh's epilogue does.
// scripts/gemm_sm90_variants.py patches a copy of this header to time the
// alternatives (no cluster, 128-column tiles, fewer stages, the groups
// splitting the columns) and the ablations; PERF.md has the readings.
// Every output element is one thread's sum over the k-boxes in order, in
// an order fixed by (M, K, Nout) and the kind's operand type, so two calls
// are bitwise the same on any card, and a row's result does not depend on
// the other rows: K13's bf16 kind rounded to bf16 equals the bf16 kind.
//
// kSplitF32 (K11's f32 entry) is the same pipeline with each operand in
// two planes: a stage holds A's hi and lo boxes and bt's hi and lo boxes
// (96 KB at BN = 256, so make_plan finds 2 stages beside the staging
// boxes, 3 at BN = 128), the loader reads each plane's box at plane
// coordinate 0 or 1 of the same tensor maps (bt's halves multicast as
// before), and each k-step is three wgmma into the f32 accumulator:
// lo.hi, hi.lo, hi.hi (the split products of the attention cores' f32
// kinds, about 2^-17 of error a product).  The f32 output leaves as
// kBf16F32's does.
//
// Everything here has internal linkage (the unnamed namespace below).
#pragma once

#include "sm90.cuh"

namespace gg {
namespace gemm90 {
namespace {

using namespace sm90;

// The kinds (the kernel's KIND).
constexpr int kBf16F32 = 0;
constexpr int kS8S32 = 1;
constexpr int kBf16Bf16 = 2;
constexpr int kSplitF32 = 3;

template <int KIND>
struct Kind;
template <>
struct Kind<kBf16F32> {
  using Acc = float;
  static constexpr int kIn = 2, kOut = 4, kPlanes = 1;
  static constexpr CUtensorMapDataType kInType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType kOutType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Kind<kS8S32> {
  using Acc = int;
  static constexpr int kIn = 1, kOut = 4, kPlanes = 1;
  static constexpr CUtensorMapDataType kInType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType kOutType = CU_TENSOR_MAP_DATA_TYPE_INT32;
};
template <>
struct Kind<kBf16Bf16> {
  using Acc = float;
  static constexpr int kIn = 2, kOut = 2, kPlanes = 1;
  static constexpr CUtensorMapDataType kInType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType kOutType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
// kPlanes: each operand as its bf16 hi and lo planes
template <>
struct Kind<kSplitF32> {
  using Acc = float;
  static constexpr int kIn = 2, kOut = 4, kPlanes = 2;
  static constexpr CUtensorMapDataType kInType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType kOutType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

constexpr int kRows = 128;                 // rows of an output tile
constexpr int kBoxBytes = 128;             // bytes of a row's k-box (the swizzle span)
constexpr int kBoxA = kRows * kBoxBytes;   // bytes of A's box of a stage
constexpr int kOutRows = 64;               // rows of a staging box
constexpr int kOutBox = kOutRows * 128;    // bytes of a staging box: 64 rows of 128 bytes
constexpr int kOutBufs = 2;                // staging boxes of a consumer group
constexpr int kStaging = 2 * kOutBufs * kOutBox;
constexpr int kMaxStages = 8;
constexpr int kConsumers = 256;             // two consumer warpgroups,
constexpr int kThreads = kConsumers + 128;  // then the loader warpgroup
// registers a thread after setmaxnreg: the launch's 168 x 384, the
// loaders' given to the consumers (40 x 128 + 232 x 256), each of which
// holds a 64 x 256 accumulator (128 registers)
constexpr int kLoaderRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemMax = 232448;  // what a block may opt in to (227 KB)
constexpr int kCluster = 2;       // CTAs of a cluster along M, which share each bt box

// The work of one call and its shared memory, from (M, K, Nout), the
// operand's bytes an element and its planes (a stage holds `planes` times
// stage_bytes(): each plane's A box, then each plane's bt box).
struct Plan {
  int M, K, Nout;
  int KB;      // 128-byte k-boxes of a row, the last one zero-filled past K
  int BN;      // columns of an output tile (128 or 256)
  int S;       // stages of the ring
  int mtiles;  // 128-row tiles
  int ntiles;  // BN-column tiles
  int tiles;   // cluster tiles: kCluster row tiles of one column tile

  __host__ __device__ int stage_bytes() const { return kBoxA + BN * kBoxBytes; }
  int smem_bytes(int planes = 1) const { return 1024 + S * planes * stage_bytes() + kStaging + 16 * S; }
};

// M >= 1, K a multiple of 64 bytes, Nout a multiple of 128 (every kind's
// output rows then hold whole staging boxes); as many stages as fit, at
// most kMaxStages: 4 at BN = 256, 6 at 128 (two planes: 2 and 3).
cudaError_t make_plan(Plan* p, int M, int K, int Nout, int in_bytes, int planes = 1) {
  if (M < 1 || K < 1 || (long)K * in_bytes % 64 || Nout < 128 || Nout % 128)
    return cudaErrorInvalidValue;
  p->M = M;
  p->K = K;
  p->Nout = Nout;
  p->KB = (K * in_bytes + kBoxBytes - 1) / kBoxBytes;
  p->BN = Nout % 256 == 0 ? 256 : 128;
  p->mtiles = (M + kRows - 1) / kRows;
  p->ntiles = (Nout + p->BN - 1) / p->BN;
  if ((long)p->mtiles * p->ntiles > (1L << 30)) return cudaErrorInvalidValue;
  p->tiles = (p->mtiles + kCluster - 1) / kCluster * p->ntiles;
  const int s = (kSmemMax - 1024 - kStaging - 16 * kMaxStages) / (planes * p->stage_bytes());
  p->S = s < kMaxStages ? s : kMaxStages;
  return p->S < 2 ? cudaErrorInvalidValue : cudaSuccess;
}

// The shared memory of a block: the S stages (A's box, then bt's; with two
// planes A's hi and lo boxes, then bt's) at the 1024-aligned base, the
// staging boxes (group c's box i at kOutBufs c + i), then the mbarriers:
// each stage's full (the loader's) and empty (the 8 consumer warps).
struct Smem {
  uint32_t ring, out0, bars;
  int S, stage, planes;
  __device__ Smem(const Plan& p, uint32_t base, int planes_ = 1)
      : ring(base), S(p.S), stage(planes_ * p.stage_bytes()), planes(planes_) {
    out0 = ring + S * stage;
    bars = out0 + kStaging;
  }
  __device__ uint32_t a(int s) const { return ring + s * stage; }
  __device__ uint32_t b(int s) const { return ring + s * stage + planes * kBoxA; }
  __device__ uint32_t out(int c, int i) const { return out0 + (kOutBufs * c + i) * kOutBox; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (S + s); }
};

// d (64 x NW) += A (64 x one k-step) . B (one k-step x NW), both from
// shared memory, K-major: 16 bf16 or 32 int8 values a k-step.
template <int NW>
__device__ __forceinline__ void mma(float (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 256) wgmma_m64n256k16_ss(d, da, db);
  else wgmma_m64n128k16_ss(d, da, db);
}
template <int NW>
__device__ __forceinline__ void mma(int (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 256) wgmma_m64n256k32_s8_ss(d, da, db);
  else wgmma_m64n128k32_s8_ss(d, da, db);
}

// The four k-steps of stage `slot`: the group's 64 rows of A (a_off into
// the A box) against the tile's NW columns of B.  A k-step moves a K-major
// start by 32 bytes (+2 in the descriptor).  With two planes each k-step
// is lo.hi + hi.lo + hi.hi.
template <int KIND, int NW, class Acc>
__device__ __forceinline__ void stage_products(Acc (&d)[NW / 2], const Smem& sm, int slot, uint32_t a_off) {
  const uint64_t da = desc<64>(sm.a(slot) + a_off), db = desc<64>(sm.b(slot));
  wgmma_fence();
  if constexpr (Kind<KIND>::kPlanes == 2) {
    const uint64_t dal = desc<64>(sm.a(slot) + kBoxA + a_off), dbl = desc<64>(sm.b(slot) + NW * kBoxBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma<NW>(d, dal + 2 * kk, db + 2 * kk);
      mma<NW>(d, da + 2 * kk, dbl + 2 * kk);
      mma<NW>(d, da + 2 * kk, db + 2 * kk);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<NW>(d, da + 2 * kk, db + 2 * kk);
  }
  wgmma_commit();
}

// Two accumulator values as the 4 or 8 bytes of one staging store.
__device__ __forceinline__ void store_pair(uint32_t addr, float x, float y, bool to_bf16) {
  if (to_bf16)
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack_bf16(x, y)) : "memory");
  else
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(__float_as_uint(x)),
                 "r"(__float_as_uint(y))
                 : "memory");
}
__device__ __forceinline__ void store_pair(uint32_t addr, int x, int y, bool) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(x), "r"(y) : "memory");
}

// Group c's 64 x NW accumulators out through its two staging boxes, two
// boxes at a time: the leader waits until the group's earlier stores have
// read them, the group writes both (row 16 warp + g and + 8, columns 8 t +
// 2 cc of each 8-column block, swizzled over 128 bytes), then the leader
// stores each by TMA at (col0 + its columns, row0).
template <int KIND, int NW>
__device__ __forceinline__ void epilogue(const typename Kind<KIND>::Acc (&d)[NW / 2], const Smem& sm,
                                         const CUtensorMap* c_map, int row0, int col0, int c, int warp,
                                         int g, int cc) {
  using K = Kind<KIND>;
  constexpr int kCols = 128 / K::kOut;  // columns of a staging box
  constexpr int kBoxes = NW / kCols;
  static_assert(kBoxes % kOutBufs == 0, "whole rounds of staging boxes");
  const bool leader = (threadIdx.x & 127) == 0;
  const int r = 16 * warp + g;
#pragma unroll
  for (int q0 = 0; q0 < kBoxes; q0 += kOutBufs) {
    store_wait_read<0>(leader);
    group_sync(c);
#pragma unroll
    for (int i = 0; i < kOutBufs; ++i) {
      const uint32_t buf = sm.out(c, i);
#pragma unroll
      for (int t = 0; t < kCols / 8; ++t) {
        const int j = (q0 + i) * (kCols / 8) + t;  // the 8-column block of the accumulator
        const int byte = (8 * t + 2 * cc) * K::kOut;
        store_pair(buf + swizzle128(r, byte), d[4 * j], d[4 * j + 1], K::kOut == 2);
        store_pair(buf + swizzle128(r + 8, byte), d[4 * j + 2], d[4 * j + 3], K::kOut == 2);
      }
    }
    fence_proxy_async();
    group_sync(c);
#pragma unroll
    for (int i = 0; i < kOutBufs; ++i)
      store_tile_tma(leader, c_map, sm.out(c, i), col0 + (q0 + i) * kCols, row0);
  }
}

template <int KIND, int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
          const __grid_constant__ CUtensorMap c_map, const Plan p) {
  using Acc = typename Kind<KIND>::Acc;
  constexpr int kBoxElems = kBoxBytes / Kind<KIND>::kIn;
  constexpr int kPlanes = Kind<KIND>::kPlanes;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(p, (smem_u32(smem_raw) + 1023) & ~1023u, kPlanes);
  const int S = p.S, KB = p.KB;

  // the CTA's rank in its cluster (its row tile of each cluster tile), the
  // cluster and the clusters of the grid
  const int rank = (int)cluster_ctarank();
  const int cluster = (int)cluster_id_x();
  const int clusters = (int)cluster_count_x();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8 * kCluster);  // the consumer warps of every CTA
    }
    mbar_init_fence();
  }
  cluster_sync();  // every CTA's barriers are ready before a multicast or remote arrival

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    if (threadIdx.x == kConsumers) {  // one thread keeps the ring full
      constexpr int kHalfB = BN / kCluster;  // rows of bt this CTA loads for the cluster
      RingPos pos;
      int loads = 0;
      for (int t = cluster; t < p.tiles; t += clusters) {
        const int mc = t / p.ntiles, n = t - mc * p.ntiles, m = mc * kCluster + rank;
        for (int b = 0; b < KB; ++b, ++loads) {
          // the slot is free in every CTA: its empty barrier counts them all
          if (loads >= S) mbar_wait(sm.empty(pos.slot), pos.phase ^ 1);
          mbar_expect_tx(sm.full(pos.slot), sm.stage);
          tma_load(sm.a(pos.slot), &a_map, sm.full(pos.slot), b * kBoxElems, m * kRows, 0);
          tma_load_multicast(sm.b(pos.slot) + rank * kHalfB * kBoxBytes, &b_map, sm.full(pos.slot),
                             b * kBoxElems, n * BN + rank * kHalfB, 0, (1 << kCluster) - 1);
          if constexpr (kPlanes == 2) {  // the lo planes, at plane coordinate 1
            tma_load(sm.a(pos.slot) + kBoxA, &a_map, sm.full(pos.slot), b * kBoxElems, m * kRows, 1);
            tma_load_multicast(sm.b(pos.slot) + (BN + rank * kHalfB) * kBoxBytes, &b_map, sm.full(pos.slot),
                               b * kBoxElems, n * BN + rank * kHalfB, 1, (1 << kCluster) - 1);
          }
          pos.next(S);
        }
      }
      // the last uses of every slot released by every CTA's consumers: no
      // CTA's consumer arrives on this CTA's barriers after it exits
      for (int i = 0; i < S; ++i, ++loads) {
        if (loads >= S) mbar_wait(sm.empty(pos.slot), pos.phase ^ 1);
        pos.next(S);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, cc = lane & 3;
  const uint32_t a_off = c * 64 * kBoxBytes;  // the group's 64 rows of a stage's A box
  RingPos ring;  // the stage the group releases next
  // the warp's release of a stage: on the empty barrier of each CTA of the
  // cluster, whose loader's multicast refills it
  const auto release_stage = [&](uint32_t bar) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r) arrive_cluster(bar, r, r);
  };
  for (int t = cluster; t < p.tiles; t += clusters) {
    const int mc = t / p.ntiles, n = t - mc * p.ntiles, m = mc * kCluster + rank;
    Acc d[BN / 2];
    zero(d);
    fence_regs(d);
    // box 0, then each later box with the one before it released once its
    // products are done: one box of products in flight while the next lands
    RingPos at = ring;
    wait_phase(sm.full(at.slot), at.phase);
    stage_products<KIND, BN>(d, sm, at.slot, a_off);
    at.next(S);
    for (int b = 1; b < KB; ++b) {
      wait_phase(sm.full(at.slot), at.phase);
      stage_products<KIND, BN>(d, sm, at.slot, a_off);
      at.next(S);
      wgmma_wait<1>();
      release_stage(sm.empty(ring.slot));
      ring.next(S);
    }
    wgmma_wait<0>();
    fence_regs(d);
    release_stage(sm.empty(ring.slot));
    ring.next(S);
    epilogue<KIND, BN>(d, sm, &c_map, m * kRows + 64 * c, n * BN, c, warp, g, cc);
  }
  // the group's output stores have read their staging boxes before the block exits
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A launch of grid CTAs in clusters of kCluster along x, with the shared
// memory of the plan's operands in `planes` planes.
cudaLaunchConfig_t cluster_launch(int grid, const Plan& p, int planes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem_bytes(planes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The CTAs of a launch: one persistent block an SM, in clusters of
// kCluster (as many as the card holds at once, asked of it once an
// instance), at most kCluster a cluster tile.
template <int KIND, int BN>
cudaError_t grid_of(const Plan& p, int sms, int* grid) {
  static bool opted_in = false;  // one per instance, and this library's own
  static int max_clusters = 0;
  const auto kernel = gemm_sm90<KIND, BN>;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  if (!max_clusters) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_launch(sms / kCluster * kCluster, p, Kind<KIND>::kPlanes, 0, &attr);
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (max_clusters < 1) return cudaErrorInvalidConfiguration;
  }
  *grid = (p.tiles < max_clusters ? p.tiles : max_clusters) * kCluster;
  return cudaSuccess;
}

template <int KIND, int BN>
cudaError_t launch(const CUtensorMap (&maps)[3], const Plan& p, int sms, cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = grid_of<KIND, BN>(p, sms, &grid);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(grid, p, Kind<KIND>::kPlanes, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, gemm_sm90<KIND, BN>, maps[0], maps[1], maps[2], p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One call: a (M, K), bt (Nout, K) and c (M, Nout) contiguous with
// 16-byte aligned bases, in the kind's types (kSplitF32: a (2, M, K) and bt
// (2, Nout, K), each plane after the other); K a multiple of 64 bytes,
// Nout of 128.  Anything else returns cudaErrorInvalidValue.
template <int KIND>
cudaError_t run(const void* a, const void* bt, void* c, int M, int K, int Nout, cudaStream_t stream) {
  using T = Kind<KIND>;
  Plan p;
  cudaError_t e = make_plan(&p, M, K, Nout, T::kIn, T::kPlanes);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[3];
  constexpr int kBoxElems = kBoxBytes / T::kIn;
  e = encode_3d(&maps[0], T::kInType, T::kIn, a, K, M, T::kPlanes, kBoxElems, kRows,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = encode_3d(&maps[1], T::kInType, T::kIn, bt, K, Nout, T::kPlanes, kBoxElems, p.BN / kCluster,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = encode_3d(&maps[2], T::kOutType, T::kOut, c, Nout, M, 1, 128 / T::kOut, kOutRows,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  return p.BN == 256 ? launch<KIND, 256>(maps, p, sms, stream) : launch<KIND, 128>(maps, p, sms, stream);
}

}  // namespace
}  // namespace gemm90
}  // namespace gg
