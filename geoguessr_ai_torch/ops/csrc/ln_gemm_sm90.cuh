// The Hopper (sm_90a) LayerNorm + GEMM core, in bf16, in two kinds:
//
//   kQkvGemm   y[M, Nout] = bf16(bf16(LN(x) @ wt^T) + b),   LN(x) = bf16((x - mu) rstd gamma + beta)
//   kProjGemm  y[M, Nout] = bf16(x @ wt^T + b)
//
// with x (M, K) and y (M, Nout) bf16 rows, wt (Nout, K) bf16 (PyTorch's
// (out, in) layout: the K-major B operand of wgmma), gamma, beta (K) and b
// (Nout) f32.  kQkvGemm is the qkv GEMM's ROUND_FIRST epilogue (b already
// rounded to bf16 by the caller), kProjGemm the out-projection's ROUND_LAST
// one (the f32 b_proj on the f32 sum, rounded once), as common.cuh's
// ln_gemm_kernel<LN, ROUND_FIRST> computes them.  K2's bf16 entry (fb_s2.cu)
// runs the qkv kind; K1's (fused_block.cu) and K9's (fb4d.cu) run both.
//
// K9 reads its x and writes its out in the order of the raw (B, Hm, Wm, C)
// map, and its qkv GEMM and out-projection take them through a window map
// (MAP): a 5D tensor map over the map, dims (C, ws columns, Wm / ws, ws
// rows, B Hm / ws), whose box of 128 (or 64) rows is 128 / ws (64 / ws)
// rows of ws columns of one window.  The rows of such a box lie in shared
// memory as those of a 2D box, 128 bytes a row, so the 128-byte swizzle
// and the wgmma descriptors are the same.  With it the qkv GEMM reads x in
// window order and writes the (W, N, 3D) qkv the attention reads, and the
// out-projection reads the (W, N, D) attention output and writes out in
// map order: the window partition is done by the TMA unit.
//
// What bounds it on the H100 at stage 2 of a serving bucket of 16 (M =
// 65,536, K = 384, Nout = 1152): 5.8e10 flop (0.059 ms at the bf16 peak)
// against 201 MB of x, wt and y (0.060 ms at 3.35 TB/s).  At stage 1 (M =
// 262,144, K = 192) the qkv GEMM moves 403 MB (0.12 ms) for 5.8e10 flop and
// the out-projection 201 MB (0.060 ms) for 1.9e10: both bytes-bound.  The
// first design (64 x 64 tiles, mma.sync, synchronously staged k-steps)
// recomputed each row's statistics for every column tile and re-normalised
// each A tile on its way into shared memory.
//
// The design:
//   * Persistent blocks of 384 threads, one an SM, walk 128-row tiles of x.
//     A tile comes in by TMA (boxes of 64 columns x 128 rows, 128-byte
//     swizzle: the layout wgmma reads, K-major), into one of two buffers
//     where two fit beside a ring of four B boxes (K up to 320), so that
//     the next tile loads under this one's products.  In kQkvGemm the two
//     consumer warpgroups each take 64 of its rows, two threads a row:
//     each row's mean and rstd once, in two passes in f32 (mean, then the
//     mean of squared deviations, as the JAX kernels do), the normalised
//     row rounded to bf16 written back in place, in the same swizzled
//     layout.  kProjGemm hands the tile to wgmma as it came.
//   * The block then walks the Nout columns in tiles of 64, two at a time,
//     k-box by k-box: a box's two B tiles (64 k x 64 columns each) are
//     waited for and their products issued (wgmma.m64n64k16, A and B from
//     shared memory), and the previous box's slots are released once its
//     products are done, so the ring refills under the products.  The
//     waits loop inside their asm and the releases are predicated: nothing
//     branches between the first product and the last wait.
//   * Warp 8 loads the x tiles, warp 9 keeps the ring of B boxes full: the
//     weights are the same for every row tile and come from L2.  The
//     loader warpgroup gives its registers to the consumers (setmaxnreg).
//   * The epilogue goes into a staging tile in shared memory (128-byte
//     swizzle: conflict-free stores), and leaves by one TMA store for each
//     64 x 64 tile, which also drops the rows past M; with the k-box waits
//     this took the qkv kind from 0.270 to 0.181 ms at stage 2 of a serving
//     bucket of 16 on an H100 (700 W), against 4-byte stores straight from
//     the accumulators and whole-step waits.
// Every output element is one thread's sum in an order fixed by (M, K,
// Nout), so two calls are bitwise the same on any card, and a row's result
// does not depend on where the row lives (K9 equals K1 on the partitioned
// map bit for bit).
//
// Everything here has internal linkage (the unnamed namespace below).
#pragma once

#include "sm90.cuh"

namespace gg {
namespace lng90 {
namespace {

using namespace sm90;

constexpr int kRows = 128;                  // rows of x a block owns at a time
constexpr int kCols = 64;                   // columns of an output tile (a B box's rows)
constexpr int kBoxK = 64;                   // k of a box: 128 bytes of bf16
constexpr int kMaxKB = 9;                   // k-boxes of a row, at most (K up to 576)
constexpr int kConsumers = 256;             // two consumer warpgroups, 64 rows each,
constexpr int kThreads = kConsumers + 128;  // then the loader warpgroup
// registers a thread after setmaxnreg: the block's 168 x 384 at launch,
// the loaders' given to the consumers (56 x 128 + 224 x 256), whose step
// of two 64 x 64 accumulators over up to nine k-boxes spilled at 168
constexpr int kLoaderRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kBoxA = kRows * 128;          // bytes of an x box
constexpr int kBoxB = kCols * 128;          // bytes of a B box
constexpr int kMinSlots = 4;                // two k-boxes of both column tiles of a step
constexpr int kMaxSlots = 16;               // B boxes of the ring, at most
constexpr int kStage = 4 * kBoxB;           // each group's two 64 x 64 output tiles on their way out
constexpr int kSmemMax = 232448;            // what a block may opt in to (227 KB)

// The kinds (the kernel's KIND).
constexpr int kQkvGemm = 0;   // LayerNorm, then bf16(bf16(acc) + b)
constexpr int kProjGemm = 1;  // no LayerNorm, bf16(acc + b)

// The work of one call and its shared memory, from (M, K, Nout) and, for
// a MAP launch, the window side ws and the map's width Wm.
struct Plan {
  int M, K, Nout;
  int KB;     // 64-column boxes of a row (K / 64)
  int AB;     // x tile buffers (1 or 2)
  int S;      // B boxes of the ring
  int tiles;  // 128-row tiles of x
  int ncol;   // 64-column tiles of y
  int ws;     // the window map: the window's side (0: plain rows),
  int nww;    // windows across the map (Wm / ws)
  int N;      // and tokens a window (ws * ws)

  __host__ __device__ int barrier_bytes() const { return 8 * (2 * AB + 2 * S); }
  int smem_bytes() const { return 1024 + AB * KB * kBoxA + kStage + S * kBoxB + barrier_bytes(); }
};

// B boxes that fit beside AB x tiles of KB boxes, at most kMaxSlots.
int ring_slots(int KB, int AB) {
  const int s = (kSmemMax - 1024 - 8 * (2 * AB + 2 * kMaxSlots) - AB * KB * kBoxA - kStage) / kBoxB;
  return s < kMaxSlots ? s : kMaxSlots;
}

// K a multiple of 64 up to 576 (the kernel's instances), Nout of 64; two x
// buffers where they leave a ring of kMinSlots, else one.  A window map
// takes ws dividing 64 with ws * ws a multiple of 128 (a 128-row tile
// inside one window: ws 16, 32 or 64) and a map of whole windows.
cudaError_t make_plan(Plan* p, int M, int K, int Nout, int ws = 0, int Wm = 0) {
  if (M < 1 || K < kBoxK || K % kBoxK || K > kMaxKB * kBoxK || Nout < kCols || Nout % kCols)
    return cudaErrorInvalidValue;
  if (ws && (ws < 0 || 64 % ws || ws * ws % kRows || Wm < ws || Wm % ws || M % (ws * Wm)))
    return cudaErrorInvalidValue;
  p->M = M;
  p->K = K;
  p->Nout = Nout;
  p->KB = K / kBoxK;
  p->tiles = (M + kRows - 1) / kRows;
  p->ncol = Nout / kCols;
  p->ws = ws;
  p->nww = ws ? Wm / ws : 0;
  p->N = ws * ws;
  p->AB = 2;
  p->S = ring_slots(p->KB, 2);
  if (p->S < kMinSlots) {
    p->AB = 1;
    p->S = ring_slots(p->KB, 1);
  }
  return p->S < kMinSlots ? cudaErrorInvalidValue : cudaSuccess;
}

// The shared memory of a block: the AB x tiles of KB boxes at the
// 1024-aligned base, the four output staging tiles (group c's tile i at
// 2 c + i), the S B boxes, then the mbarriers: each x buffer's full and
// empty (the 8 consumer warps), and each B slot's full and empty (the 8
// consumer warps).
struct Smem {
  uint32_t a, stage, slots, bars;
  int AB, KB, S;
  __device__ Smem(const Plan& p, uint32_t base) : a(base), AB(p.AB), KB(p.KB), S(p.S) {
    stage = a + AB * KB * kBoxA;
    slots = stage + kStage;
    bars = slots + S * kBoxB;
  }
  __device__ uint32_t out(int c, int i) const { return stage + (2 * c + i) * kBoxB; }
  __device__ uint32_t box_a(int buf, int b) const { return a + (buf * KB + b) * kBoxA; }
  __device__ uint32_t slot(int s) const { return slots + s * kBoxB; }
  __device__ uint32_t a_full(int buf) const { return bars + 8 * buf; }
  __device__ uint32_t a_empty(int buf) const { return bars + 8 * (AB + buf); }
  __device__ uint32_t full(int s) const { return bars + 16 * AB + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 16 * AB + 8 * S + 8 * s; }
};

// The window map's coordinates (after the column) of the box whose first
// row is window-ordered row r0: (0, window column, row in the window,
// window row over the images).
struct WinCoords {
  int c1, c2, c3, c4;
  __device__ WinCoords(const Plan& p, int r0) {
    const int w = r0 / p.N;
    c1 = 0;
    c2 = w % p.nww;
    c3 = (r0 - w * p.N) / p.ws;
    c4 = w / p.nww;
  }
};

// One TMA load of a box of the window map into dst, completing on bar.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            const WinCoords& w) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(w.c1), "r"(w.c2), "r"(w.c3),
      "r"(w.c4)
      : "memory");
}

// LayerNorm of group c's 64 rows of the x tile in place: two threads a
// row, each over half of its 16-byte chunks (box j / 8, 16-byte column
// j % 8, swizzled with the row), in three passes over shared memory: the
// sum, the squared deviations from the mean, the normalised chunks written
// back; the two halves meet by one shuffle after each of the first two.
// A thread's chains are long and independent of its neighbours' (a warp
// over one row at a time waits on a chain of shuffles for every row), and
// a warp's 32 chunks come from 16 rows, which the swizzle spreads over the
// banks.  It runs between the tile's arrival and its first product:
// scripts/ln_gemm_variants.py measures what it costs.
template <int KB>
__device__ __forceinline__ void layer_norm_group(uint8_t* tile, int c, const float* __restrict__ gamma,
                                                 const float* __restrict__ beta, float eps) {
  constexpr int kHalf = 4 * KB;  // chunks of half a row
  constexpr int K = kBoxK * KB;
  const int gt = threadIdx.x & 127;
  const int r = 64 * c + (gt >> 1);
  const int j0 = (gt & 1) * kHalf;
  uint8_t* row = tile + r * 128;
  const auto at = [&](int j) { return row + (j >> 3) * kBoxA + ((((j & 7) ^ r) & 7) << 4); };
  float sum = 0.f;
#pragma unroll 4
  for (int k = 0; k < kHalf; ++k) {
    const uint4 raw = *reinterpret_cast<const uint4*>(at(j0 + k));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = unpack_bf16(w[t]);
      sum += f.x + f.y;
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float mu = sum / K;
  float sq = 0.f;
#pragma unroll 4
  for (int k = 0; k < kHalf; ++k) {
    const uint4 raw = *reinterpret_cast<const uint4*>(at(j0 + k));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = unpack_bf16(w[t]);
      const float d0 = f.x - mu, d1 = f.y - mu;
      sq += d0 * d0;
      sq += d1 * d1;
    }
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  const float rs = rsqrtf(sq / K + eps);
#pragma unroll 4
  for (int k = 0; k < kHalf; ++k) {
    const int j = j0 + k;
    uint4* p = reinterpret_cast<uint4*>(at(j));
    const uint4 raw = *p;
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + 8 * j);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + 8 * j + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + 8 * j);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + 8 * j + 4);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = unpack_bf16(w[t]);
      o[t] = pack_bf16((f.x - mu) * rs * g[2 * t] + b[2 * t], (f.y - mu) * rs * g[2 * t + 1] + b[2 * t + 1]);
    }
    *p = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The same through the window map.
__device__ __forceinline__ void store_tile_tma_5d(bool leader, const CUtensorMap* map, uint32_t src,
                                                  int c0, const WinCoords& w) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"r"((int)leader),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(w.c1), "r"(w.c2), "r"(w.c3),
      "r"(w.c4)
      : "memory");
}

// A step's NT 64 x 64 accumulators of group c into its staging tiles
// (rows swizzled over 128 bytes, as the output map writes them), tile i
// into staging tile out ^ i: bf16(bf16(acc) + b) in kQkvGemm, bf16(acc +
// b) in kProjGemm; then one TMA store of each at (col0 + 64 i, row0),
// through the window map when OUT_MAP.  A staging tile is written once the
// store that read it before has read it (two stores back in the turns),
// and the group meets twice a step.
template <int NT, int KIND, bool OUT_MAP>
__device__ __forceinline__ void epilogue(const float (&d)[NT][32], const Smem& sm, int out,
                                         const CUtensorMap* y_map, const Plan& p,
                                         const float* __restrict__ bvec, int col0, int row0, int c,
                                         int warp, int g, int cc) {
  const bool leader = (threadIdx.x & 127) == 0;
  store_wait_read<2 - NT>(leader);
  group_sync(c);
  const int r = 16 * warp + g;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const uint32_t buf = sm.out(c, out ^ i);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 b = *reinterpret_cast<const float2*>(bvec + col0 + 64 * i + 8 * t + 2 * cc);
      const int byte = (8 * t + 2 * cc) * 2;
      uint32_t v0, v1;
      if constexpr (KIND == kQkvGemm) {
        v0 = pack_bf16(round_bf16(d[i][4 * t]) + b.x, round_bf16(d[i][4 * t + 1]) + b.y);
        v1 = pack_bf16(round_bf16(d[i][4 * t + 2]) + b.x, round_bf16(d[i][4 * t + 3]) + b.y);
      } else {
        v0 = pack_bf16(d[i][4 * t] + b.x, d[i][4 * t + 1] + b.y);
        v1 = pack_bf16(d[i][4 * t + 2] + b.x, d[i][4 * t + 3] + b.y);
      }
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(buf + swizzle128(r, byte)), "r"(v0) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(buf + swizzle128(r + 8, byte)), "r"(v1) : "memory");
    }
  }
  fence_proxy_async();
  group_sync(c);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if constexpr (OUT_MAP)
      store_tile_tma_5d(leader, y_map, sm.out(c, out ^ i), col0 + 64 * i, WinCoords(p, row0));
    else
      store_tile_tma(leader, y_map, sm.out(c, out ^ i), col0 + 64 * i, row0);
  }
}

// One step of NT (1 or 2) column tiles from column tile ct, k-box by
// k-box: the box's NT B tiles waited for, their products issued, then the
// previous box's slots released once its products are done.  The waits
// loop inside their asm and nothing else branches between the first
// product and the last wait.  The output tiles take the group's two
// staging tiles in turns (`out`, flipped at each), so the one written is
// the one whose store came two stores before: a step of one tile (an odd
// column-tile count) leaves the turn where the next row tile picks it up.
// `da` is the descriptor of the group's 64 rows of box 0: box b's k-step kk
// is da plus (b kBoxA + 32 kk) / 16, an immediate (a descriptor per box
// and k-step, hoisted out of the steps, spilled at nine boxes).
template <int KB, int NT, int KIND, bool OUT_MAP>
__device__ __forceinline__ void gemm_step(const Smem& sm, RingPos& ring, int& out, uint64_t da,
                                          const CUtensorMap* y_map, const Plan& p,
                                          const float* __restrict__ bvec, int row0, int ct, int c,
                                          int warp, int g, int cc) {
  const int S = sm.S;
  float d[NT][32];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    zero(d[i]);
    fence_regs(d[i]);
  }
  RingPos at = ring;
#pragma unroll
  for (int b = 0; b < KB; ++b) {
    uint64_t bd[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      wait_phase(sm.full(at.slot), at.phase);
      bd[i] = desc<64>(sm.slot(at.slot));
      at.next(S);
    }
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(d[i], da + (b * kBoxA >> 4) + 2 * kk, bd[i] + 2 * kk);
    wgmma_commit();
    if (b > 0) {
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        arrive_nb(sm.empty(ring.slot));
        ring.next(S);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    fence_regs(d[i]);
    arrive_nb(sm.empty(ring.slot));
    ring.next(S);
  }
  epilogue<NT, KIND, OUT_MAP>(d, sm, out, y_map, p, bvec, ct * kCols, row0, c, warp, g, cc);
  out ^= NT & 1;
}

// KIND as above; MAP: the map-order side (the qkv GEMM's x, the
// out-projection's y) goes through the window map.
template <int KB, int KIND, bool MAP>
__global__ void __launch_bounds__(kThreads, 1)
ln_gemm_sm90(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
             const __grid_constant__ CUtensorMap y_map, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ bvec, const Plan p, float eps) {
  constexpr bool kInMap = MAP && KIND == kQkvGemm;
  constexpr bool kOutMap = MAP && KIND == kProjGemm;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const Smem sm(p, (raw + 1023) & ~1023u);
  uint8_t* tiles = smem_raw + (sm.a - raw);
  const int S = p.S, AB = p.AB;

  if (threadIdx.x == 0) {
    for (int i = 0; i < AB; ++i) {
      mbar_init(sm.a_full(i), 1);
      mbar_init(sm.a_empty(i), 8);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    const int warp = (threadIdx.x - kConsumers) / 32;
    if ((threadIdx.x & 31) != 0) return;
    if (warp == 0) {  // the x tiles, into the buffers in turns
      int n = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++n) {
        const int buf = n % AB, use = n / AB;
        if (use > 0) mbar_wait(sm.a_empty(buf), (use - 1) & 1);
        mbar_expect_tx(sm.a_full(buf), KB * kBoxA);
        for (int b = 0; b < KB; ++b) {
          if constexpr (kInMap)
            tma_load_5d(sm.box_a(buf, b), &x_map, sm.a_full(buf), b * kBoxK, WinCoords(p, t * kRows));
          else
            tma_load(sm.box_a(buf, b), &x_map, sm.a_full(buf), b * kBoxK, t * kRows, 0);
        }
      }
    } else if (warp == 1) {  // the ring of B boxes: k-box by k-box, both tiles of a step
      RingPos pos;
      bool wrapped = false;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
        for (int ct = 0; ct < p.ncol; ct += 2)
          for (int b = 0; b < KB; ++b)
            for (int i = 0; i < (ct + 1 < p.ncol ? 2 : 1); ++i) {
              if (wrapped) mbar_wait(sm.empty(pos.slot), pos.phase ^ 1);
              mbar_expect_tx(sm.full(pos.slot), kBoxB);
              tma_load(sm.slot(pos.slot), &w_map, sm.full(pos.slot), b * kBoxK, (ct + i) * kCols, 0);
              pos.next(S);
              wrapped = wrapped || pos.slot == 0;
            }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, cc = lane & 3;
  RingPos ring;
  int out = 0;  // the group's staging tile of its next output tile
  int n = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++n) {
    const int buf = n % AB;
    mbar_wait(sm.a_full(buf), (n / AB) & 1);
    if constexpr (KIND == kQkvGemm) {
      layer_norm_group<KB>(tiles + buf * KB * kBoxA, c, gamma, beta, eps);
      fence_proxy_async();
      group_sync(c);
    }
    const uint64_t da = desc<64>(sm.box_a(buf, 0) + c * (64 * 128));  // this group's 64 rows of box 0
    const int row0 = t * kRows + 64 * c;
    int ct = 0;
    for (; ct + 1 < p.ncol; ct += 2)
      gemm_step<KB, 2, KIND, kOutMap>(sm, ring, out, da, &y_map, p, bvec, row0, ct, c, warp, g, cc);
    if (ct < p.ncol)
      gemm_step<KB, 1, KIND, kOutMap>(sm, ring, out, da, &y_map, p, bvec, row0, ct, c, warp, g, cc);
    release(sm.a_empty(buf));
  }
  // the group's output stores have read their staging tiles before the block exits
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int KB, int KIND, bool MAP>
cudaError_t launch_kb(const CUtensorMap (&maps)[3], const float* gamma, const float* beta,
                      const float* b, const Plan& p, float eps, int sms, cudaStream_t stream) {
  static bool opted_in = false;  // one per instance, and this library's own
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_gemm_sm90<KB, KIND, MAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  ln_gemm_sm90<KB, KIND, MAP><<<grid, kThreads, p.smem_bytes(), stream>>>(maps[0], maps[1], maps[2],
                                                                         gamma, beta, b, p, eps);
  return cudaGetLastError();
}

// The window map over a (B, Hm, Wm, C) bf16 map of M = B Hm Wm rows, read
// or written in window order: dims (C, ws, Wm / ws, ws, B Hm / ws), boxes
// of 64 channels x box_rows rows (box_rows / ws rows of ws columns of one
// window), the 128-byte swizzle.
cudaError_t encode_window_map(CUtensorMap* map, const void* base, long C, int ws, long Wm, long M,
                              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)ws, (cuuint64_t)(Wm / ws), (cuuint64_t)ws,
                              (cuuint64_t)(M / (ws * Wm))};
  const cuuint64_t strides[4] = {(cuuint64_t)(C * 2), (cuuint64_t)(ws * C * 2), (cuuint64_t)(Wm * C * 2),
                                 (cuuint64_t)(ws * Wm * C * 2)};
  const cuuint32_t box[5] = {64, (cuuint32_t)ws, 1, (cuuint32_t)(box_rows / ws), 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// One call: x (M, K), wt (Nout, K) and y (M, Nout) contiguous bf16 with
// 16-byte aligned bases; gamma, beta (K) f32 (unread in kProjGemm), b
// (Nout) f32.  K a multiple of 64 up to 576, Nout a multiple of 64.  A MAP
// launch takes the window side ws and the map's width Wm: x (kQkvGemm) or
// y (kProjGemm) is the (B, Hm, Wm, C) map, the other side window-ordered
// rows.  Anything else returns cudaErrorInvalidValue.
template <int KIND, bool MAP>
cudaError_t run(const void* x, const float* gamma, const float* beta, const void* wt, const float* b,
                void* y, int M, int K, int Nout, float eps, cudaStream_t stream, int ws = 0, int Wm = 0) {
  static_assert(KIND == kQkvGemm || KIND == kProjGemm, "a kind of the core");
  if (MAP != (ws > 0)) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(&p, M, K, Nout, ws, Wm);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[3];
  constexpr CUtensorMapDataType kBf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  e = MAP && KIND == kQkvGemm
          ? encode_window_map(&maps[0], x, K, ws, Wm, M, kRows)
          : encode_3d(&maps[0], kBf, 2, x, K, M, 1, kBoxK, kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = encode_3d(&maps[1], kBf, 2, wt, K, Nout, 1, kBoxK, kCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = MAP && KIND == kProjGemm
            ? encode_window_map(&maps[2], y, Nout, ws, Wm, M, 64)
            : encode_3d(&maps[2], kBf, 2, y, Nout, M, 1, kCols, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  switch (p.KB) {
    case 1: return launch_kb<1, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 2: return launch_kb<2, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 3: return launch_kb<3, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 4: return launch_kb<4, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 5: return launch_kb<5, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 6: return launch_kb<6, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 7: return launch_kb<7, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    case 8: return launch_kb<8, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
    default: return launch_kb<9, KIND, MAP>(maps, gamma, beta, b, p, eps, sms, stream);
  }
}

}  // namespace
}  // namespace lng90
}  // namespace gg
