// The Hopper (sm_90a) LayerNorm + GEMM core, in bf16, in two kinds:
//
//   kQkvGemm   y[M, Nout] = bf16(bf16(LN(x) @ wt^T) + b),   LN(x) = bf16((x - mu) rstd gamma + beta)
//   kProjGemm  y[M, Nout] = bf16(x @ wt^T + b)
//
// with x (M, K) and y (M, Nout) bf16 rows, wt (Nout, K) bf16 (PyTorch's
// (out, in) layout: the K-major B operand of wgmma), gamma, beta (K) and b
// (Nout) f32.  kQkvGemm is the qkv GEMM's ROUND_FIRST epilogue (b already
// rounded to bf16 by the caller), kProjGemm the out-projection's ROUND_LAST
// one (the f32 b_proj on the f32 sum, rounded once), the roundings of the
// JAX kernels' qkv GEMM and out-projection.  K2's bf16 entry (fb_s2.cu)
// runs the qkv kind; K1's (fused_block.cu) and K9's (fb4d.cu) run both.
// An f32 kind of both (ln_gemm_f32_sm90, "The f32 kind" below) serves K1's,
// K2's and K9's f32 entries.
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
  template <class P>  // Plan or PlanF32
  __device__ WinCoords(const P& p, int r0) {
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

// The window map over a (B, Hm, Wm, C) map of M = B Hm Wm rows of `type`
// elements of `elem` bytes (bf16, or f32 in the f32 kind), read or written
// in window order: dims (C, ws, Wm / ws, ws, B Hm / ws), boxes of 128
// bytes of channels (64 bf16, 32 f32) x box_rows rows (box_rows / ws rows
// of ws columns of one window), the 128-byte swizzle.
cudaError_t encode_window_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                              long C, int ws, long Wm, long M, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)ws, (cuuint64_t)(Wm / ws), (cuuint64_t)ws,
                              (cuuint64_t)(M / (ws * Wm))};
  const cuuint64_t strides[4] = {(cuuint64_t)(C * elem), (cuuint64_t)(ws * C * elem),
                                 (cuuint64_t)(Wm * C * elem), (cuuint64_t)(ws * Wm * C * elem)};
  const cuuint32_t box[5] = {(cuuint32_t)(128 / elem), (cuuint32_t)ws, 1, (cuuint32_t)(box_rows / ws), 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(map, type, 5, const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
          ? encode_window_map(&maps[0], kBf, 2, x, K, ws, Wm, M, kRows)
          : encode_3d(&maps[0], kBf, 2, x, K, M, 1, kBoxK, kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = encode_3d(&maps[1], kBf, 2, wt, K, Nout, 1, kBoxK, kCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = MAP && KIND == kProjGemm
            ? encode_window_map(&maps[2], kBf, 2, y, Nout, ws, Wm, M, 64)
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

// ---------------------------------------------------------------------------
// The f32 kind (K2's and K9's f32 entries): x f32 rows, wt the f32 weight
// as the stacked bf16 pair (2, Nout, K), hi = bf16(w) and lo = bf16(w - hi)
// (the wrapper's mbconv._split_bf16, once a call), gamma, beta and b f32:
//
//   kQkvGemm   y = LN(x) @ wt^T + b,   LN(x) = (x - mu) rstd gamma + beta
//   kProjGemm  y = x @ wt^T + b
//
// with nothing rounded on the way: every product splits its operands into
// bf16 hi and lo and sums lo.hi + hi.lo + hi.hi in the f32 accumulator
// (three wgmma for one), LayerNorm's statistics are two passes in f32, and
// y is the f32 sum plus b.  kQkvGemm stores y as its bf16 hi and lo planes
// (2, M, Nout), hi = bf16(y), lo = bf16(y - hi): the operands the forward
// core's f32 kind loads by TMA into its ring as they are (splitting f32 k
// and v tiles there instead, once for every q-tile that reads them, cost
// K2's attention 0.79 of 2.26 ms on an H100).  kProjGemm stores y in f32.
//
// What changes beside the bf16 kind, and why:
//   * x lands by TMA in f32 boxes of 32 columns (128 bytes, the 128-byte
//     swizzle), two to a 64-column chunk of the tile.  Once a tile is in,
//     the 256 consumer threads (four a row) take each row's statistics and
//     rewrite each 64-column chunk of it in place as its bf16 hi box and
//     lo box (128 bytes a row each, in the swizzle wgmma reads: the bytes
//     of the chunk's first and second f32 box), so the products read A from
//     shared memory as in bf16.  kProjGemm splits its x the same way, with
//     no LayerNorm.
//   * An f32 tile is twice the bf16 tile's bytes, so a tile is 64 rows (a
//     128-row one is 196,608 bytes at K = 384), both consumer groups take
//     all of them and each one of a step's two column tiles; the ring is
//     loaded in the bf16 kind's order.  (At K9's K = 192, where a 128-row
//     tile fits beside one buffer, the 64-row tiles in two buffers ran both
//     GEMMs 8-9 % faster on an H100.)
//   * A ring slot holds a weight box's hi and lo (16 KB).
//   * kQkvGemm's planes leave as the bf16 kind's output does: each group
//     writes a tile's hi and its lo into its two 64 x 64 staging tiles (the
//     128-byte swizzle) and issues their TMA stores; where two a group
//     leave no ring of kMinSlots (K = 576) it has one, which the lo plane
//     takes once the hi plane's store has read it.  4-byte stores straight
//     from the accumulators ran K9's qkv GEMM 48 % slower on an H100.
//     kProjGemm's f32 sum leaves as float2 stores (full 32-byte sectors),
//     K9's at each row's place in the map.
// Every output element is one thread's sum in an order fixed by (K, Nout),
// so two calls give the same bits and a row's result does not depend on
// where it lives in the map.
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;         // rows of an f32 x tile
constexpr int kF32BoxK = 32;         // k of an f32 box: 128 bytes
constexpr int kF32Slot = 2 * kBoxB;  // a ring slot: a B box's hi and lo
constexpr int kF32Tpr = kConsumers / kF32Rows;  // consumer threads a row of the tile

struct PlanF32 {
  int M, K, Nout;
  int KB;     // 64-column chunks of a row (K / 64)
  int AB;     // x tile buffers (1 or 2)
  int P;      // staging tiles a consumer group (kQkvGemm: 2 or 1; kProjGemm: 0)
  int S;      // ring slots
  int tiles;  // 64-row tiles of x
  int ncol;   // 64-column tiles of y
  int ws, nww, N;  // the window map, as Plan's

  __host__ __device__ int tile_bytes() const { return kF32Rows * KB * 2 * 128; }
  __host__ __device__ int barrier_bytes() const { return 8 * (2 * AB + 2 * S); }
  int smem_bytes() const {
    return 1024 + AB * tile_bytes() + 2 * P * kBoxB + S * kF32Slot + barrier_bytes();
  }
};

// Ring slots that fit beside AB x tiles of KB chunks and P staging tiles a
// group, at most kMaxSlots.
int ring_slots_f32(int KB, int AB, int P) {
  const int s = (kSmemMax - 1024 - 8 * (2 * AB + 2 * kMaxSlots) - AB * kF32Rows * KB * 256 - 2 * P * kBoxB) /
                kF32Slot;
  return s < kMaxSlots ? s : kMaxSlots;
}

// The bf16 kind's shapes; the first of (two x buffers, two staging tiles),
// (one, two), (one, one) that leaves a ring of kMinSlots (STAGED: kQkvGemm,
// whose output goes through staging tiles; else none).
cudaError_t make_plan_f32(PlanF32* p, int M, int K, int Nout, bool staged, int ws = 0, int Wm = 0) {
  if (M < 1 || K < kBoxK || K % kBoxK || K > kMaxKB * kBoxK || Nout < kCols || Nout % kCols)
    return cudaErrorInvalidValue;
  if (ws && (ws < 0 || 64 % ws || ws * ws % kRows || Wm < ws || Wm % ws || M % (ws * Wm)))
    return cudaErrorInvalidValue;
  p->M = M;
  p->K = K;
  p->Nout = Nout;
  p->KB = K / kBoxK;
  p->tiles = (M + kF32Rows - 1) / kF32Rows;
  p->ncol = Nout / kCols;
  p->ws = ws;
  p->nww = ws ? Wm / ws : 0;
  p->N = ws * ws;
  const int options[3][2] = {{2, 2}, {1, 2}, {1, 1}};
  for (const auto& o : options) {
    p->AB = o[0];
    p->P = staged ? o[1] : 0;
    p->S = ring_slots_f32(p->KB, p->AB, p->P);
    if (p->S >= kMinSlots) return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// The 256 consumer threads meet (named barrier 3; 1 and 2 are the groups').
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// LayerNorm (kQkvGemm) and the split in place of an f32 x tile of 64 rows:
// kF32Tpr neighbouring threads a row, each over kCw columns of every
// 64-column chunk, with the two-pass statistics met by shuffles.  Chunk b
// of a row, its f32 boxes' rows at b * kChunk and kChunk / 2 further,
// becomes its bf16 hi row at the first and its lo row at the second; a
// row's threads read the chunk before any of them writes it.
template <int KB, int KIND>
__device__ __forceinline__ void split_tile_f32(uint8_t* tile, const float* __restrict__ gamma,
                                               const float* __restrict__ beta, float eps) {
  constexpr int R = kF32Rows;
  constexpr int kCw = 64 / kF32Tpr;  // columns of a chunk a thread takes: 16
  constexpr int kQ = kCw / 4;        // its 16-byte f32 pieces
  constexpr int kChunk = 2 * R * 128;
  const int r = threadIdx.x / kF32Tpr, col = (threadIdx.x % kF32Tpr) * kCw;
  uint8_t* row = tile + r * 128;
  // piece q of chunk b: f32 columns col + 4 q .. of box (col + 4 q) / 32
  const auto f32_at = [&](int b, int q) {
    const int k = col + 4 * q;
    return reinterpret_cast<const float4*>(row + b * kChunk + (k >> 5) * (R * 128) +
                                           (((((k & 31) >> 2) ^ r) & 7) << 4));
  };
  const auto row_sum = [](float v) {
#pragma unroll
    for (int m = 1; m < kF32Tpr; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
  };
  float mu = 0.f, rs = 1.f;
  if constexpr (KIND == kQkvGemm) {
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < KB; ++b)
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = *f32_at(b, q);
        sum += (v.x + v.y) + (v.z + v.w);
      }
    mu = row_sum(sum) / (KB * kBoxK);
    float sq = 0.f;
#pragma unroll
    for (int b = 0; b < KB; ++b)
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = *f32_at(b, q);
        const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
        sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
    rs = rsqrtf(row_sum(sq) / (KB * kBoxK) + eps);
  }
#pragma unroll 1
  for (int b = 0; b < KB; ++b) {
    float v[kCw];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 x = *f32_at(b, q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
    if constexpr (KIND == kQkvGemm) {
      const float* g = gamma + b * kBoxK + col;
      const float* bt = beta + b * kBoxK + col;
#pragma unroll
      for (int e = 0; e < kCw; ++e) v[e] = (v[e] - mu) * rs * g[e] + bt[e];
    }
    uint32_t hi[kCw / 2], lo[kCw / 2];
#pragma unroll
    for (int e = 0; e < kCw / 2; ++e) {
      const Frag<float> f = split_pair(v[2 * e], v[2 * e + 1]);
      hi[e] = f.hi;
      lo[e] = f.lo;
    }
    __syncwarp();  // the row's threads have read the chunk
#pragma unroll
    for (int u = 0; u < kCw / 8; ++u) {
      uint8_t* at = row + b * kChunk + ((((col / 8 + u) ^ r) & 7) << 4);
      *reinterpret_cast<uint4*>(at) = make_uint4(hi[4 * u], hi[4 * u + 1], hi[4 * u + 2], hi[4 * u + 3]);
      *reinterpret_cast<uint4*>(at + R * 128) =
          make_uint4(lo[4 * u], lo[4 * u + 1], lo[4 * u + 2], lo[4 * u + 3]);
    }
  }
}

// The map row of window-ordered row r (K9's out-projection).
__device__ __forceinline__ long map_row(const PlanF32& p, int r) {
  const int w = r / p.N, i = r - w * p.N;
  const int wx = w % p.nww, wy = w / p.nww;
  return ((long)wy * p.ws + i / p.ws) * (p.nww * p.ws) + (long)wx * p.ws + i % p.ws;
}

// kQkvGemm's output tile: the group's 64 x 64 f32 sums plus b as their
// bf16 hi and lo planes, through the group's P staging tiles (rows
// swizzled over 128 bytes, as the output map writes them): hi into tile 0
// and lo into tile P - 1 (P = 1: once the hi plane's store has read it),
// then one TMA store of each at (col0, row0) of its plane.  A staging tile
// is written once the store that read it before has read it.
__device__ __forceinline__ void store_planes(const float (&d)[32], uint32_t stage, int P, const CUtensorMap* y_map,
                                             const float* __restrict__ bvec, int col0, int row0, int c, int warp,
                                             int g, int cc) {
  const bool leader = (threadIdx.x & 127) == 0;
  const int r = 16 * warp + g;
  uint32_t lo[16];
  store_wait_read<0>(leader);
  group_sync(c);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 b = *reinterpret_cast<const float2*>(bvec + col0 + 8 * t + 2 * cc);
    const Frag<float> f0 = split_pair(d[4 * t] + b.x, d[4 * t + 1] + b.y);
    const Frag<float> f1 = split_pair(d[4 * t + 2] + b.x, d[4 * t + 3] + b.y);
    const int byte = (8 * t + 2 * cc) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage + swizzle128(r, byte)), "r"(f0.hi) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage + swizzle128(r + 8, byte)), "r"(f1.hi) : "memory");
    lo[2 * t] = f0.lo;
    lo[2 * t + 1] = f1.lo;
  }
  const uint32_t lo_stage = stage + (P - 1) * kBoxB;
  if (P == 1) {
    fence_proxy_async();
    group_sync(c);
    store_tile_tma(leader, y_map, stage, col0, row0, 0);
    store_wait_read<0>(leader);
    group_sync(c);
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int byte = (8 * t + 2 * cc) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo_stage + swizzle128(r, byte)), "r"(lo[2 * t]) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo_stage + swizzle128(r + 8, byte)), "r"(lo[2 * t + 1])
                 : "memory");
  }
  fence_proxy_async();
  group_sync(c);
  if (P == 2) store_tile_tma(leader, y_map, stage, col0, row0, 0);
  store_tile_tma(leader, y_map, lo_stage, col0, row0, 1);
}

// One step of the f32 kind: group `first` of the step's STEP column tiles
// from ct takes tile ct + first, k-box by k-box as the bf16 kind's
// gemm_step: its slot of a box waited for, its split products issued, the
// previous box's slot released once its products are done.  Then y = acc +
// b: kQkvGemm through store_planes, kProjGemm as float2 stores straight
// from the accumulators (rows past M not written; OUT_MAP: in map order).
template <int KB, int STEP, int KIND, bool OUT_MAP>
__device__ __forceinline__ void gemm_step_f32(uint32_t slots, uint32_t bars, int S, RingPos& ring, int first,
                                              uint64_t da, uint32_t stage, const CUtensorMap* y_map,
                                              float* __restrict__ y, const PlanF32& p,
                                              const float* __restrict__ bvec, int row0, int ct, int c, int warp,
                                              int g, int cc) {
  constexpr int kChunk = 2 * kF32Rows * 128;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (S + s); };
  float d[32];
  zero(d);
  fence_regs(d);
  RingPos at = ring, rel = ring;
  for (int i = 0; i < first; ++i) {
    at.next(S);
    rel.next(S);
  }
#pragma unroll
  for (int b = 0; b < KB; ++b) {
    wait_phase(full(at.slot), at.phase);
    const uint32_t bs = slots + at.slot * kF32Slot;
#pragma unroll
    for (int i = 0; i < STEP; ++i) at.next(S);
    const uint64_t ah = da + (b * kChunk >> 4), al = ah + (kF32Rows * 128 >> 4);
    const uint64_t bh = desc<64>(bs), bl = desc<64>(bs + kBoxB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_ss(d, al + 2 * kk, bh + 2 * kk);
      wgmma_m64n64k16_ss(d, ah + 2 * kk, bl + 2 * kk);
      wgmma_m64n64k16_ss(d, ah + 2 * kk, bh + 2 * kk);
    }
    wgmma_commit();
    if (b > 0) {
      wgmma_wait<1>();
      arrive_nb(empty(rel.slot));
#pragma unroll
      for (int i = 0; i < STEP; ++i) rel.next(S);
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
  arrive_nb(empty(rel.slot));
#pragma unroll
  for (int b = 0; b < KB; ++b)
#pragma unroll
    for (int i = 0; i < STEP; ++i) ring.next(S);
  const int col0 = (ct + first) * kCols;
  if constexpr (KIND == kQkvGemm) {
    store_planes(d, stage, p.P, y_map, bvec, col0, row0, c, warp, g, cc);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + g + 8 * h;
      if (r >= p.M) continue;
      float* out = y + (OUT_MAP ? map_row(p, r) : (long)r) * p.Nout + col0 + 2 * cc;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float2 bb = *reinterpret_cast<const float2*>(bvec + col0 + 8 * t + 2 * cc);
        *reinterpret_cast<float2*>(out + 8 * t) =
            make_float2(d[4 * t + 2 * h] + bb.x, d[4 * t + 2 * h + 1] + bb.y);
      }
    }
  }
}

// The f32 kind's kernel: the bf16 kind's roles (warp 8 the x tiles, warp 9
// the ring, the consumer groups the products).  y_map: kQkvGemm's planes;
// y: kProjGemm's f32 rows.
template <int KB, int KIND, bool MAP>
__global__ void __launch_bounds__(kThreads, 1)
ln_gemm_f32_sm90(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap y_map, float* __restrict__ y,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ bvec, const PlanF32 p, float eps) {
  constexpr int R = kF32Rows;
  constexpr int kTile = R * KB * 2 * 128;
  constexpr bool kInMap = MAP && KIND == kQkvGemm;
  constexpr bool kOutMap = MAP && KIND == kProjGemm;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int S = p.S, AB = p.AB;
  const uint32_t stages = base + AB * kTile, slots = stages + 2 * p.P * kBoxB;
  const uint32_t bars = slots + S * kF32Slot;
  const uint32_t a_bars = bars + 16 * S;  // each x buffer's full, then its empty
  uint8_t* tiles = smem_raw + (base - raw);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), 4);  // the warps of the group that reads the slot
    }
    for (int i = 0; i < AB; ++i) {
      mbar_init(a_bars + 8 * i, 1);
      mbar_init(a_bars + 8 * (AB + i), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    const int warp = (threadIdx.x - kConsumers) / 32;
    if ((threadIdx.x & 31) != 0) return;
    if (warp == 0) {  // the x tiles, into the buffers in turns, two f32 boxes a chunk
      int n = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++n) {
        const int buf = n % AB, use = n / AB;
        if (use > 0) mbar_wait(a_bars + 8 * (AB + buf), (use - 1) & 1);
        mbar_expect_tx(a_bars + 8 * buf, kTile);
        const uint32_t dst = base + buf * kTile;
        for (int x = 0; x < 2 * KB; ++x) {
          if constexpr (kInMap)
            tma_load_5d(dst + x * R * 128, &x_map, a_bars + 8 * buf, x * kF32BoxK, WinCoords(p, t * R));
          else
            tma_load(dst + x * R * 128, &x_map, a_bars + 8 * buf, x * kF32BoxK, t * R, 0);
        }
      }
    } else if (warp == 1) {  // the ring in the bf16 kind's order: a slot a (box, column tile), hi and lo
      RingPos pos;
      bool wrapped = false;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
        for (int ct = 0; ct < p.ncol; ct += 2)
          for (int b = 0; b < KB; ++b)
            for (int i = 0; i < (ct + 1 < p.ncol ? 2 : 1); ++i) {
              const uint32_t full = bars + 8 * pos.slot, dst = slots + pos.slot * kF32Slot;
              if (wrapped) mbar_wait(bars + 8 * (S + pos.slot), pos.phase ^ 1);
              mbar_expect_tx(full, kF32Slot);
              tma_load(dst, &w_map, full, b * kBoxK, (ct + i) * kCols, 0);
              tma_load(dst + kBoxB, &w_map, full, b * kBoxK, (ct + i) * kCols, 1);
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
  const uint32_t stage = stages + c * p.P * kBoxB;  // the group's P staging tiles
  RingPos ring;
  int n = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++n) {
    const int buf = n % AB;
    mbar_wait(a_bars + 8 * buf, (n / AB) & 1);
    split_tile_f32<KB, KIND>(tiles + buf * kTile, gamma, beta, eps);
    fence_proxy_async();
    consumers_sync();  // both groups read every row of the tile
    const uint64_t da = desc<64>(base + buf * kTile);  // chunk 0's hi box
    int ct = 0;
    for (; ct + 1 < p.ncol; ct += 2)
      gemm_step_f32<KB, 2, KIND, kOutMap>(slots, bars, S, ring, c, da, stage, &y_map, y, p, bvec, t * R, ct, c,
                                          warp, g, cc);
    if (ct < p.ncol) {
      if (c == 0)
        gemm_step_f32<KB, 1, KIND, kOutMap>(slots, bars, S, ring, 0, da, stage, &y_map, y, p, bvec, t * R, ct,
                                            c, warp, g, cc);
      else
        for (int b = 0; b < KB; ++b) ring.next(S);  // group 0's tile
    }
    release(a_bars + 8 * (AB + buf));
  }
  // the group's output stores have read their staging tiles before the block exits
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int KB, int KIND, bool MAP>
cudaError_t launch_f32_kb(const CUtensorMap (&maps)[3], void* y, const float* gamma, const float* beta,
                          const float* b, const PlanF32& p, float eps, int sms, cudaStream_t stream) {
  static bool opted_in = false;  // one per instance, and this library's own
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_gemm_f32_sm90<KB, KIND, MAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  ln_gemm_f32_sm90<KB, KIND, MAP><<<grid, kThreads, p.smem_bytes(), stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(y), gamma, beta, b, p, eps);
  return cudaGetLastError();
}

// One call of the f32 kind: x (M, K) contiguous f32, wt2 the (2, Nout, K)
// bf16 (hi, lo) pair, y the (2, M, Nout) bf16 (hi, lo) planes (kQkvGemm)
// or (M, Nout) f32 (kProjGemm), 16-byte aligned bases; gamma, beta (K) f32
// (unread in kProjGemm), b (Nout) f32.  The bf16 kind's shapes and window
// map (x of kQkvGemm in map order; y of kProjGemm written in map order).
// Anything else returns cudaErrorInvalidValue.
template <int KIND, bool MAP>
cudaError_t run_f32(const float* x, const float* gamma, const float* beta, const void* wt2, const float* b,
                    void* y, int M, int K, int Nout, float eps, cudaStream_t stream, int ws = 0, int Wm = 0) {
  static_assert(KIND == kQkvGemm || KIND == kProjGemm, "a kind of the core");
  if (MAP != (ws > 0)) return cudaErrorInvalidValue;
  PlanF32 p;
  cudaError_t e = make_plan_f32(&p, M, K, Nout, KIND == kQkvGemm, ws, Wm);
  if (e != cudaSuccess) return e;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32, kBf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[3];
  e = MAP && KIND == kQkvGemm
          ? encode_window_map(&maps[0], kF32, 4, x, K, ws, Wm, M, kF32Rows)
          : encode_3d(&maps[0], kF32, 4, x, K, M, 1, kF32BoxK, kF32Rows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess) e = encode_3d(&maps[1], kBf, 2, wt2, K, Nout, 2, kBoxK, kCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess) {
    if (KIND == kQkvGemm)  // the (2, M, Nout) planes in 64 x 64 boxes
      e = encode_3d(&maps[2], kBf, 2, y, Nout, M, 2, kCols, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    else
      maps[2] = maps[1];  // unread: kProjGemm stores from the accumulators
  }
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  switch (p.KB) {
    case 1: return launch_f32_kb<1, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 2: return launch_f32_kb<2, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 3: return launch_f32_kb<3, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 4: return launch_f32_kb<4, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 5: return launch_f32_kb<5, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 6: return launch_f32_kb<6, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 7: return launch_f32_kb<7, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    case 8: return launch_f32_kb<8, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
    default: return launch_f32_kb<9, KIND, MAP>(maps, y, gamma, beta, b, p, eps, sms, stream);
  }
}

}  // namespace
}  // namespace lng90
}  // namespace gg
