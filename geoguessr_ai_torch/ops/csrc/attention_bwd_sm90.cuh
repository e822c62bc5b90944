// The Hopper core of the bf16 window-attention backwards K4
// (attention_qkv_bwd.cu, a bf16 bias), K5 (attention_bwd_merged.cu, an f32
// bias, one window group) and K7 (attention_bwd_qtiled.cu, an f32 bias).  It computes what attention_bwd.cuh computes, with the same
// numerics (that file's head comment): s in f32 from bf16 products plus
// the bias, the row softmax in f32, t = sum_row dp * p, ds = p * (dp - t),
// dv from bf16(p), dq and dk from bf16(ds) times scale, d_bias the f32 sum
// of ds over the windows; each d_qkv sum rounded to bf16 once.
//
// Four persistent launches, each one block of 384 threads on every SM
// walking its work items in a fixed order, with one tile core:
//
//   stats  item (128-query tile, window, head): the row max m, 1 / row sum
//          and t of each query, from one online pass over the 64-key tiles
//          (t's sum rescaled with the max as the row sum is: K4) or from
//          two, the first on the scores alone and t in the second, as
//          attention_bwd.cuh computes them (K5 and K7: their first design's
//          rounding, bit for bit);
//   dkdv   item (128-key tile, window, head): s^T = k q^T and dp^T = v g^T
//          per 64-query tile, then dv += bf16(p^T) g and dk += bf16(ds^T) q;
//   dq     item (128-query tile, window, head): s, dp per 64-key tile, then
//          dq += bf16(ds) k;
//   dbias  item (128-query tile, 64-key tile, head, window group): s, dp
//          and ds of that tile for each window of the group in order,
//          summed in registers; one f32 partial per group, and a last
//          launch sums the G partials in group order when G > 1.
//
// Every cross-item sum is owned by one item and taken in an order fixed by
// the shape alone (window order inside a group, group order across
// groups), never by the grid or by timing, and there are no atomics, so
// d_qkv and d_bias are bitwise the same from run to run.  G, the number of
// window groups, is a function of (W, N, H) chosen by the wrapper
// (window_attention._bwd_groups); group i owns windows [i W / G,
// (i + 1) W / G).
//
// The tile core is built from K6's (clip_flash.cu) pieces: one thread of
// a producer warpgroup keeps TMA loads in flight through two rings of
// shared memory, each slot with a full and an empty mbarrier: kRowBufs
// slots of the item's row side (two tensors of 128 rows, plus the rows'
// statistics in dq and dbias) and kStages slots of 64-row column tiles (two
// tensors, plus the 64 queries' statistics in dkdv, plus the step's bias
// tile).  Two consumer warpgroups own 64 rows each and run both score
// products as wgmma.m64n64k16 from shared memory (K-major, the swizzle of
// one head row), the softmax algebra in registers, and the products over
// the column tile's 64 rows as wgmma with the bf16 p or ds in registers and
// the column tile read MN-major; those run on into the next step, whose
// column slot is released a step later.  The producer warpgroup gives its
// registers to the consumers (setmaxnreg).  The tensors are read in place:
// one tensor map over the interleaved (W, N, 3D) qkv (q, k, v of head h at
// columns 3 h hd, + hd, + 2 hd), one over the (W, N, D) g and one over the
// (H, N, N) bias.
//
// What bounds a step, and what the design does about it: the tiles of a
// step are 8 KB against 0.5 MFLOP of products, so bytes bound nothing; the
// bias tile of a step is 16 KB (bf16) or 32 KB (f32), read by every thread
// at its accumulator positions.  Read from device memory that pattern
// costs ~128 L1 wavefronts a warp a step (8 cache lines a 256-byte load)
// and sets the pace, so the producer brings the tile into the slot by
// TMA, in boxes of 128-byte rows with the 128-byte swizzle, which spreads
// each warp's reads over the banks (dbias reads its item's tile once, into
// registers).
// What is left is each step's chain (the waits, the score products, ~250
// instructions a thread of softmax algebra with 32 exponentials) on two
// warpgroups an SM.  Two-pass stats issues step s + 1's score products
// before step s's algebra (two register sets); in dq and dkdv the second
// set spills, and one-pass stats is slower for it.
#pragma once

#include <type_traits>

#include "attention_bwd.cuh"
#include "sm90.cuh"

namespace gg {
namespace bwd90 {

using namespace sm90;

enum Mode { kStats = 0, kDkdv = 1, kDq = 2, kDbias = 3 };

constexpr int kRowsA = 128;    // row-side rows of an item: two consumer warpgroups of 64
constexpr int kCols = 64;      // column-side rows of a step
constexpr int kConsumers = 256;             // two consumer warpgroups,
constexpr int kThreads = kConsumers + 128;  // then the producer warpgroup
// registers a thread after setmaxnreg: 168 at launch (64K over 384
// threads), the producer's 128 given to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory of one launch, from a 1024-byte aligned base: kRowBufs row
// slots, kStages column slots, then the mbarriers.
template <int HD, int MODE, class BiasT>
struct Smem {
  static constexpr int kHalf = kCols * HD * 2;        // 64 rows of one tensor
  static constexpr int kRowStats = 4 * kHalf;         // a row slot's statistics, after its tiles
  static constexpr int kRowBuf = 4 * kHalf + 2048;    // two tensors of 128 rows, m, 1/l, t of 128
  // dbias walks units of one step each, so it keeps more rows in flight
  static constexpr int kRowBufs = MODE == kDbias ? 4 : 2;
  static constexpr int kStatBytes = 3 * kCols * 4;    // m, 1/l, t of 64 queries (dkdv)
  // the step's bias tile, 128 rows x 64 columns (128 keys x 64 queries in
  // dkdv), in boxes of 128-byte rows written with the 128-byte swizzle;
  // dbias reads its tile once an item, into registers
  static constexpr bool kBiasTile = MODE != kDbias;
  static constexpr int kBoxElems = 128 / (int)sizeof(BiasT);
  static constexpr int kBiasOffset = 2 * kHalf + 1024;
  static constexpr int kStage = kBiasOffset + (kBiasTile ? kRowsA * kCols * (int)sizeof(BiasT) : 0);
  static constexpr int kFit = (216 * 1024 - 1024 - kRowBufs * kRowBuf) / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static_assert(kStages >= 3, "a ring of at least three column slots");
  static constexpr int kColsOffset = kRowBufs * kRowBuf;
  static constexpr int kBarOffset = kColsOffset + kStages * kStage;
  static constexpr int kBytes = 1024 + kBarOffset + 16 * (kRowBufs + kStages);
};

// The work of one launch: its items and how an item decodes.
struct Geometry {
  int W, N, H, G;
  int R, C;  // 128-row tiles and 64-row tiles of N

  __host__ __device__ Geometry(int W_, int N_, int H_, int G_)
      : W(W_), N(N_), H(H_), G(G_), R((N_ + kRowsA - 1) / kRowsA), C(N_ / kCols) {}

  __host__ __device__ long items(int mode) const {
    return mode == kDbias ? (long)C * R * G * H : (long)R * W * H;
  }

  // Item `it` of `mode` -> its head, row tile, column tile (dbias) and
  // windows [w0, w1).  The row tile is fastest, so the blocks in flight
  // share the other side's tiles and the bias of one head in L2.
  __device__ void decode(int mode, int it, int& h, int& rt, int& ct, int& w0, int& w1) const {
    if (mode == kDbias) {
      ct = it % C;
      it /= C;
      rt = it % R;
      it /= R;
      const int grp = it % G;
      h = it / G;
      w0 = grp * W / G;
      w1 = (grp + 1) * W / G;
    } else {
      rt = it % R;
      it /= R;
      w0 = it % W;
      w1 = w0 + 1;
      h = it / W;
      ct = 0;
    }
  }
};

// The bias at the thread's 32 accumulator elements of a 64 x 64 tile: s[4t
// + i] holds row lr0 + 8 (i >> 1) of the row tile, column 8 t + 2 c + (i &
// 1) of the column tile.  From the stage's swizzled tile (`tile`), whose
// boxes hold 128-byte rows of kBoxElems columns (row-major: 128 rows a box)
// or of kBoxElems keys (dkdv: the bias read transposed, 64 queries a box);
// the swizzle spreads a warp's reads over the banks.
template <int MODE, class BiasT>
__device__ __forceinline__ void bias_from_tile(float (&b)[32], const uint8_t* tile, int lr0, int c) {
  constexpr int E = sizeof(BiasT), kBox = 128 / E;
  if constexpr (MODE == kDkdv) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = lr0 + 8 * (i >> 1), q = 8 * t + 2 * c + (i & 1);
        const uint8_t* p = tile + (key / kBox) * (kCols * 128) + swizzle128(q, (key % kBox) * E);
        b[4 * t + i] = to_f(*reinterpret_cast<const BiasT*>(p));
      }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = lr0 + 8 * half, col = 8 * t + 2 * c;
        const uint8_t* p = tile + (col / kBox) * (kRowsA * 128) + swizzle128(row, (col % kBox) * E);
        const float2 v = load2(reinterpret_cast<const BiasT*>(p));
        b[4 * t + 2 * half] = v.x;
        b[4 * t + 2 * half + 1] = v.y;
      }
  }
}

// The same elements read from device memory (dbias, once an item; rows r0
// and r0 + 8 of the bias, columns col0 ..).
template <class BiasT>
__device__ __forceinline__ void bias_from_memory(float (&b)[32], const BiasT* __restrict__ bias,
                                                 int h, int N, int r0, int col0, int c) {
  const BiasT* b0 = bias + ((long)h * N + r0) * N + col0 + 2 * c;
  const BiasT* b1 = b0 + 8L * N;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 x = load2(b0 + 8 * t), y = load2(b1 + 8 * t);
    b[4 * t + 0] = x.x;
    b[4 * t + 1] = x.y;
    b[4 * t + 2] = y.x;
    b[4 * t + 3] = y.y;
  }
}

// The thread's d (64 x HD accumulator, rows r0 and r0 + 8) times `sc`
// into the hd columns at `out` of rows r0 and r0 + 8 (row pitch ld).
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, long ld, const float (&d)[HD / 2], float sc,
                                           int c) {
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) {
    store2(out + 8 * t + 2 * c, d[4 * t + 0] * sc, d[4 * t + 1] * sc);
    store2(out + 8 * ld + 8 * t + 2 * c, d[4 * t + 2] * sc, d[4 * t + 3] * sc);
  }
}

// Accumulator layout of a consumer thread (warp w of its group, lane =
// 4g + c), as mma.sync's C fragment in each 8-column tile t: d[4t + 0..1]
// = row 16w + g, columns 8t + 2c + 0..1; d[4t + 2..3] = row 16w + g + 8.
// Threads 0-255 are the two consumer warpgroups, 256-383 the producer.
// PASSES (stats only): over the key tiles, 1 or 2 (see launch).
template <int HD, int MODE, class BiasT, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_sm90(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap g_map,
              const __grid_constant__ CUtensorMap bias_map, BwdArgs<bf16> a,
              const BiasT* __restrict__ bias, float* __restrict__ dbias_dst, Geometry geo) {
  using S = Smem<HD, MODE, BiasT>;
  constexpr int kRowBufs = S::kRowBufs, kStages = S::kStages;
  // dq and dbias read the row side's statistics, dkdv the column side's
  constexpr bool kRowStats = MODE == kDq || MODE == kDbias;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t rows0 = base;                          // row slot b at + b * kRowBuf
  const uint32_t cols0 = base + S::kColsOffset;         // column slot s at + s * kStage
  const uint32_t full_row = base + S::kBarOffset;       // + 8 b
  const uint32_t empty_row = full_row + 8 * kRowBufs;   // released by the 8 consumer warps
  const uint32_t full_col = empty_row + 8 * kRowBufs;   // + 8 s
  const uint32_t empty_col = full_col + 8 * kStages;    // released by the 8 consumer warps
  // the generic address of a shared one
  auto at = [&](uint32_t saddr) { return smem_raw + (saddr - raw); };

  const int N = a.N, H = a.H;
  const long plane = (long)a.W * H * N;
  const int items = (int)geo.items(MODE);  // below 2^31 (launch_mode)
  // stats walks the key tiles twice: the row max and sum, then t
  const int steps = MODE == kDbias ? 1 : MODE == kStats ? PASSES * geo.C : geo.C;
  // the first of two stats passes needs neither v nor dp
  auto scores_only = [&](int s) { return MODE == kStats && PASSES == 2 && s < geo.C; };

  if (threadIdx.x == 0) {
    for (int b = 0; b < kRowBufs; ++b) {
      mbar_init(full_row + 8 * b, 1);
      mbar_init(empty_row + 8 * b, 8);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_col + 8 * s, 1);
      mbar_init(empty_col + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int ru = 0, cs = 0;  // row and column slots filled so far: the ring positions
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int h, rt, ct, w0, w1;
        geo.decode(MODE, it, h, rt, ct, w0, w1);
        const int qc = h * 3 * HD;  // q of head h in qkv; k at + HD, v at + 2 HD
        // row side: q and g, or k and v (dkdv); column side: k and v, or q and g
        const int a1 = MODE == kDkdv ? qc + HD : qc;
        const int a2 = MODE == kDkdv ? qc + 2 * HD : h * HD;
        const CUtensorMap* a2map = MODE == kDkdv ? &qkv_map : &g_map;
        const int b1 = MODE == kDkdv ? qc : qc + HD;
        const int b2 = MODE == kDkdv ? h * HD : qc + 2 * HD;
        const CUtensorMap* b2map = MODE == kDkdv ? &g_map : &qkv_map;
        // rows of the tile below N: 128, or 64 for the last when N % 128 == 64
        const int live = N - rt * kRowsA < kRowsA ? N - rt * kRowsA : kRowsA;
        const int halves = live / 64;
        // the bias boxes of a step: dkdv's hold kBoxElems keys of the row
        // tile each (those wholly past N are not loaded), the others
        // kBoxElems columns of all 128 rows
        const int boxes = MODE == kDkdv ? live / S::kBoxElems : kCols / S::kBoxElems;
        const int box_bytes = MODE == kDkdv ? kCols * 128 : kRowsA * 128;
        for (int w = w0; w < w1; ++w, ++ru) {
          const int rb = ru % kRowBufs;
          if (ru >= kRowBufs) mbar_wait(empty_row + 8 * rb, ((ru / kRowBufs) - 1) & 1);
          const uint32_t dst = rows0 + rb * S::kRowBuf, bar = full_row + 8 * rb;
          mbar_expect_tx(bar, halves * (2 * S::kHalf + (kRowStats ? 3 * 64 * 4 : 0)));
          for (int hf = 0; hf < halves; ++hf) {
            tma_load(dst + hf * S::kHalf, &qkv_map, bar, a1, rt * kRowsA + hf * 64, w);
            tma_load(dst + (2 + hf) * S::kHalf, a2map, bar, a2, rt * kRowsA + hf * 64, w);
          }
          if (kRowStats) {
            const float* st0 = a.stats + stat_index(a, w, h, rt * kRowsA);
#pragma unroll
            for (int p = 0; p < 3; ++p)
              bulk_load(dst + S::kRowStats + p * kRowsA * 4, st0 + p * plane, halves * 64 * 4, bar);
          }
          for (int s = 0; s < steps; ++s, ++cs) {
            const int j = MODE == kDbias ? ct : s % geo.C;
            const int st = cs % kStages;
            if (cs >= kStages) mbar_wait(empty_col + 8 * st, ((cs / kStages) - 1) & 1);
            const uint32_t cdst = cols0 + st * S::kStage, cbar = full_col + 8 * st;
            const bool dp_tile = !scores_only(s);
            mbar_expect_tx(cbar, (dp_tile ? 2 : 1) * S::kHalf + (MODE == kDkdv ? S::kStatBytes : 0) +
                                     (S::kBiasTile ? boxes * box_bytes : 0));
            tma_load(cdst, &qkv_map, cbar, b1, j * kCols, w);
            if (dp_tile) tma_load(cdst + S::kHalf, b2map, cbar, b2, j * kCols, w);
            if (MODE == kDkdv) {
              const float* st0 = a.stats + stat_index(a, w, h, j * kCols);
#pragma unroll
              for (int p = 0; p < 3; ++p)
                bulk_load(cdst + 2 * S::kHalf + p * kCols * 4, st0 + p * plane, kCols * 4, cbar);
            }
            if (S::kBiasTile) {
              const uint32_t bdst = cdst + S::kBiasOffset;
              for (int b = 0; b < boxes; ++b) {
                if (MODE == kDkdv)  // keys rt*128 + b*kBoxElems.., queries j*64..
                  tma_load(bdst + b * box_bytes, &bias_map, cbar, rt * kRowsA + b * S::kBoxElems,
                           j * kCols, h);
                else  // columns j*64 + b*kBoxElems.., rows rt*128..
                  tma_load(bdst + b * box_bytes, &bias_map, cbar, j * kCols + b * S::kBoxElems,
                           rt * kRowsA, h);
              }
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cg = threadIdx.x / 128;  // rows 64 cg .. of each row tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int lr0 = cg * 64 + warp * 16 + g;  // this thread's rows lr0, lr0 + 8 of a row tile
    const long ld = 3L * H * HD;
    const float scale = a.scale;
    // this warp is done with a slot
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int ru = 0, cs = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      int h, rt, ct, w0, w1;
      geo.decode(MODE, it, h, rt, ct, w0, w1);
      const int r0 = rt * kRowsA + lr0;  // this thread's rows r0, r0 + 8
      // rows >= N (the second half of the last tile when N % 128 == 64):
      // the group keeps the barrier protocol but computes nothing
      const bool active = rt * kRowsA + cg * 64 < N;
      float acc[32];  // dbias: the sum of ds over the group's windows
      float bt[32];   // dbias: the bias of the item's tile
      zero(acc);
      if (MODE == kDbias && active) bias_from_memory(bt, bias, h, N, r0, ct * kCols, c);

      for (int w = w0; w < w1; ++w, ++ru) {
        const int rb = ru % kRowBufs;
        const uint32_t arow = rows0 + rb * S::kRowBuf + cg * S::kHalf;
        const uint64_t da1 = desc<HD>(arow), da2 = desc<HD>(arow + 2 * S::kHalf);
        // stats: running max, this thread's shares of the row sum and of
        // t; dq, dbias: the rows' statistics
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
        float il0 = 0.f, il1 = 0.f, t0 = 0.f, t1 = 0.f;
        float o1[HD / 2], o2[HD / 2];  // dq; or dk and dv (dkdv)
        zero(o1);
        zero(o2);
        mbar_wait(full_row + 8 * rb, (ru / kRowBufs) & 1);
        if (kRowStats) {
          const float* rs = reinterpret_cast<const float*>(at(rows0 + rb * S::kRowBuf + S::kRowStats));
          m0 = rs[lr0];
          m1 = rs[lr0 + 8];
          il0 = rs[kRowsA + lr0];
          il1 = rs[kRowsA + lr0 + 8];
          t0 = rs[2 * kRowsA + lr0];
          t1 = rs[2 * kRowsA + lr0 + 8];
        }

        if (!active) {
          // keep the ring's protocol: every column slot waited for and released
          for (int s = 0; s < steps; ++s, ++cs) {
            mbar_wait(full_col + 8 * (cs % kStages), (cs / kStages) & 1);
            release(empty_col + 8 * (cs % kStages));
          }
        } else {
          // Two-pass stats issues the score products of step s + 1 before
          // step s's algebra, so the tensor cores run while it does (two
          // register sets in turns; a slot released one step later).  The
          // other launches issue a step's products at its start and wait
          // for them: issued ahead, dq and dkdv spill and one-pass stats
          // is slower.
          constexpr bool ahead = MODE == kStats && PASSES == 2;
          float sa[2][32], dp[2][32];
          const int cs0 = cs;
          auto slot = [&](int s) { return cols0 + ((cs0 + s) % kStages) * S::kStage; };
          auto issue = [&](auto P, int s) {
            constexpr int p = decltype(P)::value;
            const int k = cs0 + s;
            mbar_wait(full_col + 8 * (k % kStages), (k / kStages) & 1);
            const uint32_t bcol = slot(s);
            zero(sa[p]);
            zero(dp[p]);
            fence_regs(sa[p]);
            fence_regs(dp[p]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_m64n64k16_ss(sa[p], da1 + 2 * kk, desc<HD>(bcol) + 2 * kk);
            if (!scores_only(s)) {
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk)
                wgmma_m64n64k16_ss(dp[p], da2 + 2 * kk, desc<HD>(bcol + S::kHalf) + 2 * kk);
            }
            wgmma_commit();
          };
          auto step = [&](auto P, int s) {
            constexpr int p = decltype(P)::value;
            const uint32_t bcol = slot(s);
            if constexpr (!ahead) issue(P, s);
            float bs[32];  // the step's bias, read while the products run
            if (MODE == kDbias) {
#pragma unroll
              for (int i = 0; i < 32; ++i) bs[i] = bt[i];
            } else {
              bias_from_tile<MODE, BiasT>(bs, at(bcol + S::kBiasOffset), lr0, c);
            }
            bool waited = false;
            if constexpr (ahead) {
              if (s + 1 < steps) {
                issue(std::integral_constant<int, 1 - p>(), s + 1);
                wgmma_wait<1>();  // all but step s + 1's scores
                waited = true;
              }
            }
            if (!waited) wgmma_wait<0>();
            fence_regs(sa[p]);
            fence_regs(dp[p]);
            if constexpr (ahead) {
              if (s > 0) release(empty_col + 8 * ((cs0 + s - 1) % kStages));
            }
            float(&x)[32] = sa[p];
            float(&y)[32] = dp[p];

            if constexpr (MODE == kStats) {
              if (PASSES == 1 || s < geo.C) {
                // the running max and row sum; in one pass also u = the
                // sum of exp(s - m) dp, rescaled as the row sum is
                float mx0 = m0, mx1 = m1;
#pragma unroll
                for (int t = 0; t < 8; ++t) {
#pragma unroll
                  for (int i = 0; i < 4; ++i) x[4 * t + i] = x[4 * t + i] * scale + bs[4 * t + i];
                  mx0 = fmaxf(mx0, fmaxf(x[4 * t + 0], x[4 * t + 1]));
                  mx1 = fmaxf(mx1, fmaxf(x[4 * t + 2], x[4 * t + 3]));
                }
                mx0 = quad_max(mx0);
                mx1 = quad_max(mx1);
                const float al0 = __expf(m0 - mx0), al1 = __expf(m1 - mx1);
                float r0s = 0.f, r1s = 0.f, v0s = 0.f, v1s = 0.f;
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                  const float e0 = __expf(x[4 * t + 0] - mx0), e1 = __expf(x[4 * t + 1] - mx0);
                  const float e2 = __expf(x[4 * t + 2] - mx1), e3 = __expf(x[4 * t + 3] - mx1);
                  r0s += e0 + e1;
                  r1s += e2 + e3;
                  if (PASSES == 1) {
                    v0s += e0 * y[4 * t + 0] + e1 * y[4 * t + 1];
                    v1s += e2 * y[4 * t + 2] + e3 * y[4 * t + 3];
                  }
                }
                l0 = l0 * al0 + r0s;
                l1 = l1 * al1 + r1s;
                u0 = u0 * al0 + v0s;
                u1 = u1 * al1 + v1s;
                m0 = mx0;
                m1 = mx1;
              } else {  // pass 2 of 2: t = sum_row dp * p with the final p
                if (s == geo.C) {
                  il0 = 1.f / quad_sum(l0);
                  il1 = 1.f / quad_sum(l1);
                }
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                  const float s0 = x[4 * t + 0] * scale + bs[4 * t + 0];
                  const float s1 = x[4 * t + 1] * scale + bs[4 * t + 1];
                  const float s2 = x[4 * t + 2] * scale + bs[4 * t + 2];
                  const float s3 = x[4 * t + 3] * scale + bs[4 * t + 3];
                  u0 += __expf(s0 - m0) * il0 * y[4 * t + 0] + __expf(s1 - m0) * il0 * y[4 * t + 1];
                  u1 += __expf(s2 - m1) * il1 * y[4 * t + 2] + __expf(s3 - m1) * il1 * y[4 * t + 3];
                }
              }
            } else if constexpr (MODE == kDq || MODE == kDbias) {
#pragma unroll
              for (int t = 0; t < 8; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float pr = __expf(x[4 * t + i] * scale + bs[4 * t + i] - (i < 2 ? m0 : m1)) *
                                   (i < 2 ? il0 : il1);
                  const float ds = pr * (y[4 * t + i] - (i < 2 ? t0 : t1));
                  if (MODE == kDbias) acc[4 * t + i] += ds;
                  else x[4 * t + i] = ds;
                }
              if constexpr (MODE == kDq) {
                // dq += bf16(ds) k
                uint32_t fa[4][4];
                pack_a(x, fa);
                fence_regs(o1);
                wgmma_fence();
                wgmma_k64_rs<HD>(o1, fa, desc<HD>(bcol));
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(o1);
              }
            } else {  // dkdv: rows are keys, columns queries
              // m, 1/l and t of the 64 queries
              const float* sst = reinterpret_cast<const float*>(at(bcol + 2 * S::kHalf));
#pragma unroll
              for (int t = 0; t < 8; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int q = 8 * t + 2 * c + (i & 1);
                  const float pr =
                      __expf(x[4 * t + i] * scale + bs[4 * t + i] - sst[q]) * sst[kCols + q];
                  x[4 * t + i] = pr;
                  y[4 * t + i] = pr * (y[4 * t + i] - sst[2 * kCols + q]);
                }
              // dv += bf16(p^T) g, dk += bf16(ds^T) q
              uint32_t fp[4][4], fd[4][4];
              pack_a(x, fp);
              pack_a(y, fd);
              fence_regs(o1);
              fence_regs(o2);
              wgmma_fence();
              wgmma_k64_rs<HD>(o2, fp, desc<HD>(bcol + S::kHalf));
              wgmma_k64_rs<HD>(o1, fd, desc<HD>(bcol));
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(o1);
              fence_regs(o2);
            }
            if constexpr (!ahead) release(empty_col + 8 * ((cs0 + s) % kStages));
          };
          if constexpr (ahead) issue(std::integral_constant<int, 0>(), 0);
          for (int s = 0; s < steps; s += 2) {
            step(std::integral_constant<int, 0>(), s);
            if (s + 1 < steps) step(std::integral_constant<int, 1>(), s + 1);
          }
          if constexpr (ahead) release(empty_col + 8 * ((cs0 + steps - 1) % kStages));
          cs += steps;
        }
        release(empty_row + 8 * rb);

        if (!active) continue;
        bf16* out = a.dqkv + ((long)w * N + r0) * ld + h * 3 * HD;
        if constexpr (MODE == kStats) {
          u0 = quad_sum(u0);
          u1 = quad_sum(u1);
          if (PASSES == 1) {  // 1 / l, and t = u / l
            il0 = 1.f / quad_sum(l0);
            il1 = 1.f / quad_sum(l1);
            u0 *= il0;
            u1 *= il1;
          }
          if (c == 0) {
            const long i0 = stat_index(a, w, h, r0), i1 = i0 + 8;
            a.stats[i0] = m0;
            a.stats[i1] = m1;
            a.stats[plane + i0] = il0;
            a.stats[plane + i1] = il1;
            a.stats[2 * plane + i0] = u0;
            a.stats[2 * plane + i1] = u1;
          }
        } else if constexpr (MODE == kDq) {
          store_rows<HD>(out, ld, o1, scale, c);
        } else if constexpr (MODE == kDkdv) {
          store_rows<HD>(out + HD, ld, o1, scale, c);
          store_rows<HD>(out + 2 * HD, ld, o2, 1.f, c);
        }
      }

      if (MODE == kDbias && active) {
        const int grp = it / (geo.C * geo.R) % geo.G;
        float* d0 = dbias_dst + (((long)grp * H + h) * N + r0) * N + ct * kCols + 2 * c;
        float* d1 = d0 + 8L * N;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          *reinterpret_cast<float2*>(d0 + 8 * t) = make_float2(acc[4 * t + 0], acc[4 * t + 1]);
          *reinterpret_cast<float2*>(d1 + 8 * t) = make_float2(acc[4 * t + 2], acc[4 * t + 3]);
        }
      }
    }
  }
}

// d_bias = the sum of the G partials (G, H, N, N) in group order.
__global__ void __launch_bounds__(256)
dbias_reduce(const float4* __restrict__ partial, float4* __restrict__ dbias, long n4, int G) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += (long)gridDim.x * blockDim.x) {
    float4 s = partial[i];
    for (int k = 1; k < G; ++k) {
      const float4 v = partial[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dbias[i] = s;
  }
}

template <class BiasT>
constexpr CUtensorMapDataType map_type() {
  return sizeof(BiasT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// static: its opt-in flag must be this library's.  The flag of a function
// with external linkage is one object process-wide (a GNU unique symbol),
// so K7's library setting it would leave K5's kernels, which are the same
// instances, without their shared-memory opt-in.
template <int HD, int MODE, class BiasT, int PASSES = 1>
static cudaError_t launch_mode(const CUtensorMap& qmap, const CUtensorMap& gmap, const BwdArgs<bf16>& a,
                        const BiasT* bias, float* dst, const Geometry& geo, int sms,
                        cudaStream_t stream) {
  using S = Smem<HD, MODE, BiasT>;
  static bool opted_in = false;  // one per instance
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_sm90<HD, MODE, BiasT, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kBytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  // the bias (H, N, N) in boxes of 128-byte rows: 128 rows of a row tile,
  // or (dkdv) 64 queries of a column tile; dbias reads it directly
  CUtensorMap bmap = qmap;
  if (S::kBiasTile) {
    const cudaError_t e = encode_3d(&bmap, map_type<BiasT>(), sizeof(BiasT), bias, a.N, a.N, a.H,
                                    S::kBoxElems, MODE == kDkdv ? kCols : kRowsA,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
  }
  const long items = geo.items(MODE);
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;  // the kernel counts items in int
  const int grid = (int)(items < sms ? items : sms);
  attn_bwd_sm90<HD, MODE, BiasT, PASSES>
      <<<grid, kThreads, S::kBytes, stream>>>(qmap, gmap, bmap, a, bias, dst, geo);
  return cudaGetLastError();
}

// The four launches (and the partials' sum when G > 1) of one call.
// partial is (G, H, N, N) f32 scratch when G > 1, else unused.
template <int HD, class BiasT>
cudaError_t launch_hd(const BwdArgs<bf16>& a, const BiasT* bias, float* partial, int G,
                      int stat_passes, cudaStream_t stream) {
  CUtensorMap qmap, gmap;
  const long D = (long)a.H * HD;
  cudaError_t e = encode_rows<HD>(&qmap, a.qkv, 3 * D, a.N, a.W, kCols);
  if (e == cudaSuccess) e = encode_rows<HD>(&gmap, a.g, D, a.N, a.W, kCols);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const Geometry geo(a.W, a.N, a.H, G);
  float* dst = G > 1 ? partial : a.dbias;
  e = stat_passes == 1 ? launch_mode<HD, kStats, BiasT, 1>(qmap, gmap, a, bias, dst, geo, sms, stream)
                       : launch_mode<HD, kStats, BiasT, 2>(qmap, gmap, a, bias, dst, geo, sms, stream);
  if (e != cudaSuccess) return e;
  if ((e = launch_mode<HD, kDkdv>(qmap, gmap, a, bias, dst, geo, sms, stream)) != cudaSuccess) return e;
  if ((e = launch_mode<HD, kDq>(qmap, gmap, a, bias, dst, geo, sms, stream)) != cudaSuccess) return e;
  if ((e = launch_mode<HD, kDbias>(qmap, gmap, a, bias, dst, geo, sms, stream)) != cudaSuccess) return e;
  if (G > 1) {
    const long n4 = (long)a.H * a.N * a.N / 4;
    const long blocks = (n4 + 255) / 256;
    dbias_reduce<<<(int)(blocks < 4 * sms ? blocks : 4 * sms), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(a.dbias), n4, G);
    e = cudaGetLastError();
  }
  return e;
}

// Entry of K4's, K5's and K7's bf16 calls: N a multiple of 64, hd 16, 32 or 64,
// 1 <= G <= W, qkv and g 16-byte aligned (validated by the wrapper).
// stat_passes 1 takes t in the same online pass as the row max and sum
// (rescaled with them; eleven N x N products a window and head), 2 in a
// second pass as attention_bwd.cuh does (twelve; K5's rounding, bit for
// bit: its d_qkv, and d_bias when G = 1).
template <class BiasT>
cudaError_t launch(const BwdArgs<bf16>& a, const BiasT* bias, float* partial, int G, int hd,
                   int stat_passes, cudaStream_t stream) {
  if (stat_passes != 1 && stat_passes != 2) return cudaErrorInvalidValue;
  GG_HEAD_DIM_SWITCH(hd, { return launch_hd<HD>(a, bias, partial, G, stat_passes, stream); })
}

}  // namespace bwd90
}  // namespace gg
