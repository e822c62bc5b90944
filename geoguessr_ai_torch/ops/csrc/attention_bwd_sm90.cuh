// The Hopper core of the window-attention backwards K4
// (attention_qkv_bwd.cu, the bias in the activations' type), K5
// (attention_bwd_merged.cu, an f32 bias, one window group) and K7
// (attention_bwd_qtiled.cu, an f32 bias), in two kinds: bf16 activations
// (attn_bwd_sm90) and f32 ones (attn_bwd_f32_sm90, "The f32 kind" below).
// It computes the function attention_bwd.cuh's head comment states: s in
// f32 from bf16 products plus the bias, the row softmax in f32, t =
// sum_row dp * p, ds = p * (dp - t), dv from bf16(p), dq and dk from
// bf16(ds) times scale, d_bias the f32 sum of ds over the windows; each
// d_qkv sum rounded to bf16 once (in f32: split products, nothing rounded).
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
//
// Two kinds of item, by ROWS (window_attention.BWD_Q_ROWS): 128 rows, the
// two consumer warpgroups on one item (the default), or 64 rows, each
// consumer warpgroup on items of its own.  In the 64-row kind a block runs
// two pipes: pipe p is fed by producer warp p through its own rings and
// barriers, walks items p, p + 2, .. of the block's share, and its one
// consumer warpgroup keeps the 128-row kind's register layout.  Where N
// pads to 64 (N = 49, TinyViT-5M-224), a 128-row item leaves its second
// warpgroup idle; two 64-row items keep both busy.  Built at hd 32.
#pragma once

#include <type_traits>

#include "attention_bwd.cuh"
#include "sm90.cuh"

namespace gg {
namespace bwd90 {

using namespace sm90;

enum Mode { kStats = 0, kDkdv = 1, kDq = 2, kDbias = 3 };

constexpr int kRowsA = 128;    // row-side rows of the default item: two consumer warpgroups of 64
constexpr int kCols = 64;      // column-side rows of a step
constexpr int kConsumers = 256;             // two consumer warpgroups,
constexpr int kThreads = kConsumers + 128;  // then the producer warpgroup
// registers a thread after setmaxnreg: 168 at launch (64K over 384
// threads), the producer's 128 given to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory of one launch, from a 1024-byte aligned base: each pipe's
// kRowBufs row slots, each pipe's kStages column slots, then each pipe's
// mbarriers.
template <int HD, int MODE, class BiasT, int ROWS = kRowsA>
struct Smem {
  static constexpr int kPipes = kRowsA / ROWS;        // item streams of a block: 1, or 2 of 64 rows
  static constexpr int kHalf = kCols * HD * 2;        // 64 rows of one tensor
  static constexpr int kRowTiles = ROWS / 64;         // 64-row tiles of a row-side tensor
  static constexpr int kRowStats = 2 * kRowTiles * kHalf;  // a row slot's statistics, after its tiles
  // two tensors of ROWS rows, m, 1/l, t of ROWS
  static constexpr int kRowBuf = kRowStats + 1024 * kRowTiles;
  // dbias walks units of one step each, so it keeps more rows in flight
  static constexpr int kRowBufs = MODE == kDbias ? 4 : 2;
  static constexpr int kStatBytes = 3 * kCols * 4;    // m, 1/l, t of 64 queries (dkdv)
  // the step's bias tile, 128 rows x 64 columns (128 keys x 64 queries in
  // dkdv), in boxes of 128-byte rows written with the 128-byte swizzle;
  // dbias reads its tile once an item, into registers
  static constexpr bool kBiasTile = MODE != kDbias;
  static constexpr int kBoxElems = 128 / (int)sizeof(BiasT);
  static constexpr int kBiasOffset = 2 * kHalf + 1024;
  static constexpr int kStage = kBiasOffset + (kBiasTile ? ROWS * kCols * (int)sizeof(BiasT) : 0);
  static constexpr int kFit = (216 * 1024 - 1024 - kPipes * kRowBufs * kRowBuf) / (kPipes * kStage);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static_assert(kStages >= 3, "a ring of at least three column slots");
  static constexpr int kColsOffset = kPipes * kRowBufs * kRowBuf;
  static constexpr int kBarOffset = kColsOffset + kPipes * kStages * kStage;
  static constexpr int kPipeBars = 16 * (kRowBufs + kStages);  // a pipe's full and empty barriers
  static constexpr int kBytes = 1024 + kBarOffset + kPipes * kPipeBars;
};

// The work of one launch: its items and how an item decodes.
struct Geometry {
  int W, N, H, G;
  int R, C;  // row tiles (of the item's rows) and 64-row tiles of N

  __host__ __device__ Geometry(int W_, int N_, int H_, int G_, int rows = kRowsA)
      : W(W_), N(N_), H(H_), G(G_), R((N_ + rows - 1) / rows), C(N_ / kCols) {}

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
template <int MODE, class BiasT, int ROWS>
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
        const uint8_t* p = tile + (col / kBox) * (ROWS * 128) + swizzle128(row, (col % kBox) * E);
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
// into the hd columns at `out` of rows r0 and r0 + 8 (row pitch ld), in
// out's type (bf16, or f32 in the f32 kind).
template <int HD, class E>
__device__ __forceinline__ void store_rows(E* out, long ld, const float (&d)[HD / 2], float sc,
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
// PASSES (stats only): over the key tiles, 1 or 2 (see launch).  ROWS: the
// item's rows, 128 (one pipe, both consumer warpgroups) or 64 (two pipes,
// one consumer warpgroup each; producer warp p feeds pipe p).
template <int HD, int MODE, class BiasT, int PASSES, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_sm90(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap g_map,
              const __grid_constant__ CUtensorMap bias_map, BwdArgs<bf16> a,
              const BiasT* __restrict__ bias, float* __restrict__ dbias_dst, Geometry geo) {
  using S = Smem<HD, MODE, BiasT, ROWS>;
  constexpr int kRowBufs = S::kRowBufs, kStages = S::kStages;
  constexpr int kPipes = S::kPipes, kRowTiles = S::kRowTiles;
  constexpr int kPipeWarps = 8 / kPipes;  // the consumer warps that release a pipe's slots
  // dq and dbias read the row side's statistics, dkdv the column side's
  constexpr bool kRowStats = MODE == kDq || MODE == kDbias;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // pipe pp: row slot b at rows0 + b * kRowBuf, column slot s at cols0 + s
  // * kStage, barriers full_row + 8 b, empty_row (released by the pipe's
  // consumer warps), full_col + 8 s, empty_col
  auto rows0_of = [&](int pp) { return base + pp * kRowBufs * S::kRowBuf; };
  auto cols0_of = [&](int pp) { return base + S::kColsOffset + pp * kStages * S::kStage; };
  auto full_row_of = [&](int pp) { return base + S::kBarOffset + pp * S::kPipeBars; };
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
    for (int pp = 0; pp < kPipes; ++pp) {
      const uint32_t full_row = full_row_of(pp), empty_row = full_row + 8 * kRowBufs;
      const uint32_t full_col = empty_row + 8 * kRowBufs, empty_col = full_col + 8 * kStages;
      for (int b = 0; b < kRowBufs; ++b) {
        mbar_init(full_row + 8 * b, 1);
        mbar_init(empty_row + 8 * b, kPipeWarps);
      }
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full_col + 8 * s, 1);
        mbar_init(empty_col + 8 * s, kPipeWarps);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread a pipe issues every load of its pipe
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pp = (threadIdx.x - kConsumers) / 32;
    if (pp < kPipes && (threadIdx.x & 31) == 0) {
      const uint32_t rows0 = rows0_of(pp), cols0 = cols0_of(pp);
      const uint32_t full_row = full_row_of(pp), empty_row = full_row + 8 * kRowBufs;
      const uint32_t full_col = empty_row + 8 * kRowBufs, empty_col = full_col + 8 * kStages;
      int ru = 0, cs = 0;  // row and column slots filled so far: the ring positions
      for (int it = blockIdx.x * kPipes + pp; it < items; it += gridDim.x * kPipes) {
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
        // rows of the tile below N: ROWS, or 64 for the last when N % 128 == 64
        const int live = N - rt * ROWS < ROWS ? N - rt * ROWS : ROWS;
        const int halves = live / 64;
        // the bias boxes of a step: dkdv's hold kBoxElems keys of the row
        // tile each (those wholly past N are not loaded), the others
        // kBoxElems columns of all ROWS rows
        const int boxes = MODE == kDkdv ? live / S::kBoxElems : kCols / S::kBoxElems;
        const int box_bytes = MODE == kDkdv ? kCols * 128 : ROWS * 128;
        for (int w = w0; w < w1; ++w, ++ru) {
          const int rb = ru % kRowBufs;
          if (ru >= kRowBufs) mbar_wait(empty_row + 8 * rb, ((ru / kRowBufs) - 1) & 1);
          const uint32_t dst = rows0 + rb * S::kRowBuf, bar = full_row + 8 * rb;
          mbar_expect_tx(bar, halves * (2 * S::kHalf + (kRowStats ? 3 * 64 * 4 : 0)));
          for (int hf = 0; hf < halves; ++hf) {
            tma_load(dst + hf * S::kHalf, &qkv_map, bar, a1, rt * ROWS + hf * 64, w);
            tma_load(dst + (kRowTiles + hf) * S::kHalf, a2map, bar, a2, rt * ROWS + hf * 64, w);
          }
          if (kRowStats) {
            const float* st0 = a.stats + stat_index(a, w, h, rt * ROWS);
#pragma unroll
            for (int p = 0; p < 3; ++p)
              bulk_load(dst + S::kRowStats + p * ROWS * 4, st0 + p * plane, halves * 64 * 4, bar);
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
                if (MODE == kDkdv)  // keys rt*ROWS + b*kBoxElems.., queries j*64..
                  tma_load(bdst + b * box_bytes, &bias_map, cbar, rt * ROWS + b * S::kBoxElems,
                           j * kCols, h);
                else  // columns j*64 + b*kBoxElems.., rows rt*ROWS..
                  tma_load(bdst + b * box_bytes, &bias_map, cbar, j * kCols + b * S::kBoxElems,
                           rt * ROWS, h);
              }
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int pp = (threadIdx.x / 128) / (2 / kPipes);  // this warpgroup's pipe
    const int cg = (threadIdx.x / 128) % (2 / kPipes);  // rows 64 cg .. of each row tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int lr0 = cg * 64 + warp * 16 + g;  // this thread's rows lr0, lr0 + 8 of a row tile
    const uint32_t rows0 = rows0_of(pp), cols0 = cols0_of(pp);
    const uint32_t full_row = full_row_of(pp), empty_row = full_row + 8 * kRowBufs;
    const uint32_t full_col = empty_row + 8 * kRowBufs, empty_col = full_col + 8 * kStages;
    const long ld = 3L * H * HD;
    const float scale = a.scale;
    // this warp is done with a slot
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int ru = 0, cs = 0;
    for (int it = blockIdx.x * kPipes + pp; it < items; it += gridDim.x * kPipes) {
      int h, rt, ct, w0, w1;
      geo.decode(MODE, it, h, rt, ct, w0, w1);
      const int r0 = rt * ROWS + lr0;  // this thread's rows r0, r0 + 8
      // rows >= N (the second half of the last tile when N % 128 == 64):
      // the group keeps the barrier protocol but computes nothing
      const bool active = rt * ROWS + cg * 64 < N;
      float acc[32];  // dbias: the sum of ds over the group's windows
      float bt[32];   // dbias: the bias of the item's tile
      zero(acc);
      if (MODE == kDbias && active) bias_from_memory(bt, bias, h, N, r0, ct * kCols, c);

      for (int w = w0; w < w1; ++w, ++ru) {
        const int rb = ru % kRowBufs;
        const uint32_t arow = rows0 + rb * S::kRowBuf + cg * S::kHalf;
        const uint64_t da1 = desc<HD>(arow), da2 = desc<HD>(arow + kRowTiles * S::kHalf);
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
          il0 = rs[ROWS + lr0];
          il1 = rs[ROWS + lr0 + 8];
          t0 = rs[2 * ROWS + lr0];
          t1 = rs[2 * ROWS + lr0 + 8];
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
              bias_from_tile<MODE, BiasT, ROWS>(bs, at(bcol + S::kBiasOffset), lr0, c);
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
template <int HD, int MODE, class BiasT, int PASSES = 1, int ROWS = kRowsA>
static cudaError_t launch_mode(const CUtensorMap& qmap, const CUtensorMap& gmap, const BwdArgs<bf16>& a,
                        const BiasT* bias, float* dst, const Geometry& geo, int sms,
                        cudaStream_t stream) {
  using S = Smem<HD, MODE, BiasT, ROWS>;
  static bool opted_in = false;  // one per instance
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_sm90<HD, MODE, BiasT, PASSES, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kBytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  // the bias (H, N, N) in boxes of 128-byte rows: 128 rows of a row tile,
  // or (dkdv) 64 queries of a column tile; dbias reads it directly
  CUtensorMap bmap = qmap;
  if (S::kBiasTile) {
    const cudaError_t e = encode_3d(&bmap, map_type<BiasT>(), sizeof(BiasT), bias, a.N, a.N, a.H,
                                    S::kBoxElems, MODE == kDkdv ? kCols : ROWS,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
  }
  const long items = geo.items(MODE);
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;  // the kernel counts items in int
  // a block runs S::kPipes items at once
  const long blocks = (items + S::kPipes - 1) / S::kPipes;
  const int grid = (int)(blocks < sms ? blocks : sms);
  attn_bwd_sm90<HD, MODE, BiasT, PASSES, ROWS>
      <<<grid, kThreads, S::kBytes, stream>>>(qmap, gmap, bmap, a, bias, dst, geo);
  return cudaGetLastError();
}

// The four launches (and the partials' sum when G > 1) of one call.
// partial is (G, H, N, N) f32 scratch when G > 1, else unused.
template <int HD, class BiasT, int ROWS = kRowsA>
cudaError_t launch_hd(const BwdArgs<bf16>& a, const BiasT* bias, float* partial, int G,
                      int stat_passes, cudaStream_t stream) {
  CUtensorMap qmap, gmap;
  const long D = (long)a.H * HD;
  cudaError_t e = encode_rows<HD>(&qmap, a.qkv, 3 * D, a.N, a.W, kCols);
  if (e == cudaSuccess) e = encode_rows<HD>(&gmap, a.g, D, a.N, a.W, kCols);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const Geometry geo(a.W, a.N, a.H, G, ROWS);
  float* dst = G > 1 ? partial : a.dbias;
  e = stat_passes == 1
          ? launch_mode<HD, kStats, BiasT, 1, ROWS>(qmap, gmap, a, bias, dst, geo, sms, stream)
          : launch_mode<HD, kStats, BiasT, 2, ROWS>(qmap, gmap, a, bias, dst, geo, sms, stream);
  if (e != cudaSuccess) return e;
  if ((e = launch_mode<HD, kDkdv, BiasT, 1, ROWS>(qmap, gmap, a, bias, dst, geo, sms, stream)) !=
      cudaSuccess)
    return e;
  if ((e = launch_mode<HD, kDq, BiasT, 1, ROWS>(qmap, gmap, a, bias, dst, geo, sms, stream)) !=
      cudaSuccess)
    return e;
  if ((e = launch_mode<HD, kDbias, BiasT, 1, ROWS>(qmap, gmap, a, bias, dst, geo, sms, stream)) !=
      cudaSuccess)
    return e;
  if (G > 1) {
    const long n4 = (long)a.H * a.N * a.N / 4;
    const long blocks = (n4 + 255) / 256;
    dbias_reduce<<<(int)(blocks < 4 * sms ? blocks : 4 * sms), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(a.dbias), n4, G);
    e = cudaGetLastError();
  }
  return e;
}

// The head dim the 64-row kind is built for: every TinyViT stage's.
constexpr int kRows64HeadDim = 32;

// Entry of K4's, K5's and K7's bf16 calls: N a multiple of 64, hd 16, 32 or 64,
// 1 <= G <= W, qkv and g 16-byte aligned (validated by the wrapper).
// stat_passes 1 takes t in the same online pass as the row max and sum
// (rescaled with them; eleven N x N products a window and head), 2 in a
// second pass as attention_bwd.cuh does (twelve; K5's rounding, bit for
// bit: its d_qkv, and d_bias when G = 1).  rows: the items' rows, 128, or
// 64 at hd 32 (the kind is built there only).
template <class BiasT>
cudaError_t launch(const BwdArgs<bf16>& a, const BiasT* bias, float* partial, int G, int hd,
                   int stat_passes, cudaStream_t stream, int rows = kRowsA) {
  if (stat_passes != 1 && stat_passes != 2) return cudaErrorInvalidValue;
  if (rows == 64) {
    if (hd != kRows64HeadDim) return cudaErrorInvalidValue;
    return launch_hd<kRows64HeadDim, BiasT, 64>(a, bias, partial, G, stat_passes, stream);
  }
  if (rows != kRowsA) return cudaErrorInvalidValue;
  GG_HEAD_DIM_SWITCH(hd, { return launch_hd<HD>(a, bias, partial, G, stat_passes, stream); })
}

// The plan of one call without a launch, for the wrapper's mirror
// (window_attention._bwd_smem): for each launch in the order stats, dkdv,
// dq, dbias its shared memory bytes (out[0..3]), items (out[4..7]; the
// launch refuses more than 2^31 - 1) and column slots (out[8..11]).
template <int HD, class BiasT, int ROWS>
void plan_of(const Geometry& geo, int* out) {
  const int bytes[4] = {Smem<HD, kStats, BiasT, ROWS>::kBytes, Smem<HD, kDkdv, BiasT, ROWS>::kBytes,
                        Smem<HD, kDq, BiasT, ROWS>::kBytes, Smem<HD, kDbias, BiasT, ROWS>::kBytes};
  const int stages[4] = {Smem<HD, kStats, BiasT, ROWS>::kStages,
                         Smem<HD, kDkdv, BiasT, ROWS>::kStages, Smem<HD, kDq, BiasT, ROWS>::kStages,
                         Smem<HD, kDbias, BiasT, ROWS>::kStages};
  for (int m = 0; m < 4; ++m) {
    const long items = geo.items(m);
    out[m] = bytes[m];
    out[4 + m] = (int)(items < 0x7fffffffL ? items : 0x7fffffffL);
    out[8 + m] = stages[m];
  }
}

template <class BiasT>
cudaError_t plan(int W, int N, int H, int G, int hd, int rows, int* out) {
  const Geometry geo(W, N, H, G, rows);
  if (rows == 64) {
    if (hd != kRows64HeadDim) return cudaErrorInvalidValue;
    plan_of<kRows64HeadDim, BiasT, 64>(geo, out);
    return cudaSuccess;
  }
  if (rows != kRowsA) return cudaErrorInvalidValue;
  GG_HEAD_DIM_SWITCH(hd, {
    plan_of<HD, BiasT, kRowsA>(geo, out);
    return cudaSuccess;
  })
}

// ---------------------------------------------------------------------------
// The f32 kind: qkv, g and d_qkv f32, the bias and d_bias f32.
//
// The same four launches over the same items (128-row ones only) as the
// bf16 kind, with the first design's f32 numerics: every product splits
// its operands into bf16 pairs hi = bf16(x), lo = bf16(x - hi) and sums
// lo.hi + hi.lo + hi.hi in the f32 accumulator (three wgmma for one, about
// 2^-17 of error a product); p and ds are split, not rounded; each d_qkv
// sum is stored in f32.  d_bias is summed per window group in the order
// the bf16 kind takes (K4, K7: _bwd_groups; K5: one group), with no
// atomics, so every output is bitwise the same from run to run, and K5
// and K7 at one group run the same launches (t in a second pass).
//
// wgmma reads bf16 operands, and TMA copies without converting, so the
// split happens on the chip between the two.  What a step needs and where
// it lives:
//   * the item's row side (q and g, or k and v in dkdv: two tensors of 128
//     rows) lands in f32 by TMA in one row slot (two in dbias, whose items
//     take one step a window); each consumer thread splits its rows into
//     the A fragments of its products, in registers for the whole item, and
//     releases the slot at once, so the next item's rows load meanwhile;
//   * a step's column side (k and v, or q and g: 64 rows each) lands in f32
//     by TMA in one of kF32Lands landing slots; the producer warpgroup's
//     three idle warps split it into a column slot as a bf16 hi and a bf16
//     lo tile each, written in the swizzled layout the bf16 kind's TMA
//     writes (so the score products read it K-major and the dv, dk, dq
//     products MN-major, as there), and arrive on the slot's full barrier
//     beside the TMA of its bias tile and (dkdv) statistics;
//   * the score products take A from registers (wgmma's register-A form,
//     B K-major), the others p or ds split in registers, as in bf16.
// An f32 column slot holds four bf16 tiles where the bf16 kind's holds
// two, the row side is twice the bytes, and the f32 bias tile is 32 KB,
// so the layout gives up the row side's second slot (outside dbias) and,
// where that still leaves under two column slots (hd 64), the bias tile:
// the consumers then read the bias from device memory.  Each consumer
// step waits for its products before its algebra (one register set).
// ---------------------------------------------------------------------------

constexpr int kF32Lands = 2;      // landing slots of the column side
constexpr int kSplitWarps = 3;    // producer warps 1-3 split; warp 0 issues the TMA
constexpr int kF32ProducerRegs = 56;
constexpr int kF32ConsumerRegs = 224;  // 56 x 128 + 224 x 256 <= 64K
constexpr int kF32BiasBytes = kRowsA * kCols * 4;  // the step's f32 bias tile

// Bytes of the f32 kind's pieces at head dim hd, and the column slots that
// fit beside `row_bufs` row slots with or without the bias tile.
constexpr int f32_tile(int hd) { return kCols * hd * 4; }  // 64 rows of a tensor in f32
constexpr int f32_row_buf(int hd) { return 2 * (kRowsA / 64) * f32_tile(hd) + 1024 * (kRowsA / 64); }
constexpr int f32_stage(int hd, bool bias) { return 4 * kCols * hd * 2 + 1024 + (bias ? kF32BiasBytes : 0); }
constexpr int f32_fit(int hd, int row_bufs, bool bias) {
  return (216 * 1024 - 1024 - row_bufs * f32_row_buf(hd) - kF32Lands * 2 * f32_tile(hd)) /
         f32_stage(hd, bias);
}

// Shared memory of one f32 launch, from a 1024-byte aligned base: the row
// slots (a1 rows 0-63, 64-127, a2 rows 0-63, 64-127 in f32, then m, 1/l, t
// of the 128 rows), the landing slots (b1, b2 in f32), the column slots
// (b1 hi, b1 lo, b2 hi, b2 lo in bf16, the 64 queries' statistics, the
// bias tile), then the mbarriers.
template <int HD, int MODE>
struct SmemF32 {
  static constexpr int kTile = f32_tile(HD);
  static constexpr int kHalf = kCols * HD * 2;  // 64 rows of a tensor in bf16
  static constexpr int kRowStats = 2 * (kRowsA / 64) * kTile;
  static constexpr int kRowBuf = f32_row_buf(HD);
  static constexpr int kRowBufs = MODE == kDbias && f32_fit(HD, 2, false) >= 2 ? 2 : 1;
  static constexpr bool kBiasTile = MODE != kDbias && f32_fit(HD, kRowBufs, true) >= 2;
  static constexpr int kLand = 2 * kTile;
  static constexpr int kStatOffset = 4 * kHalf;
  static constexpr int kStatBytes = 3 * kCols * 4;
  static constexpr int kBiasOffset = kStatOffset + 1024;
  static constexpr int kStage = f32_stage(HD, kBiasTile);
  static constexpr int kFit = f32_fit(HD, kRowBufs, kBiasTile);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static_assert(kStages >= 2, "a ring of at least two column slots");
  static constexpr int kLandOffset = kRowBufs * kRowBuf;
  static constexpr int kColsOffset = kLandOffset + kF32Lands * kLand;
  static constexpr int kBarOffset = kColsOffset + kStages * kStage;
  static constexpr int kBytes = 1024 + kBarOffset + 16 * (kRowBufs + kF32Lands + kStages);
};

// The A fragments of the thread's rows of an f32 row tile (p: row lr of
// the tile, pitch HD; rows lr and lr + 8), split: k-step kk covers dims
// 16 kk .. 16 kk + 15, in mma.sync's A layout.
template <int HD>
__device__ __forceinline__ void row_frags(uint32_t (&hi)[HD / 16][4], uint32_t (&lo)[HD / 16][4],
                                          const float* p, int c) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const float* r0 = p + 16 * kk + 2 * c;
    const float* r1 = r0 + 8 * HD;
    const Frag<float> f[4] = {frag(r0), frag(r1), frag(r0 + 8), frag(r1 + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[kk][i] = f[i].hi;
      lo[kk][i] = f[i].lo;
    }
  }
}

// A 64 x 64 f32 accumulator split as the A fragments of the 4 k-steps of a
// product over its 64 columns (pack_a's layout).
__device__ __forceinline__ void split_a(const float (&x)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Frag<float> f = split_pair(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
      hi[kk][i] = f.hi;
      lo[kk][i] = f.lo;
    }
}

// d (64 x 64) += A . B^T over HD dims, A split in registers, B the hi tile
// at b_hi and its lo tile kHalf after it (K-major): lo.hi + hi.lo + hi.hi
// each k-step.
template <int HD>
__device__ __forceinline__ void split_scores(float (&d)[32], const uint32_t (&ah)[HD / 16][4],
                                             const uint32_t (&al)[HD / 16][4], uint32_t b_hi) {
  constexpr uint32_t kHalf = kCols * HD * 2;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t bh = desc<HD>(b_hi) + 2 * kk, bl = desc<HD>(b_hi + kHalf) + 2 * kk;
    wgmma_m64n64k16_rs<0>(d, al[kk], bh);
    wgmma_m64n64k16_rs<0>(d, ah[kk], bl);
    wgmma_m64n64k16_rs<0>(d, ah[kk], bh);
  }
}

// d (64 x HD) += A . B over the 64 rows of a column tile, A split in
// registers, B's hi tile at b_hi and lo tile kHalf after it (MN-major).
template <int HD>
__device__ __forceinline__ void split_k64(float (&d)[HD / 2], const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4], uint32_t b_hi) {
  constexpr uint32_t kHalf = kCols * HD * 2;
  wgmma_k64_rs<HD>(d, al, desc<HD>(b_hi));
  wgmma_k64_rs<HD>(d, ah, desc<HD>(b_hi + kHalf));
  wgmma_k64_rs<HD>(d, ah, desc<HD>(b_hi));
}

// The bias at the thread's accumulator elements of dkdv's transposed tile
// (rows key0 and key0 + 8 are keys, columns queries q0 ..) from device
// memory, where the f32 kind keeps no bias tile.
__device__ __forceinline__ void bias_from_memory_t(float (&b)[32], const float* __restrict__ bias, int h,
                                                   int N, int key0, int q0, int c) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + 8 * (i >> 1), q = q0 + 8 * t + 2 * c + (i & 1);
      b[4 * t + i] = bias[((long)h * N + q) * N + key];
    }
}

// One splitter thread's share (thread t of kSplitWarps * 32) of `tensors`
// 64-row f32 tiles at `land` into their bf16 hi and lo tiles at `slot`:
// tile i's hi at slot + 2 i kHalf, its lo kHalf after.  A bf16 tile's byte
// at linear offset o (row r at r * 2 HD) sits at o with its 16-byte chunk
// index XORed with bits 7.. of o, as TMA's swizzle over 2 HD bytes writes
// it (128, 64 or 32 B: Swizzled<HD>).
template <int HD>
__device__ __forceinline__ void split_tiles(const uint8_t* land, uint8_t* slot, int tensors, int t) {
  constexpr int kChunks = kCols * HD / 4;     // float4 chunks of a 64-row f32 tile
  constexpr int kHalf = kCols * HD * 2;
  constexpr int kMask = Swizzled<HD>::kRowBytes / 16 - 1;
  for (int i = t; i < tensors * kChunks; i += kSplitWarps * 32) {
    const int tensor = i / kChunks, ch = i % kChunks;
    const float4 v = reinterpret_cast<const float4*>(land)[i];
    const uint32_t h0 = pack_bf16(v.x, v.y), h1 = pack_bf16(v.z, v.w);
    const float2 a = unpack_bf16(h0), b = unpack_bf16(h1);
    const uint32_t l0 = pack_bf16(v.x - a.x, v.y - a.y), l1 = pack_bf16(v.z - b.x, v.w - b.y);
    const int lin = ch * 8;  // the chunk's 4 bf16 values: row ch / (HD / 4)
    uint8_t* dst = slot + tensor * 2 * kHalf + (lin ^ (((lin >> 7) & kMask) << 4));
    *reinterpret_cast<uint2*>(dst) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(dst + kHalf) = make_uint2(l0, l1);
  }
}

// Thread roles as in attn_bwd_sm90 (ROWS = 128, one pipe), except that
// producer warp 0's lane 0 issues every TMA load and producer warps 1-3
// split the landed column tiles.  PASSES (stats only): 1 or 2.
template <int HD, int MODE, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_f32_sm90(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap g_map,
                  const __grid_constant__ CUtensorMap bias_map, BwdArgs<float> a,
                  const float* __restrict__ bias, float* __restrict__ dbias_dst, Geometry geo) {
  using S = SmemF32<HD, MODE>;
  constexpr int kRowBufs = S::kRowBufs, kStages = S::kStages;
  constexpr bool kRowStats = MODE == kDq || MODE == kDbias;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t rows0 = base, lands0 = base + S::kLandOffset, cols0 = base + S::kColsOffset;
  const uint32_t full_row = base + S::kBarOffset, empty_row = full_row + 8 * kRowBufs;
  const uint32_t full_land = empty_row + 8 * kRowBufs, empty_land = full_land + 8 * kF32Lands;
  const uint32_t full_col = empty_land + 8 * kF32Lands, empty_col = full_col + 8 * kStages;
  auto at = [&](uint32_t saddr) { return smem_raw + (saddr - raw); };

  const int N = a.N, H = a.H;
  const long plane = (long)a.W * H * N;
  const int items = (int)geo.items(MODE);  // below 2^31 (launch_mode_f32)
  const int steps = MODE == kDbias ? 1 : MODE == kStats ? PASSES * geo.C : geo.C;
  auto scores_only = [&](int s) { return MODE == kStats && PASSES == 2 && s < geo.C; };

  if (threadIdx.x == 0) {
    for (int b = 0; b < kRowBufs; ++b) {
      mbar_init(full_row + 8 * b, 1);
      mbar_init(empty_row + 8 * b, 8);
    }
    for (int l = 0; l < kF32Lands; ++l) {
      mbar_init(full_land + 8 * l, 1);
      mbar_init(empty_land + 8 * l, kSplitWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_col + 8 * s, 1 + kSplitWarps);  // the TMA thread and the splitters
      mbar_init(empty_col + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    const int pw = (threadIdx.x - kConsumers) / 32;
    if (pw == 0) {
      if ((threadIdx.x & 31) != 0) return;
      int ru = 0, ls = 0, cs = 0;  // row, landing and column slots filled so far
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int h, rt, ct, w0, w1;
        geo.decode(MODE, it, h, rt, ct, w0, w1);
        const int qc = h * 3 * HD;
        // row side: q and g, or k and v (dkdv); column side: k and v, or q and g
        const int a1 = MODE == kDkdv ? qc + HD : qc;
        const int a2 = MODE == kDkdv ? qc + 2 * HD : h * HD;
        const CUtensorMap* a2map = MODE == kDkdv ? &qkv_map : &g_map;
        const int b1 = MODE == kDkdv ? qc : qc + HD;
        const int b2 = MODE == kDkdv ? h * HD : qc + 2 * HD;
        const CUtensorMap* b2map = MODE == kDkdv ? &g_map : &qkv_map;
        const int live = N - rt * kRowsA < kRowsA ? N - rt * kRowsA : kRowsA;
        const int halves = live / 64;
        // the bias boxes of 32 f32 columns (dkdv: 32 keys of the row tile,
        // those wholly past N not loaded)
        const int boxes = MODE == kDkdv ? live / 32 : kCols / 32;
        const int box_bytes = MODE == kDkdv ? kCols * 128 : kRowsA * 128;
        for (int w = w0; w < w1; ++w, ++ru) {
          const int rb = ru % kRowBufs;
          if (ru >= kRowBufs) mbar_wait(empty_row + 8 * rb, ((ru / kRowBufs) - 1) & 1);
          const uint32_t dst = rows0 + rb * S::kRowBuf, bar = full_row + 8 * rb;
          mbar_expect_tx(bar, halves * (2 * S::kTile + (kRowStats ? 3 * 64 * 4 : 0)));
          for (int hf = 0; hf < halves; ++hf) {
            tma_load(dst + hf * S::kTile, &qkv_map, bar, a1, rt * kRowsA + hf * 64, w);
            tma_load(dst + (2 + hf) * S::kTile, a2map, bar, a2, rt * kRowsA + hf * 64, w);
          }
          if (kRowStats) {
            const float* st0 = a.stats + stat_index(a, w, h, rt * kRowsA);
#pragma unroll
            for (int p = 0; p < 3; ++p)
              bulk_load(dst + S::kRowStats + p * kRowsA * 4, st0 + p * plane, halves * 64 * 4, bar);
          }
          for (int s = 0; s < steps; ++s, ++ls, ++cs) {
            const int j = MODE == kDbias ? ct : s % geo.C;
            const bool both = !scores_only(s);
            const int l = ls % kF32Lands;
            if (ls >= kF32Lands) mbar_wait(empty_land + 8 * l, ((ls / kF32Lands) - 1) & 1);
            const uint32_t ldst = lands0 + l * S::kLand, lbar = full_land + 8 * l;
            mbar_expect_tx(lbar, (both ? 2 : 1) * S::kTile);
            tma_load(ldst, &qkv_map, lbar, b1, j * kCols, w);
            if (both) tma_load(ldst + S::kTile, b2map, lbar, b2, j * kCols, w);
            const int st = cs % kStages;
            if (cs >= kStages) mbar_wait(empty_col + 8 * st, ((cs / kStages) - 1) & 1);
            const uint32_t cdst = cols0 + st * S::kStage, cbar = full_col + 8 * st;
            const uint32_t tx = (MODE == kDkdv ? S::kStatBytes : 0) + (S::kBiasTile ? boxes * box_bytes : 0);
            if (tx) mbar_expect_tx(cbar, tx);
            else mbar_arrive(cbar);
            if (MODE == kDkdv) {
              const float* st0 = a.stats + stat_index(a, w, h, j * kCols);
#pragma unroll
              for (int p = 0; p < 3; ++p)
                bulk_load(cdst + S::kStatOffset + p * kCols * 4, st0 + p * plane, kCols * 4, cbar);
            }
            if (S::kBiasTile) {
              const uint32_t bdst = cdst + S::kBiasOffset;
              for (int b = 0; b < boxes; ++b) {
                if (MODE == kDkdv)  // keys rt*128 + b*32.., queries j*64..
                  tma_load(bdst + b * box_bytes, &bias_map, cbar, rt * kRowsA + b * 32, j * kCols, h);
                else  // columns j*64 + b*32.., rows rt*128..
                  tma_load(bdst + b * box_bytes, &bias_map, cbar, j * kCols + b * 32, rt * kRowsA, h);
              }
            }
          }
        }
      }
    } else {
      // the splitters walk the same steps as the TMA thread
      const int t = threadIdx.x - kConsumers - 32;
      int ls = 0, cs = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int h, rt, ct, w0, w1;
        geo.decode(MODE, it, h, rt, ct, w0, w1);
        for (int w = w0; w < w1; ++w) {
          for (int s = 0; s < steps; ++s, ++ls, ++cs) {
            const int l = ls % kF32Lands, st = cs % kStages;
            mbar_wait(full_land + 8 * l, (ls / kF32Lands) & 1);
            if (cs >= kStages) mbar_wait(empty_col + 8 * st, ((cs / kStages) - 1) & 1);
            split_tiles<HD>(at(lands0 + l * S::kLand), at(cols0 + st * S::kStage), scores_only(s) ? 1 : 2,
                            t);
            fence_proxy_async();  // the tiles written, for the consumers' wgmma
            release(empty_land + 8 * l);
            release(full_col + 8 * st);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));
    const int cg = threadIdx.x / 128;  // rows 64 cg .. of each row tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int lr0 = cg * 64 + warp * 16 + g;  // this thread's rows lr0, lr0 + 8 of a row tile
    const long ld = 3L * H * HD;
    const float scale = a.scale;

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
        const uint32_t rbuf = rows0 + rb * S::kRowBuf;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
        float il0 = 0.f, il1 = 0.f, t0 = 0.f, t1 = 0.f;
        uint32_t a1h[HD / 16][4], a1l[HD / 16][4], a2h[HD / 16][4], a2l[HD / 16][4];
        mbar_wait(full_row + 8 * rb, (ru / kRowBufs) & 1);
        if (active) {
          if (kRowStats) {
            const float* rs = reinterpret_cast<const float*>(at(rbuf + S::kRowStats));
            m0 = rs[lr0];
            m1 = rs[lr0 + 8];
            il0 = rs[kRowsA + lr0];
            il1 = rs[kRowsA + lr0 + 8];
            t0 = rs[2 * kRowsA + lr0];
            t1 = rs[2 * kRowsA + lr0 + 8];
          }
          const int lr = (warp * 16 + g) * HD;  // row lr0 of tile cg
          row_frags<HD>(a1h, a1l, reinterpret_cast<const float*>(at(rbuf + cg * S::kTile)) + lr, c);
          row_frags<HD>(a2h, a2l, reinterpret_cast<const float*>(at(rbuf + (2 + cg) * S::kTile)) + lr, c);
        }
        release(empty_row + 8 * rb);  // the rows are in registers

        if (!active) {
          // keep the ring's protocol: every column slot waited for and released
          for (int s = 0; s < steps; ++s, ++cs) {
            mbar_wait(full_col + 8 * (cs % kStages), (cs / kStages) & 1);
            release(empty_col + 8 * (cs % kStages));
          }
          continue;
        }
        float o1[HD / 2], o2[HD / 2];  // dq; or dk and dv (dkdv)
        zero(o1);
        zero(o2);
        for (int s = 0; s < steps; ++s, ++cs) {
          const int j = MODE == kDbias ? ct : s % geo.C;
          const int st = cs % kStages;
          mbar_wait(full_col + 8 * st, (cs / kStages) & 1);
          const uint32_t bcol = cols0 + st * S::kStage;
          float x[32], y[32];
          zero(x);
          zero(y);
          fence_regs(x);
          fence_regs(y);
          wgmma_fence();
          split_scores<HD>(x, a1h, a1l, bcol);
          if (!scores_only(s)) split_scores<HD>(y, a2h, a2l, bcol + 2 * S::kHalf);
          wgmma_commit();
          float bs[32];  // the step's bias, read while the products run
          if (MODE == kDbias) {
#pragma unroll
            for (int i = 0; i < 32; ++i) bs[i] = bt[i];
          } else if (S::kBiasTile) {
            bias_from_tile<MODE, float, kRowsA>(bs, at(bcol + S::kBiasOffset), lr0, c);
          } else if (MODE == kDkdv) {
            bias_from_memory_t(bs, bias, h, N, r0, j * kCols, c);
          } else {
            bias_from_memory(bs, bias, h, N, r0, j * kCols, c);
          }
          wgmma_wait<0>();
          fence_regs(x);
          fence_regs(y);

          if constexpr (MODE == kStats) {
            if (PASSES == 1 || s < geo.C) {
              // the running max and row sum; in one pass also u = the sum
              // of exp(s - m) dp, rescaled as the row sum is
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
              // dq += ds k
              uint32_t fh[4][4], fl[4][4];
              split_a(x, fh, fl);
              fence_regs(o1);
              wgmma_fence();
              split_k64<HD>(o1, fh, fl, bcol);
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(o1);
            }
          } else {  // dkdv: rows are keys, columns queries
            // m, 1/l and t of the 64 queries
            const float* sst = reinterpret_cast<const float*>(at(bcol + S::kStatOffset));
#pragma unroll
            for (int t = 0; t < 8; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int q = 8 * t + 2 * c + (i & 1);
                const float pr = __expf(x[4 * t + i] * scale + bs[4 * t + i] - sst[q]) * sst[kCols + q];
                x[4 * t + i] = pr;
                y[4 * t + i] = pr * (y[4 * t + i] - sst[2 * kCols + q]);
              }
            // dv += p^T g, dk += ds^T q
            uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
            split_a(x, ph, pl);
            split_a(y, dh, dl);
            fence_regs(o1);
            fence_regs(o2);
            wgmma_fence();
            split_k64<HD>(o2, ph, pl, bcol + 2 * S::kHalf);
            split_k64<HD>(o1, dh, dl, bcol);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o1);
            fence_regs(o2);
          }
          release(empty_col + 8 * st);
        }

        float* out = a.dqkv + ((long)w * N + r0) * ld + h * 3 * HD;
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

// static, as launch_mode: its opt-in flag must be this library's.
template <int HD, int MODE, int PASSES = 1>
static cudaError_t launch_mode_f32(const CUtensorMap& qmap, const CUtensorMap& gmap, const BwdArgs<float>& a,
                                   const float* bias, float* dst, const Geometry& geo, int sms,
                                   cudaStream_t stream) {
  using S = SmemF32<HD, MODE>;
  static bool opted_in = false;  // one per instance
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(attn_bwd_f32_sm90<HD, MODE, PASSES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  // the bias (H, N, N) in boxes of 128-byte rows (32 f32): 128 rows of a
  // row tile, or (dkdv) 64 queries of a column tile
  CUtensorMap bmap = qmap;
  if (S::kBiasTile) {
    const cudaError_t e = encode_3d(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias, a.N, a.N, a.H, 32,
                                    MODE == kDkdv ? kCols : kRowsA, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
  }
  const long items = geo.items(MODE);
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;  // the kernel counts items in int
  const int grid = (int)(items < sms ? items : sms);
  attn_bwd_f32_sm90<HD, MODE, PASSES><<<grid, kThreads, S::kBytes, stream>>>(qmap, gmap, bmap, a, bias, dst, geo);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_hd_f32(const BwdArgs<float>& a, const float* bias, float* partial, int G,
                                 int stat_passes, cudaStream_t stream) {
  // qkv and g in boxes of (HD, 64 rows) of f32, unswizzled: the splitters
  // and the consumers read them with plain loads
  CUtensorMap qmap, gmap;
  const long D = (long)a.H * HD;
  cudaError_t e = encode_3d(&qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.qkv, 3 * D, a.N, a.W, HD, kCols,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = encode_3d(&gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.g, D, a.N, a.W, HD, kCols,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const Geometry geo(a.W, a.N, a.H, G);
  float* dst = G > 1 ? partial : a.dbias;
  e = stat_passes == 1 ? launch_mode_f32<HD, kStats, 1>(qmap, gmap, a, bias, dst, geo, sms, stream)
                       : launch_mode_f32<HD, kStats, 2>(qmap, gmap, a, bias, dst, geo, sms, stream);
  if (e != cudaSuccess) return e;
  if ((e = launch_mode_f32<HD, kDkdv>(qmap, gmap, a, bias, dst, geo, sms, stream)) != cudaSuccess) return e;
  if ((e = launch_mode_f32<HD, kDq>(qmap, gmap, a, bias, dst, geo, sms, stream)) != cudaSuccess) return e;
  if ((e = launch_mode_f32<HD, kDbias>(qmap, gmap, a, bias, dst, geo, sms, stream)) != cudaSuccess) return e;
  if (G > 1) {
    const long n4 = (long)a.H * a.N * a.N / 4;
    const long blocks = (n4 + 255) / 256;
    dbias_reduce<<<(int)(blocks < 4 * sms ? blocks : 4 * sms), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(a.dbias), n4, G);
    e = cudaGetLastError();
  }
  return e;
}

// Entry of K4's, K5's and K7's f32 calls: the bf16 launch's contract (N a
// multiple of 64, hd 16, 32 or 64, 1 <= G <= W, qkv and g 16-byte
// aligned, validated by the wrapper), 128-row items only.
static inline cudaError_t launch(const BwdArgs<float>& a, const float* bias, float* partial, int G, int hd,
                                 int stat_passes, cudaStream_t stream) {
  if (stat_passes != 1 && stat_passes != 2) return cudaErrorInvalidValue;
  GG_HEAD_DIM_SWITCH(hd, { return launch_hd_f32<HD>(a, bias, partial, G, stat_passes, stream); })
}

// The f32 kind's plan without a launch, as plan fills out[12].
template <int HD>
void plan_of_f32(const Geometry& geo, int* out) {
  const int bytes[4] = {SmemF32<HD, kStats>::kBytes, SmemF32<HD, kDkdv>::kBytes, SmemF32<HD, kDq>::kBytes,
                        SmemF32<HD, kDbias>::kBytes};
  const int stages[4] = {SmemF32<HD, kStats>::kStages, SmemF32<HD, kDkdv>::kStages,
                         SmemF32<HD, kDq>::kStages, SmemF32<HD, kDbias>::kStages};
  for (int m = 0; m < 4; ++m) {
    const long items = geo.items(m);
    out[m] = bytes[m];
    out[4 + m] = (int)(items < 0x7fffffffL ? items : 0x7fffffffL);
    out[8 + m] = stages[m];
  }
}

static inline cudaError_t plan_f32(int W, int N, int H, int G, int hd, int rows, int* out) {
  if (rows != kRowsA) return cudaErrorInvalidValue;
  const Geometry geo(W, N, H, G);
  GG_HEAD_DIM_SWITCH(hd, {
    plan_of_f32<HD>(geo, out);
    return cudaSuccess;
  })
}

}  // namespace bwd90
}  // namespace gg
