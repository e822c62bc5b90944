// The Hopper (sm_90a) forward core of the bf16 window attentions K8a and
// K8b (attention_headmajor.cu) and K3 (attention_qkv.cu):
//
//     out[w, h] = softmax(q[w, h] k[w, h]^T * scale + bias[h]) v[w, h]
//
// over 64-row q-tiles of N = 64 C tokens, with bf16 q, k, v and out and a
// head dim HD of 16, 32 or 64.  Two template choices make the three
// kernels:
//
//   LAYOUT  kHeadMajor: q, k, v and out (W, H, N, HD), read through one
//           tensor map each over (W H, N, HD) rows (K8a, K8b);
//           kQkv: q|k|v of head h at columns [3 h HD, 3 (h + 1) HD) of the
//           interleaved (W, N, 3D) qkv, read through one tensor map in boxes
//           of (HD, 64 rows) at column (3 h + slot) HD, as the backward core
//           (attention_bwd_sm90.cuh) reads it; out (W, N, D), head h at
//           columns [h HD, (h + 1) HD) (K3).
//   BiasT   the (H, N, N) bias element: f32 (K8a, K8b, the JAX kernels'
//           f32 bias) or bf16 (K3, the bias in the activations' dtype as
//           _attention_qkv_fused_pallas casts it), added in f32.
//
// Numerics: f32 scores plus the bias in f32, the softmax in f32, p rounded
// to bf16 before the p.v product, f32 accumulation.  Where a chunk is the
// whole score row (N <= 256) the softmax is the JAX kernels' own
// (_qtiled_kernel, _qkv_fused_kernel): the max over the whole row, p
// normalised before it is rounded.  Above, chunks of key tiles run the
// online softmax, and p is rounded relative to the running max, not the
// final one: a few bf16 ulps.
//
// The design (K8b's Hopper kernel, now shared):
//   * Persistent blocks of 384 threads, one an SM, walk items (64-query
//     tile, window group, head), the q-tile fastest, so the blocks of one
//     (group, head) run side by side and read each window's k and v from
//     device memory once and from L2 after.
//   * Two consumer warpgroups, each fed by its own producer warp through
//     its q buffers and a ring of 64-key k and v tiles, all loaded by TMA
//     with the swizzle of one head row, each slot with a full and an empty
//     mbarrier.  The producer warpgroup gives its registers to the
//     consumers (setmaxnreg).
//   * s = q k^T is wgmma.m64n64k16 from shared memory over a chunk of NT
//     tiles; o += p v is wgmma with bf16 p in registers and the v tile read
//     MN-major.  Every tile of a chunk is waited for before its first
//     product: a wait between two products is a branch that makes ptxas
//     serialise them (C7519/C7520).
//   * The bias comes in by TMA in boxes of 64 rows of 128 bytes (32 f32 or
//     64 bf16 columns) with the 128-byte swizzle, which spreads each warp's
//     reads over the banks.  Two ways, by what fits in a block's 227 KB
//     (make_plan):
//       resident  the item's 64 x N bias tile, loaded once and read for
//                 every window of the group (window_attention.
//                 _headmajor_groups), the consumer groups taking the windows
//                 in turns; a second buffer takes the next item's tile when
//                 it fits.  K8b, K3 (a bf16 tile of N = 1024 is 128 KB) and
//                 K8a where its f32 tile fits (N up to 704 at hd 32).
//       streamed  the tile does not fit (K8a's f32 tile at N = 1024 is 256
//                 KB): items of at most four windows, each consumer group
//                 taking two at once, and one ring of bias chunks (NT = 2
//                 key tiles, 128 keys: 32 KB in f32) loaded by the first
//                 producer warp beside the k and v tiles and read by both
//                 groups for all four windows before it is released.  A
//                 group issues both windows' score products at once, so
//                 that one window's softmax runs while the tensor cores
//                 compute the other's scores or p.v (attend_chunk_pair).
//
// What bounds K8a at stage 2 of a serving bucket of 16 (W=64, H=12,
// N=1024, HD=32, f32 bias) on an H100, and what the design does about it:
//
//   term                       amount        time
//   q, k, v, out               201 MB        0.060 ms at 3.35 TB/s
//   bias                       50.3 MB       0.015 ms
//   the two products           1.03e11 flop  0.104 ms at the bf16 peak
//   exponentials               8.05e8        ~0.2 ms at 16 MUFU.EX2 a clock an SM
//
// The first design read the bias once per (window, q-tile, head) block:
// 64 x 50.3 MB, ~3.2 GB of L2 reads.  A resident bias chunk here serves
// the four windows of an item, so that falls to ~0.8 GB, moved by TMA.
// What is left is the work of a score (~7 instructions: the bias read and
// add, the max, the exponential's FMA and MUFU, the sum, the bf16 pack) on
// two consumer warps a scheduler, and the k and v tiles each q-tile reads
// again from L2 (16 KB a window and chunk beside the bias's 8 KB).  K3 at stage 3 (W=64, N=256, H=18) is
// K8b's stage-3 shape with half the bias bytes: 1008 items of 14-window
// groups, the whole row at once.
//
// Every output element is computed by one thread in an order fixed by the
// shape, so two calls are bitwise the same on any card.
//
// Everything here has internal linkage (the unnamed namespace below): the
// libraries of both including files keep their own launchers and their
// own opt-in flags.  A function-local static of a function with external
// linkage is one GNU-unique object across the libraries of a process.
#pragma once

#include "sm90.cuh"

namespace gg {
namespace fwd90 {
namespace {

using namespace sm90;

enum Layout { kHeadMajor = 0, kQkv = 1 };

constexpr int kRows = 64;                   // query rows of an item; rows of a k or v tile
constexpr int kConsumers = 256;             // two consumer warpgroups,
constexpr int kThreads = kConsumers + 128;  // then the producer warpgroup
// registers a thread after setmaxnreg: the block's 168 x 384 at launch,
// redistributed (56 x 128 + 224 x 256; 40 left the producer warps
// spilling, and a sum above the launch's allocation never completes)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kBoxBytes = kRows * 128;  // a bias box: 64 rows of 128 bytes
constexpr int kMaxSlots = 16;           // k/v slots of a group's ring, at most
constexpr int kSmemMax = 232448;        // what a block may opt in to (227 KB)
constexpr int kStreamWindows = 2;       // windows a consumer group takes at once, streamed
constexpr int kStreamTiles = 2;         // key tiles of a streamed bias chunk (when C is even)

// The bias element as the boxes hold it.
template <class BiasT>
struct BiasBox {
  static constexpr int kElem = (int)sizeof(BiasT);
  static constexpr int kCols = 128 / kElem;       // columns a box
  static constexpr int kPerTile = kRows / kCols;  // boxes a 64-key tile
  static constexpr int kPairs = kCols / 8;        // a thread's column pairs in a box row
  static constexpr CUtensorMapDataType kType =
      kElem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

__device__ __forceinline__ float2 bias_pair(const uint8_t* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias_pair(const uint8_t* p, bf16) {
  return widen2(*reinterpret_cast<const uint32_t*>(p));
}

// The work of one call and its shared memory, from (W, H, N, G), the head
// dim and the bias element alone.
struct Plan {
  int W, H, N, G;
  int C;       // 64-key tiles of N (= 64-query tiles)
  int NT;      // key tiles a chunk of the score row
  int NB;      // bias buffers: the resident tile (2: the next item's too), or the streamed ring's slots
  int QB;      // q buffers of each consumer group
  int S;       // k/v slots of each consumer group's ring
  int tile;    // bytes of a 64-row bf16 tile
  int bias;    // bytes of a bias buffer: the 64 x N tile, or a 64 x 64 NT chunk
  int stream;  // 1: the bias streamed by chunks

  __host__ __device__ long items() const { return (long)C * G * H; }

  // Item `it` -> its head, q-tile and windows [w0, w1).  The q-tile is
  // fastest, so the blocks in flight share the windows' k and v in L2.
  __device__ void decode(int it, int& h, int& qt, int& w0, int& w1) const {
    qt = it % C;
    it /= C;
    const int grp = it % G;
    h = it / G;
    w0 = (int)((long)grp * W / G);
    w1 = (int)((long)(grp + 1) * W / G);
  }

  __host__ __device__ int barrier_bytes() const { return 8 * (2 * NB + 2 * (2 * QB + 2 * S)); }
  int smem_bytes() const { return 1024 + NB * bias + 2 * (QB + S) * tile + barrier_bytes(); }
};

// The largest of 4, 3, 2, 1 tiles that divides the C key tiles: the whole
// row in one chunk up to N = 256.
int chunk_tiles(int C) { return C % 4 == 0 ? 4 : C % 3 == 0 ? 3 : C % 2 == 0 ? 2 : 1; }

// The k/v slots a group's ring gets beside NB bias buffers, at most
// kMaxSlots; the plan holds when there are enough (need).
bool fit_ring(Plan* p, int nb, int need) {
  p->NB = nb;
  p->S = kMaxSlots;
  const int room = kSmemMax - 1024 - p->barrier_bytes() - nb * p->bias;
  int slots = room / (2 * p->tile) - p->QB;  // less each group's q buffers
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (slots < need) return false;
  p->S = slots;
  return true;
}

// The resident plan when the item's bias tile fits: two bias buffers when
// they fit beside a ring of two chunks, else one beside a chunk's k tiles.
// Else, when may_stream, the streamed plan: window groups of at most
// kStreamWindows per consumer group (G = ceil(W / 4), whatever G was
// given), chunks of kStreamTiles tiles (1 when C is odd), a ring that
// holds a chunk's k and v tiles of both windows of a group, two bias slots
// when they fit.
cudaError_t make_plan(Plan* p, int W, int H, int N, int G, int hd, int bias_elem,
                      bool may_stream) {
  p->W = W;
  p->H = H;
  p->N = N;
  p->G = G;
  p->C = N / kRows;
  p->tile = kRows * hd * 2;
  p->stream = 0;
  p->QB = 2;
  p->NT = chunk_tiles(p->C);
  p->bias = kRows * N * bias_elem;
  if (fit_ring(p, 2, 2 * p->NT) || fit_ring(p, 1, p->NT)) return cudaSuccess;
  if (!may_stream) return cudaErrorInvalidValue;
  p->stream = 1;
  p->G = (W + 2 * kStreamWindows - 1) / (2 * kStreamWindows);
  p->QB = 2 * kStreamWindows;
  p->NT = p->C % kStreamTiles == 0 ? kStreamTiles : 1;
  p->bias = kRows * kRows * p->NT * bias_elem;
  const int need = 2 * kStreamWindows * p->NT;  // both windows' k and v tiles of a chunk
  if (fit_ring(p, 2, need) || fit_ring(p, 1, need)) return cudaSuccess;
  return cudaErrorInvalidValue;
}

// The shared memory of a block: the NB bias buffers at the 1024-aligned
// base, then each consumer group's QB q buffers and S ring slots, then the
// mbarriers: the bias buffers' full and empty, then each group's q full, q
// empty, slot full and slot empty.  The tile size and QB are constants of
// the kernel (the plan's QB is the same: make_plan).
template <int HD, bool STREAM>
struct Smem {
  static constexpr int QB = STREAM ? 2 * kStreamWindows : 2;
  static constexpr int kTile = kRows * HD * 2;
  uint32_t base, groups0, bars;
  int NB, S, bias;

  __device__ Smem(const Plan& p, uint32_t base_) : base(base_), NB(p.NB), S(p.S), bias(p.bias) {
    groups0 = base + NB * bias;
    bars = groups0 + 2 * (QB + S) * kTile;
  }
  __device__ uint32_t bias_buf(int b) const { return base + b * bias; }
  __device__ uint32_t bias_full(int b) const { return bars + 8 * b; }
  __device__ uint32_t bias_empty(int b) const { return bars + 8 * (NB + b); }  // the 8 consumer warps
  __device__ uint32_t q_buf(int c, int i) const { return groups0 + (c * (QB + S) + i) * kTile; }
  __device__ uint32_t slot(int c, int s) const { return groups0 + (c * (QB + S) + QB + s) * kTile; }
  __device__ uint32_t gbar(int c) const { return bars + 16 * NB + c * 8 * (2 * QB + 2 * S); }
  __device__ uint32_t q_full(int c, int i) const { return gbar(c) + 8 * i; }
  __device__ uint32_t q_empty(int c, int i) const { return gbar(c) + 8 * (QB + i); }  // the group's 4 warps
  __device__ uint32_t full(int c, int s) const { return gbar(c) + 16 * QB + 8 * s; }
  __device__ uint32_t empty(int c, int s) const {  // the group's 4 warps
    return gbar(c) + 16 * QB + 8 * S + 8 * s;
  }
};

__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x in one instruction (MUFU.EX2; exp2f adds a range check and two
// multiplies around it).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A producer's load of the next slot of a ring: waits for its release once
// every slot has been filled, then one TMA load of `bytes` completing on
// the slot's full barrier.
struct Loader {
  RingPos pos;
  bool wrapped = false;
  __device__ __forceinline__ int take(uint32_t empty_bar, int slots) {
    const int s = pos.slot;
    if (wrapped) mbar_wait(empty_bar, pos.phase ^ 1);
    pos.next(slots);
    wrapped = wrapped || pos.slot == 0;
    return s;
  }
};

// The softmax step of one chunk on its scores s (NT 64-key tiles of a
// consumer thread's two rows): s * scale + bias in f32, the update of the
// running max m, sum l and output o, and p rounded to bf16 as the A
// fragments pa of the p.v product.  bchunk holds the chunk's bias
// columns, a box of kCols columns each kBoxBytes; boff are this thread's
// byte offsets in a box (row lr0; row lr0 + 8 is 1024 bytes further, in
// the same swizzle phase).  whole: the chunk is the whole row, so p is
// normalised before it is rounded.
//
// Accumulator layout of a consumer thread (warp w of its group, lane =
// 4g + c), as mma.sync's C fragment in each 8-column tile t: d[4t + 0..1]
// = row 16w + g, columns 8t + 2c + 0..1; d[4t + 2..3] = row 16w + g + 8.
template <int HD, int NT, class BiasT>
__device__ __forceinline__ void softmax_chunk(float (&s)[NT][32], const uint8_t* bchunk,
                                              const uint32_t (&boff)[BiasBox<BiasT>::kPairs],
                                              float scale, bool whole, float (&o)[HD / 2], float& m0,
                                              float& m1, float& l0, float& l1,
                                              uint32_t (&pa)[NT][4][4]) {
  using B = BiasBox<BiasT>;
  // s * scale + bias in f32, then the max over the chunk's columns (four
  // partial maxima and sums a row, so that no chain of dependent
  // instructions runs the length of the row)
  float pm0[4], pm1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) pm0[u] = pm1[u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint8_t* bp = bchunk + (j * B::kPerTile + t / B::kPairs) * kBoxBytes + boff[t % B::kPairs];
      const float2 b0 = bias_pair(bp, BiasT());
      const float2 b1 = bias_pair(bp + 8 * 128, BiasT());
      float* x = &s[j][4 * t];
      x[0] = fmaf(x[0], scale, b0.x);
      x[1] = fmaf(x[1], scale, b0.y);
      x[2] = fmaf(x[2], scale, b1.x);
      x[3] = fmaf(x[3], scale, b1.y);
      pm0[t % 4] = fmaxf(pm0[t % 4], fmaxf(x[0], x[1]));
      pm1[t % 4] = fmaxf(pm1[t % 4], fmaxf(x[2], x[3]));
    }
  float mx0 = fmaxf(fmaxf(pm0[0], pm0[1]), fmaxf(pm0[2], pm0[3]));
  float mx1 = fmaxf(fmaxf(pm1[0], pm1[1]), fmaxf(pm1[2], pm1[3]));
  mx0 = fmaxf(max4(mx0), m0);
  mx1 = fmaxf(max4(mx1), m1);
  // exp(x - max) as exp2 of one FMA; the rescale of what the earlier
  // chunks summed (0 at the first)
  const float n0 = mx0 * kLog2e, n1 = mx1 * kLog2e;
  const float al0 = ex2(fmaf(m0, kLog2e, -n0)), al1 = ex2(fmaf(m1, kLog2e, -n1));
  m0 = mx0;
  m1 = mx1;
  float ps0[4] = {0.f, 0.f, 0.f, 0.f}, ps1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float* x = &s[j][4 * t];
      x[0] = ex2(fmaf(x[0], kLog2e, -n0));
      x[1] = ex2(fmaf(x[1], kLog2e, -n0));
      x[2] = ex2(fmaf(x[2], kLog2e, -n1));
      x[3] = ex2(fmaf(x[3], kLog2e, -n1));
      ps0[t % 4] += x[0] + x[1];
      ps1[t % 4] += x[2] + x[3];
    }
  l0 = l0 * al0 + sum4((ps0[0] + ps0[1]) + (ps0[2] + ps0[3]));
  l1 = l1 * al1 + sum4((ps1[0] + ps1[1]) + (ps1[2] + ps1[3]));
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) {
    o[4 * t + 0] *= al0;
    o[4 * t + 1] *= al0;
    o[4 * t + 2] *= al1;
    o[4 * t + 3] *= al1;
  }
  // p in bf16: normalised first when the chunk is the whole row
  const float il0 = whole ? 1.f / l0 : 1.f, il1 = whole ? 1.f / l1 : 1.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[j][4 * t + 0] *= il0;
      s[j][4 * t + 1] *= il0;
      s[j][4 * t + 2] *= il1;
      s[j][4 * t + 3] *= il1;
    }
    pack_a(s[j], pa[j]);
  }
}

// One chunk of NT 64-key tiles of one window's 64 query rows: s = q k^T,
// the softmax step, then o += bf16(p) v.  The chunk's NT k tiles, then its
// NT v tiles, are the next 2 NT slots of group c's ring; `last` releases
// the q tile after the score products.
template <int HD, int NT, class BiasT, class SM>
__device__ __forceinline__ void attend_chunk(const SM& sm, int c, uint64_t dq, const uint8_t* bchunk,
                                             const uint32_t (&boff)[BiasBox<BiasT>::kPairs],
                                             RingPos& ring, bool whole, bool last, uint32_t q_empty,
                                             float scale, float (&o)[HD / 2], float& m0, float& m1,
                                             float& l0, float& l1) {
  const int S = sm.S;
  // s = q k^T over the chunk's tiles.  Every tile is waited for before
  // the first product: a wait between two products is a branch that
  // makes ptxas serialise them.
  uint64_t dk[NT];
  RingPos at_k = ring;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mbar_wait(sm.full(c, at_k.slot), at_k.phase);
    dk[j] = desc<HD>(sm.slot(c, at_k.slot));
    at_k.next(S);
  }
  float s[NT][32];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    zero(s[j]);
    fence_regs(s[j]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_m64n64k16_ss(s[j], dq + 2 * kk, dk[j] + 2 * kk);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    fence_regs(s[j]);
    release(sm.empty(c, ring.slot));
    ring.next(S);
  }
  if (last) release(q_empty);

  uint32_t pa[NT][4][4];
  softmax_chunk<HD, NT, BiasT>(s, bchunk, boff, scale, whole, o, m0, m1, l0, l1, pa);

  // o += p v over the chunk's tiles, waited for first as above
  uint64_t dv[NT];
  RingPos at_v = ring;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mbar_wait(sm.full(c, at_v.slot), at_v.phase);
    dv[j] = desc<HD>(sm.slot(c, at_v.slot));
    at_v.next(S);
  }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j) wgmma_k64_rs<HD>(o, pa[j], dv[j]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    release(sm.empty(c, ring.slot));
    ring.next(S);
  }
}

// The streamed path's chunk for both windows of a consumer group at once
// (the producer loads each window's k tiles, then its v tiles): every tile
// is waited for first, then both score products are issued; window 0's
// softmax runs while the tensor cores compute window 1's scores, and
// window 1's while they compute window 0's p.v.  Nothing between the first
// product and the last wait branches (ptxas serialises wgmma in flight
// across a branch: C7518), so the slots and, after the last chunk, the q
// tiles are released at the end.  The ring holds the 4 NT tiles together.
template <int HD, int NT, class BiasT, class SM>
__device__ __forceinline__ void attend_chunk_pair(const SM& sm, int c,
                                                  const uint64_t (&dq)[kStreamWindows],
                                                  const uint8_t* bchunk,
                                                  const uint32_t (&boff)[BiasBox<BiasT>::kPairs],
                                                  RingPos& ring, bool last,
                                                  const uint32_t (&q_empty)[kStreamWindows],
                                                  float scale, float (&o)[kStreamWindows][HD / 2],
                                                  float (&m)[kStreamWindows][2],
                                                  float (&l)[kStreamWindows][2]) {
  static_assert(kStreamWindows == 2, "two windows a consumer group");
  const int S = sm.S;
  // window i's k tiles are the NT slots from ring + 2 i NT, its v tiles the
  // NT after; every one waited for here, its descriptor made at its product
  RingPos at = ring;
#pragma unroll
  for (int x = 0; x < 4 * NT; ++x) {
    mbar_wait(sm.full(c, at.slot), at.phase);
    at.next(S);
  }
  auto tile = [&](int x) {  // the descriptor of the ring's x-th next slot
    const int s = ring.slot + x;
    return desc<HD>(sm.slot(c, s < S ? s : s - S));
  };
  float s0[NT][32], s1[NT][32];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    zero(s0[j]);
    zero(s1[j]);
    fence_regs(s0[j]);
    fence_regs(s1[j]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_m64n64k16_ss(s0[j], dq[0] + 2 * kk, tile(j) + 2 * kk);
  wgmma_commit();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n64k16_ss(s1[j], dq[1] + 2 * kk, tile(2 * NT + j) + 2 * kk);
  wgmma_commit();

  wgmma_wait<1>();  // window 0's scores
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(s0[j]);
  uint32_t pa0[NT][4][4];
  softmax_chunk<HD, NT, BiasT>(s0, bchunk, boff, scale, false, o[0], m[0][0], m[0][1], l[0][0],
                               l[0][1], pa0);
  fence_regs(o[0]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j) wgmma_k64_rs<HD>(o[0], pa0[j], tile(NT + j));
  wgmma_commit();

  wgmma_wait<1>();  // window 1's scores
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(s1[j]);
  uint32_t pa1[NT][4][4];
  softmax_chunk<HD, NT, BiasT>(s1, bchunk, boff, scale, false, o[1], m[1][0], m[1][1], l[1][0],
                               l[1][1], pa1);
  fence_regs(o[1]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j) wgmma_k64_rs<HD>(o[1], pa1[j], tile(3 * NT + j));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o[0]);
  fence_regs(o[1]);

#pragma unroll
  for (int x = 0; x < 4 * NT; ++x) {
    release(sm.empty(c, ring.slot));
    ring.next(S);
  }
  if (last) {
    release(q_empty[0]);
    release(q_empty[1]);
  }
}

// Query rows `row`, row + 8 of window w, head h: o scaled by f0 and f1,
// rounded to bf16.
template <int LAYOUT, int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const Plan& p, int w, int h, int row,
                                           int cc, const float (&o)[HD / 2], float f0, float f1) {
  const long ld = LAYOUT == kQkv ? (long)p.H * HD : HD;  // elements between two rows of out
  const long r0 = LAYOUT == kQkv ? ((long)w * p.N + row) * ld + h * HD
                                 : ((long)(w * p.H + h) * p.N + row) * HD;
  bf16* orow0 = out + r0 + 2 * cc;
  bf16* orow1 = orow0 + 8 * ld;
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) {
    *reinterpret_cast<uint32_t*>(orow0 + 8 * t) = pack_bf16(o[4 * t + 0] * f0, o[4 * t + 1] * f0);
    *reinterpret_cast<uint32_t*>(orow1 + 8 * t) = pack_bf16(o[4 * t + 2] * f1, o[4 * t + 3] * f1);
  }
}

// Threads 0-255 are the two consumer warpgroups; warp 8 of the producer
// warpgroup loads group 0's tiles and the bias, warp 9 group 1's tiles.
template <int LAYOUT, class BiasT, int HD, int NT, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap bias_map, bf16* __restrict__ out, const Plan p,
                   float scale) {
  using B = BiasBox<BiasT>;
  constexpr int T = kRows * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const Smem<HD, STREAM> sm(p, (raw + 1023) & ~1023u);
  // the generic address of a shared one
  auto at = [&](uint32_t saddr) { return smem_raw + (saddr - raw); };
  // the tensor maps' column and outer coordinates of slot 0 (q), 1 (k) or
  // 2 (v) of window w, head h
  auto col = [&](int slot, int h) { return LAYOUT == kQkv ? (3 * h + slot) * HD : 0; };
  auto outer = [&](int w, int h) { return LAYOUT == kQkv ? w : w * p.H + h; };
  const int items = (int)p.items();  // below 2^31 (run)
  const int C = p.C;

  if (threadIdx.x == 0) {
    for (int b = 0; b < p.NB; ++b) {
      mbar_init(sm.bias_full(b), 1);
      mbar_init(sm.bias_empty(b), 8);
    }
    for (int c = 0; c < 2; ++c) {
      for (int i = 0; i < sm.QB; ++i) {
        mbar_init(sm.q_full(c, i), 1);
        mbar_init(sm.q_empty(c, i), 4);
      }
      for (int s = 0; s < p.S; ++s) {
        mbar_init(sm.full(c, s), 1);
        mbar_init(sm.empty(c, s), 4);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int c = (threadIdx.x - kConsumers) / 32;  // the group this warp feeds
    if (c < 2 && (threadIdx.x & 31) == 0) {
      Loader kv;  // the group's k/v ring
      // k and v tiles of one chunk of window w, head h: its k tiles, then its v tiles
      auto load_chunk = [&](int k0, int w, int h) {
        for (int src = 0; src < 2; ++src)
          for (int j = 0; j < NT; ++j) {
            const int s = kv.take(sm.empty(c, kv.pos.slot), p.S);
            mbar_expect_tx(sm.full(c, s), T);
            tma_load(sm.slot(c, s), src ? &v_map : &k_map, sm.full(c, s), col(1 + src, h),
                     (k0 + j) * kRows, outer(w, h));
          }
      };
      if constexpr (STREAM) {
        Loader qs, bs;  // the group's q buffers; the bias ring (group 0's warp)
        for (int it = blockIdx.x; it < items; it += gridDim.x) {
          int h, qt, w0, w1;
          p.decode(it, h, qt, w0, w1);
          int win[kStreamWindows];  // a window past the group's end repeats its last, unstored
#pragma unroll
          for (int i = 0; i < kStreamWindows; ++i) {
            win[i] = min(w0 + c + 2 * i, w1 - 1);
            const int s = qs.take(sm.q_empty(c, qs.pos.slot), sm.QB);
            mbar_expect_tx(sm.q_full(c, s), T);
            tma_load(sm.q_buf(c, s), &q_map, sm.q_full(c, s), col(0, h), qt * kRows, outer(win[i], h));
          }
          for (int k0 = 0; k0 < C; k0 += NT) {
            if (c == 0) {
              const int b = bs.take(sm.bias_empty(bs.pos.slot), p.NB);
              mbar_expect_tx(sm.bias_full(b), p.bias);
              for (int x = 0; x < NT * B::kPerTile; ++x)
                tma_load(sm.bias_buf(b) + x * kBoxBytes, &bias_map, sm.bias_full(b),
                         k0 * kRows + x * B::kCols, qt * kRows, h);
            }
#pragma unroll
            for (int i = 0; i < kStreamWindows; ++i) load_chunk(k0, win[i], h);
          }
        }
      } else {
        int bi = 0, qn = 0;  // items and q tiles loaded: ring positions
        for (int it = blockIdx.x; it < items; it += gridDim.x, ++bi) {
          int h, qt, w0, w1;
          p.decode(it, h, qt, w0, w1);
          if (c == 0) {
            const int b = bi % p.NB;
            if (bi >= p.NB) mbar_wait(sm.bias_empty(b), ((bi / p.NB) - 1) & 1);
            mbar_expect_tx(sm.bias_full(b), p.bias);
            for (int x = 0; x < p.N / B::kCols; ++x)
              tma_load(sm.bias_buf(b) + x * kBoxBytes, &bias_map, sm.bias_full(b), x * B::kCols,
                       qt * kRows, h);
          }
          for (int w = w0 + c; w < w1; w += 2, ++qn) {
            const int qb = qn & 1;
            if (qn >= 2) mbar_wait(sm.q_empty(c, qb), ((qn >> 1) - 1) & 1);
            mbar_expect_tx(sm.q_full(c, qb), T);
            tma_load(sm.q_buf(c, qb), &q_map, sm.q_full(c, qb), col(0, h), qt * kRows, outer(w, h));
            for (int k0 = 0; k0 < C; k0 += NT) load_chunk(k0, w, h);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, cc = lane & 3;
    const int lr0 = warp * 16 + g;  // this thread's rows lr0, lr0 + 8 of the q-tile
    // the byte offsets in a bias box of this thread's pairs at columns
    // 8u + 2cc, row lr0
    uint32_t boff[B::kPairs];
#pragma unroll
    for (int u = 0; u < B::kPairs; ++u) boff[u] = swizzle128(lr0, (8 * u + 2 * cc) * B::kElem);
    RingPos ring;  // the group's next k/v tile

    if constexpr (STREAM) {
      RingPos qpos, bpos;  // the group's next q buffer; the next bias chunk
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int h, qt, w0, w1;
        p.decode(it, h, qt, w0, w1);
        uint64_t dq[kStreamWindows];
        uint32_t q_empty[kStreamWindows];
        float o[kStreamWindows][HD / 2];
        float m[kStreamWindows][2], l[kStreamWindows][2];  // running max and row sum
#pragma unroll
        for (int i = 0; i < kStreamWindows; ++i) {
          mbar_wait(sm.q_full(c, qpos.slot), qpos.phase);
          dq[i] = desc<HD>(sm.q_buf(c, qpos.slot));
          q_empty[i] = sm.q_empty(c, qpos.slot);
          qpos.next(sm.QB);
          zero(o[i]);
          m[i][0] = m[i][1] = -INFINITY;
          l[i][0] = l[i][1] = 0.f;
        }
        for (int k0 = 0; k0 < C; k0 += NT) {
          mbar_wait(sm.bias_full(bpos.slot), bpos.phase);
          const uint8_t* bchunk = at(sm.bias_buf(bpos.slot));
          attend_chunk_pair<HD, NT, BiasT>(sm, c, dq, bchunk, boff, ring, k0 + NT >= C, q_empty,
                                           scale, o, m, l);
          release(sm.bias_empty(bpos.slot));
          bpos.next(p.NB);
        }
#pragma unroll
        for (int i = 0; i < kStreamWindows; ++i) {
          const int w = w0 + c + 2 * i;
          if (w < w1)
            store_rows<LAYOUT, HD>(out, p, w, h, qt * kRows + lr0, cc, o[i], 1.f / l[i][0],
                                   1.f / l[i][1]);
        }
      }
    } else {
      const bool whole = C == NT;  // one chunk: the whole score row at once
      int bi = 0, qn = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++bi) {
        int h, qt, w0, w1;
        p.decode(it, h, qt, w0, w1);
        const int b = bi % p.NB;
        // waited for even with no window of this item, so that the group's
        // release below counts toward this item's phase
        mbar_wait(sm.bias_full(b), (bi / p.NB) & 1);
        const uint8_t* btile = at(sm.bias_buf(b));
        for (int w = w0 + c; w < w1; w += 2, ++qn) {
          const int qb = qn & 1;
          mbar_wait(sm.q_full(c, qb), (qn >> 1) & 1);
          const uint64_t dq = desc<HD>(sm.q_buf(c, qb));
          float o[HD / 2];
          zero(o);
          float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // running max and row sum
          for (int k0 = 0; k0 < C; k0 += NT)
            attend_chunk<HD, NT, BiasT>(sm, c, dq, btile + k0 * B::kPerTile * kBoxBytes, boff, ring,
                                        whole, k0 + NT >= C, sm.q_empty(c, qb), scale, o, m0, m1, l0,
                                        l1);
          const float f0 = whole ? 1.f : 1.f / l0, f1 = whole ? 1.f : 1.f / l1;
          store_rows<LAYOUT, HD>(out, p, w, h, qt * kRows + lr0, cc, o, f0, f1);
        }
        release(sm.bias_empty(b));
      }
    }
  }
}

template <int LAYOUT, class BiasT, int HD, int NT, bool STREAM>
cudaError_t launch_nt(const CUtensorMap (&maps)[4], bf16* out, const Plan& p, float scale, int sms,
                      cudaStream_t stream) {
  static bool opted_in = false;  // one per instance, and this library's own
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(attention_fwd_sm90<LAYOUT, BiasT, HD, NT, STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const long items = p.items();
  const int grid = (int)(items < sms ? items : sms);
  attention_fwd_sm90<LAYOUT, BiasT, HD, NT, STREAM><<<grid, kThreads, p.smem_bytes(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, p, scale);
  return cudaGetLastError();
}

// One call.  kHeadMajor: q, k, v and out (W, H, N, HD); kQkv: q = k = v
// the (W, N, 3 H HD) qkv and out (W, N, H HD).  The bias (H, N, N).  Each
// contiguous with a 16-byte aligned base (the wrapper's _headmajor_layout
// or _qkv_layout); N a multiple of 64; 1 <= G <= W.  MAY_STREAM: take the
// streamed plan where the resident one does not fit, else return
// cudaErrorInvalidValue there.
template <int LAYOUT, class BiasT, int HD, bool MAY_STREAM>
cudaError_t run(const void* q, const void* k, const void* v, const void* bias, void* out, int W,
                int H, int N, int G, float scale, cudaStream_t stream) {
  using B = BiasBox<BiasT>;
  Plan p;
  cudaError_t e = make_plan(&p, W, H, N, G, HD, B::kElem, MAY_STREAM);
  if (e != cudaSuccess) return e;
  if (p.items() > 0x7fffffffL) return cudaErrorInvalidValue;  // the kernel counts items in int
  // q, k, v in boxes of (HD, 64 rows); the bias in boxes of 64 rows of
  // kCols columns, swizzled over their 128 bytes
  CUtensorMap maps[4];
  if (LAYOUT == kQkv) {
    e = encode_rows<HD>(&maps[0], q, 3L * H * HD, N, W, kRows);
    maps[1] = maps[0];
    maps[2] = maps[0];
  } else {
    const long slabs = (long)W * H;
    const void* rows[3] = {q, k, v};
    for (int i = 0; i < 3 && e == cudaSuccess; ++i)
      e = encode_rows<HD>(&maps[i], rows[i], HD, N, slabs, kRows);
  }
  if (e == cudaSuccess)
    e = encode_3d(&maps[3], B::kType, B::kElem, bias, N, N, H, B::kCols, kRows,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  bf16* o = static_cast<bf16*>(out);
  if constexpr (MAY_STREAM) {
    if (p.stream)
      return p.NT == 2 ? launch_nt<LAYOUT, BiasT, HD, 2, true>(maps, o, p, scale, sms, stream)
                       : launch_nt<LAYOUT, BiasT, HD, 1, true>(maps, o, p, scale, sms, stream);
  }
  switch (p.NT) {
    case 4: return launch_nt<LAYOUT, BiasT, HD, 4, false>(maps, o, p, scale, sms, stream);
    case 3: return launch_nt<LAYOUT, BiasT, HD, 3, false>(maps, o, p, scale, sms, stream);
    case 2: return launch_nt<LAYOUT, BiasT, HD, 2, false>(maps, o, p, scale, sms, stream);
    default: return launch_nt<LAYOUT, BiasT, HD, 1, false>(maps, o, p, scale, sms, stream);
  }
}

}  // namespace
}  // namespace fwd90
}  // namespace gg
