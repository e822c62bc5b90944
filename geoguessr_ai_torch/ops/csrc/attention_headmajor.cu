// K8a and K8b: head-major window attention
//
//     out[w, h] = softmax(q[w, h] k[w, h]^T * scale + bias[h]) v[w, h]
//
// q, k, v, out (W, H, N, hd) bf16 (or f32, the _f32 twins) with hd 16, 32
// or 64, bias (H, N, N) f32.  Replaces the two
// Pallas kernels behind the JAX package's window_attention
// (geoguessr_ai_tpu/ops/window_attention.py): K8a _attention_qtiled
// (_qtiled_kernel), chosen at N >= 512 or when W is not a multiple of
// BLOCK_W, and K8b _attention_batched (_batched_kernel), BLOCK_W windows of
// one head per grid cell.  Numerics as there: f32 scores plus the f32 bias
// (unlike K1-K4, which round the bias to bf16), f32 softmax, p rounded to
// bf16 before the p.v product (split in f32), f32 accumulation.
//
// What bounds it on an H100: at stage 2 of a serving bucket of 16
// (W=64, H=12, N=1024) the 1.03e11 flops of the two products (0.104 ms at
// the bf16 peak); at stage 1 (W=1024, H=6, N=256) the 403 MB of q, k, v and
// out (0.120 ms at 3.35 TB/s).  Beside those sits the f32 bias: 50 MB at
// stage 2, the whole L2.  The Pallas grid (head, q-tile, window) keeps one
// (head, q-tile) bias block resident across the windows; a block per
// (window, head, q-tile) launched window-major would fetch it once per
// window, 64 x 50 MB.
//
// K8a (both types) and K8b's f32 twin run the first design: one core per
// 64-row q-tile, 4 warps of 16 query rows, k and v^T in tiles of 64 keys
// staged through shared memory by plain loads, the one-pass online softmax
// (running max and sum in f32, log2 domain) of common.cuh's
// window_attention_kernel on mma.sync.m16n8k16; K8a launches its blocks
// window-fastest (grid (W, N/64, H)) so that blocks scheduled together
// share one (head, q-tile)'s 64 x N f32 bias rows in L2, and K8b's twin
// stages a block's 64 bias rows in shared memory once for its BLOCK_W
// windows.  A row of N=1024 f32 scores does not fit beside the rest, as it
// did in VMEM, so there p is rounded relative to the running max, not the
// final one: a few bf16 ulps.
//
// K8b's bf16 entry (namespace hm90 below) is built from csrc/sm90.cuh's
// Hopper pieces.  At N < 512 the work is bytes and exponentials, not
// products: at stage 1, 403 MB against 0.12 ms, 4e8 exponentials against
// ~0.11 ms of the SMs' special-function units, 5e10 flops against 0.05 ms.
// So the design keeps every byte moving without a thread spending an
// instruction on it, and the exponentials and the softmax algebra of one
// warpgroup overlap the other's products:
//   * Persistent blocks of 384 threads, one an SM, walk items (64-query
//     tile, window group, head), the q-tile fastest, so the blocks of one
//     (group, head) run side by side and read each window's k and v from
//     device memory once and from L2 after.  The groups are a function of
//     (W, H, N) alone (window_attention._headmajor_groups); group i holds
//     windows [i W / G, (i + 1) W / G).
//   * The item's 64 x N f32 bias tile comes in once by TMA, in boxes of
//     128-byte rows with the 128-byte swizzle (unswizzled bias reads held
//     back the backward core, attention_bwd_sm90.cuh), and stays resident
//     while the block walks the group's windows; a second buffer takes the
//     next item's tile when shared memory has room for it.
//   * Two consumer warpgroups take the item's windows in turns, each with
//     its own producer warp and its own pipeline: q tiles through two
//     buffers, 64-key k and v tiles through a ring of slots, each with a
//     full and an empty mbarrier, all loaded by TMA through tensor maps
//     over the (W H, N, hd) rows with the swizzle of one head row.  The
//     producer warpgroup gives its registers to the consumers (setmaxnreg).
//   * s = q k^T is wgmma.m64n64k16 from shared memory, a chunk of up to
//     four 64-key tiles at once; o += p v is wgmma with bf16 p in registers
//     and the v tile read MN-major.  At N <= 256 a chunk is the whole score
//     row (128 f32 registers a thread), so the softmax is the JAX kernel's:
//     the max over the whole row, p normalised before it is rounded to
//     bf16.  At 256 < N < 512 the row does not fit beside the rest, and
//     chunks of 1 or 3 tiles (the largest that divides N / 64) run the
//     online softmax, p rounded relative to the running max.
// Every output element is computed by one thread in an order fixed by the
// shape, so calls are bitwise the same on any card.
#include "sm90.cuh"

namespace gg {
namespace {

constexpr int kBiasPad = 8;  // f32 pitch padding of K8b's staged bias rows

// The bias as each kernel reads it: a pair of f32 values of query row
// `row`, key columns col, col + 1.
struct GlobalBias {  // K8a: (N, N) of one head, in device memory
  const float* base;
  int ld;
  __device__ __forceinline__ float2 pair(int row, int col) const {
    return *reinterpret_cast<const float2*>(base + (long)row * ld + col);
  }
};

struct SharedBias {  // K8b: the block's 64 query rows, in shared memory
  const float* base;
  int ld, row0;
  __device__ __forceinline__ float2 pair(int row, int col) const {
    return *reinterpret_cast<const float2*>(base + (long)(row - row0) * ld + col);
  }
};

// One 64-row q-tile of one (window, head): q, k, v and out point at that
// pair's (N, HD) slab.
template <int HD, class E, class BIAS>
__device__ __forceinline__ void attend_tile(const E* __restrict__ q, const E* __restrict__ k,
                                            const E* __restrict__ v, E* __restrict__ out,
                                            const BIAS& bias, int N, int q0, float scale, E* ks,
                                            E* vt) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  using T = HeadDim<HD>;
  constexpr int KP = T::kPad;

  Frag<E> qa[T::kSteps][4];
#pragma unroll
  for (int s = 0; s < T::kSteps; ++s) {
    const E* p0 = q + (long)r0 * HD + s * 16 + 2 * c;
    const E* p1 = q + (long)r1 * HD + s * 16 + 2 * c;
    qa[s][0] = frag(p0);
    qa[s][1] = frag(p1);
    qa[s][2] = frag(p0 + 8);
    qa[s][3] = frag(p1 + 8);
  }

  float o[T::kTiles][4];
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  const float sl2 = scale * kLog2e;

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // previous tile consumed (and K8b's bias staged)
    for (int i = tid; i < kBk * T::kVecs; i += 128) {
      const int key = i / T::kVecs, ch = i % T::kVecs;
      const long off = (long)(k0 + key) * HD + ch * 8;
      store8(&ks[key * KP + ch * 8], load8(k + off));
      const Vec8<E> vv = load8(v + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(ch * 8 + j) * kVPad + key] = vv[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const E* kr = &ks[(nt * 8 + g) * KP + 2 * c];
#pragma unroll
      for (int st = 0; st < T::kSteps; ++st)
        mma(s[nt], qa[st], frag(kr + st * 16), frag(kr + st * 16 + 8));
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * c;
      const float2 b0 = bias.pair(r0, col);
      const float2 b1 = bias.pair(r1, col);
      s[nt][0] = s[nt][0] * sl2 + b0.x * kLog2e;
      s[nt][1] = s[nt][1] * sl2 + b0.y * kLog2e;
      s[nt][2] = s[nt][2] * sl2 + b1.x * kLog2e;
      s[nt][3] = s[nt][3] * sl2 + b1.y * kLog2e;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
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

    // o += bf16(p) v (p split in f32): the s accumulators of n-tiles 2kk
    // and 2kk+1 are the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag<E> pa[4];
      pa[0] = pack_frag<E>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_frag<E>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_frag<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_frag<E>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < T::kTiles; ++d) {
        const E* vr = &vt[(d * 8 + g) * kVPad + kk * 16 + 2 * c];
        mma(o[d], pa, frag(vr), frag(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  E* orow0 = out + (long)r0 * HD + 2 * c;
  E* orow1 = out + (long)r1 * HD + 2 * c;
#pragma unroll
  for (int d = 0; d < T::kTiles; ++d) {
    store2(orow0 + d * 8, o[d][0] * inv0, o[d][1] * inv0);
    store2(orow1 + d * 8, o[d][2] * inv1, o[d][3] * inv1);
  }
}

// K8a: grid (W, N/64, H), the window fastest.
template <class E, int HD>
__global__ void __launch_bounds__(128)
attention_qtiled_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const float* __restrict__ bias,
                        E* __restrict__ out, int H, int N, float scale) {
  __shared__ __align__(16) E ks[kBk * HeadDim<HD>::kPad];
  __shared__ __align__(16) E vt[HD * kVPad];
  const int w = blockIdx.x, h = blockIdx.z;
  const long slab = ((long)w * H + h) * N * HD;
  attend_tile<HD>(q + slab, k + slab, v + slab, out + slab,
              GlobalBias{bias + (long)h * N * N, N}, N, blockIdx.y * kBq, scale, ks, vt);
}

// K8b: grid (N/64, H, W / bw); the block stages its 64 bias rows once and
// walks its bw windows in order.
template <class E, int HD>
__global__ void __launch_bounds__(128)
attention_batched_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const float* __restrict__ bias,
                         E* __restrict__ out, int H, int N, int bw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = N + kBiasPad;
  float* bs = reinterpret_cast<float*>(smem);
  E* ks = reinterpret_cast<E*>(bs + kBq * ld);
  E* vt = ks + kBk * HeadDim<HD>::kPad;
  const int q0 = blockIdx.x * kBq, h = blockIdx.y;

  const float* src = bias + ((long)h * N + q0) * N;
  const int quads = N / 4;
  for (int i = threadIdx.x; i < kBq * quads; i += 128) {
    const int r = i / quads, c4 = i - r * quads;
    *reinterpret_cast<float4*>(&bs[r * ld + c4 * 4]) =
        *reinterpret_cast<const float4*>(src + (long)r * N + c4 * 4);
  }
  const SharedBias sb{bs, ld, q0};
  const int w0 = blockIdx.z * bw;
  for (int w = w0; w < w0 + bw; ++w) {
    const long slab = ((long)w * H + h) * N * HD;
    attend_tile<HD>(q + slab, k + slab, v + slab, out + slab, sb, N, q0, scale, ks, vt);
  }
}

template <class E, int HD>
size_t batched_smem_bytes(int N) {
  return sizeof(float) * kBq * (N + kBiasPad) +
         sizeof(E) * (kBk * HeadDim<HD>::kPad + HD * kVPad);
}

template <class E>
int qtiled(const void* q, const void* k, const void* v, const void* bias, void* out, int W,
           int H, int N, int hd, float scale, cudaStream_t stream) {
  const dim3 grid(W, N / kBq, H);
  GG_HEAD_DIM_SWITCH(hd, {
    attention_qtiled_kernel<E, HD><<<grid, 128, 0, stream>>>(
        static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
        static_cast<const float*>(bias), static_cast<E*>(out), H, N, scale);
    return (int)cudaGetLastError();
  })
}

template <class E>
int batched(const void* q, const void* k, const void* v, const void* bias, void* out, int W,
            int H, int N, int hd, int block_w, float scale, cudaStream_t stream) {
  if (block_w < 1 || W % block_w) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBq, H, W / block_w);
  GG_HEAD_DIM_SWITCH(hd, {
    const size_t smem = batched_smem_bytes<E, HD>(N);
    cudaError_t e = cudaFuncSetAttribute(attention_batched_kernel<E, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_batched_kernel<E, HD><<<grid, 128, smem, stream>>>(
        static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
        static_cast<const float*>(bias), static_cast<E*>(out), H, N, block_w, scale);
    return (int)cudaGetLastError();
  })
}

}  // namespace
}  // namespace gg

// ---------------------------------------------------------------------------
// K8b's bf16 entry on Hopper (the head comment's design).

namespace gg {
namespace hm90 {

using namespace sm90;

constexpr int kRows = 64;                   // query rows of an item; rows of a k or v tile
constexpr int kConsumers = 256;             // two consumer warpgroups,
constexpr int kThreads = kConsumers + 128;  // then the producer warpgroup
// registers a thread after setmaxnreg, as the backward core's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxCols = 32;                // f32 bias columns a box: 128-byte rows
constexpr int kBoxBytes = kRows * 128;      // a box of 64 such rows
constexpr int kMaxSlots = 16;               // k/v slots of a group's ring, at most
constexpr int kSmemMax = 232448;            // what a block may opt in to (227 KB)

// The work of one call and its shared memory, from (W, H, N, G) and the
// head dim alone.
struct Plan {
  int W, H, N, G;
  int C;       // 64-key tiles of N (= 64-query tiles)
  int NT;      // key tiles a chunk of the score row
  int NB;      // bias tile buffers: 2 when they fit beside a ring of 2 chunks
  int S;       // k/v slots of each consumer group's ring
  int tile;    // bytes of a 64-row bf16 tile
  int bias;    // bytes of a 64-row f32 bias tile

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

  __host__ __device__ int barrier_bytes() const { return 8 * (2 * NB + 2 * (4 + 2 * S)); }
  int smem_bytes() const { return 1024 + NB * bias + 2 * (2 + S) * tile + barrier_bytes(); }
};

// The largest of 4, 3, 2, 1 tiles that divides the C key tiles: the whole
// row in one chunk up to N = 256.
inline int chunk_tiles(int C) { return C % 4 == 0 ? 4 : C % 3 == 0 ? 3 : C % 2 == 0 ? 2 : 1; }

inline cudaError_t make_plan(Plan* p, int W, int H, int N, int G, int hd) {
  p->W = W;
  p->H = H;
  p->N = N;
  p->G = G;
  p->C = N / kRows;
  p->NT = chunk_tiles(p->C);
  p->tile = kRows * hd * 2;
  p->bias = kRows * N * 4;
  for (int nb = 2; nb >= 1; --nb) {
    p->NB = nb;
    p->S = kMaxSlots;
    const int room = kSmemMax - 1024 - p->barrier_bytes() - nb * p->bias;
    int slots = room / (2 * p->tile) - 2;  // less each group's two q buffers
    if (slots > kMaxSlots) slots = kMaxSlots;
    // a chunk's k tiles must be resident together; two bias buffers only
    // when the ring also holds a chunk's v tiles
    if (slots >= (nb == 2 ? 2 * p->NT : p->NT)) {
      p->S = slots;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

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

// A position in a ring of S slots: the slot and the parity of its phase,
// advanced without a division.
struct RingPos {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int S) {
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Accumulator layout of a consumer thread (warp w of its group, lane =
// 4g + c), as mma.sync's C fragment in each 8-column tile t: d[4t + 0..1]
// = row 16w + g, columns 8t + 2c + 0..1; d[4t + 2..3] = row 16w + g + 8.
// Threads 0-255 are the two consumer warpgroups; warp 8 of the producer
// warpgroup loads group 0's tiles and the bias, warp 9 group 1's tiles.
template <int HD, int NT>
__global__ void __launch_bounds__(kThreads, 1)
attention_batched_sm90(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap bias_map, bf16* __restrict__ out,
                       const Plan p, float scale) {
  constexpr int T = kRows * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int NB = p.NB, S = p.S, C = p.C;
  // bias buffer b at base + b * bias; then group c's two q buffers and its
  // S ring slots; then the mbarriers
  const uint32_t groups0 = base + NB * p.bias;
  const uint32_t bars = groups0 + 2 * (2 + S) * T;
  auto bias_buf = [&](int b) { return base + b * p.bias; };
  auto bias_full = [&](int b) { return bars + 8 * b; };
  auto bias_empty = [&](int b) { return bars + 8 * (NB + b); };  // the 8 consumer warps
  auto q_buf = [&](int c, int i) { return groups0 + (c * (2 + S) + i) * T; };
  auto slot = [&](int c, int s) { return groups0 + (c * (2 + S) + 2 + s) * T; };
  auto gbar = [&](int c) { return bars + 16 * NB + c * 8 * (4 + 2 * S); };
  auto q_full = [&](int c, int i) { return gbar(c) + 8 * i; };
  auto q_empty = [&](int c, int i) { return gbar(c) + 16 + 8 * i; };  // the group's 4 warps
  auto full = [&](int c, int s) { return gbar(c) + 32 + 8 * s; };
  auto empty = [&](int c, int s) { return gbar(c) + 32 + 8 * S + 8 * s; };  // the group's 4 warps
  // the generic address of a shared one
  auto at = [&](uint32_t saddr) { return smem_raw + (saddr - raw); };
  const int items = (int)p.items();  // below 2^31 (run)

  if (threadIdx.x == 0) {
    for (int b = 0; b < NB; ++b) {
      mbar_init(bias_full(b), 1);
      mbar_init(bias_empty(b), 8);
    }
    for (int c = 0; c < 2; ++c) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(q_full(c, i), 1);
        mbar_init(q_empty(c, i), 4);
      }
      for (int s = 0; s < S; ++s) {
        mbar_init(full(c, s), 1);
        mbar_init(empty(c, s), 4);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int c = (threadIdx.x - kConsumers) / 32;  // the group this warp feeds
    if (c < 2 && (threadIdx.x & 31) == 0) {
      int bi = 0, qn = 0;  // items and q tiles loaded: ring positions
      RingPos ring;        // the next k/v slot
      bool wrapped = false;  // every slot filled once: wait for its release
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++bi) {
        int h, qt, w0, w1;
        p.decode(it, h, qt, w0, w1);
        if (c == 0) {
          const int b = bi % NB;
          if (bi >= NB) mbar_wait(bias_empty(b), ((bi / NB) - 1) & 1);
          mbar_expect_tx(bias_full(b), p.bias);
          for (int x = 0; x < p.N / kBoxCols; ++x)
            tma_load(bias_buf(b) + x * kBoxBytes, &bias_map, bias_full(b), x * kBoxCols,
                     qt * kRows, h);
        }
        for (int w = w0 + c; w < w1; w += 2, ++qn) {
          const int slab = w * p.H + h;  // the (window, head) rows of q, k, v
          const int qb = qn & 1;
          if (qn >= 2) mbar_wait(q_empty(c, qb), ((qn >> 1) - 1) & 1);
          mbar_expect_tx(q_full(c, qb), T);
          tma_load(q_buf(c, qb), &q_map, q_full(c, qb), 0, qt * kRows, slab);
          // per chunk its k tiles, then its v tiles
          for (int k0 = 0; k0 < C; k0 += NT)
            for (int src = 0; src < 2; ++src)
              for (int j = 0; j < NT; ++j) {
                const int s = ring.slot;
                if (wrapped) mbar_wait(empty(c, s), ring.phase ^ 1);
                mbar_expect_tx(full(c, s), T);
                tma_load(slot(c, s), src ? &v_map : &k_map, full(c, s), 0, (k0 + j) * kRows, slab);
                ring.next(S);
                wrapped = wrapped || ring.slot == 0;
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
    const bool whole = C == NT;     // one chunk: the whole score row at once
    // The bias tile's boxes hold 32 columns of the 64 rows, 128-byte rows
    // with the 128-byte swizzle.  The byte offsets in a box of this
    // thread's pairs at columns 8u + 2cc (u = 0..3), row lr0; row lr0 + 8
    // is 1024 bytes further, in the same swizzle phase.
    uint32_t boff[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) boff[u] = swizzle128(lr0, (8 * u + 2 * cc) * 4);
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int bi = 0, qn = 0;
    RingPos ring;  // the group's next k/v tile
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++bi) {
      int h, qt, w0, w1;
      p.decode(it, h, qt, w0, w1);
      const int b = bi % NB;
      // waited for even with no window of this item, so that the group's
      // release below counts toward this item's phase
      mbar_wait(bias_full(b), (bi / NB) & 1);
      const uint8_t* btile = at(bias_buf(b));

      for (int w = w0 + c; w < w1; w += 2, ++qn) {
        const int qb = qn & 1;
        mbar_wait(q_full(c, qb), (qn >> 1) & 1);
        const uint64_t dq = desc<HD>(q_buf(c, qb));
        float o[HD / 2];
        zero(o);
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // running max and row sum

        for (int k0 = 0; k0 < C; k0 += NT) {
          // s = q k^T over the chunk's tiles.  Every tile is waited for
          // before the first product: a wait between two products is a
          // branch that makes ptxas serialise them.
          uint64_t dk[NT];
          RingPos at_k = ring;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mbar_wait(full(c, at_k.slot), at_k.phase);
            dk[j] = desc<HD>(slot(c, at_k.slot));
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
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_m64n64k16_ss(s[j], dq + 2 * kk, dk[j] + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            fence_regs(s[j]);
            release(empty(c, ring.slot));
            ring.next(S);
          }
          if (k0 + NT >= C) release(q_empty(c, qb));

          // s * scale + bias in f32, then the max over the chunk's columns
          // (four partial maxima and sums a row, so that no chain of
          // dependent instructions runs the length of the row)
          const uint8_t* bchunk = btile + 2 * k0 * kBoxBytes;  // 64 columns: two boxes a tile
          float pm0[4], pm1[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) pm0[u] = pm1[u] = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const uint8_t* bp = bchunk + (2 * j + t / 4) * kBoxBytes + boff[t % 4];
              const float2 b0 = *reinterpret_cast<const float2*>(bp);
              const float2 b1 = *reinterpret_cast<const float2*>(bp + 8 * 128);
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
          // exp(x - max) as exp2 of one FMA; the rescale of what the
          // earlier chunks summed (0 at the first)
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
          uint32_t pa[NT][4][4];
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

          // o += p v over the chunk's tiles, waited for first as above
          uint64_t dv[NT];
          RingPos at_v = ring;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mbar_wait(full(c, at_v.slot), at_v.phase);
            dv[j] = desc<HD>(slot(c, at_v.slot));
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
            release(empty(c, ring.slot));
            ring.next(S);
          }
        }

        const float f0 = whole ? 1.f : 1.f / l0, f1 = whole ? 1.f : 1.f / l1;
        bf16* orow0 = out + ((long)(w * p.H + h) * p.N + qt * kRows + lr0) * HD + 2 * cc;
        bf16* orow1 = orow0 + 8 * HD;
#pragma unroll
        for (int t = 0; t < HD / 8; ++t) {
          *reinterpret_cast<uint32_t*>(orow0 + 8 * t) = pack_bf16(o[4 * t + 0] * f0, o[4 * t + 1] * f0);
          *reinterpret_cast<uint32_t*>(orow1 + 8 * t) = pack_bf16(o[4 * t + 2] * f1, o[4 * t + 3] * f1);
        }
      }
      release(bias_empty(b));
    }
  }
}

// static, as the backward core's launch_mode: its opt-in flag must be this
// library's own.
template <int HD, int NT>
static cudaError_t launch_nt(const CUtensorMap (&maps)[4], bf16* out, const Plan& p, float scale,
                      int sms, cudaStream_t stream) {
  static bool opted_in = false;  // one per instance
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_batched_sm90<HD, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const long items = p.items();
  const int grid = (int)(items < sms ? items : sms);
  attention_batched_sm90<HD, NT><<<grid, kThreads, p.smem_bytes(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, p, scale);
  return cudaGetLastError();
}

// q, k, v and out (W, H, N, HD) bf16 and the bias (H, N, N) f32, each
// contiguous with a 16-byte aligned base (the wrapper's _headmajor_layout);
// N a multiple of 64 below 512; 1 <= G <= W; W * H < 2^31.
template <int HD>
cudaError_t run(const void* q, const void* k, const void* v, const void* bias, void* out, int W,
                int H, int N, int G, float scale, cudaStream_t stream) {
  Plan p;
  cudaError_t e = make_plan(&p, W, H, N, G, HD);
  if (e != cudaSuccess) return e;
  if (p.items() > 0x7fffffffL) return cudaErrorInvalidValue;  // the kernel counts items in int
  // q, k, v as (W H, N, HD) rows, boxes of 64 rows; the bias (H, N, N) in
  // boxes of 64 rows of 32 f32 columns, swizzled over their 128 bytes
  CUtensorMap maps[4];
  const long slabs = (long)W * H;
  const void* rows[3] = {q, k, v};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = encode_rows<HD>(&maps[i], rows[i], HD, N, slabs, kRows);
  if (e == cudaSuccess)
    e = encode_3d(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias, N, N, H, kBoxCols, kRows,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  bf16* o = static_cast<bf16*>(out);
  switch (p.NT) {
    case 4: return launch_nt<HD, 4>(maps, o, p, scale, sms, stream);
    case 3: return launch_nt<HD, 3>(maps, o, p, scale, sms, stream);
    case 2: return launch_nt<HD, 2>(maps, o, p, scale, sms, stream);
    default: return launch_nt<HD, 1>(maps, o, p, scale, sms, stream);
  }
}

}  // namespace hm90
}  // namespace gg

// C entry points: shapes validated by the Python wrapper (N a multiple of
// 64, head dim 16, 32 or 64).  q, k, v and out bf16 (or f32 for the _f32
// twins), bias f32.  Return cudaGetLastError() after the launch.
extern "C" int attention_qtiled_bf16(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int W, int H, int N, int hd,
                                     float scale, cudaStream_t stream) {
  return gg::qtiled<gg::bf16>(q, k, v, bias, out, W, H, N, hd, scale, stream);
}

extern "C" int attention_qtiled_f32(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int W, int H, int N, int hd,
                                    float scale, cudaStream_t stream) {
  return gg::qtiled<float>(q, k, v, bias, out, W, H, N, hd, scale, stream);
}

// K8b in bf16: the Hopper kernel, its windows in G groups
// (window_attention._headmajor_groups) where the f32 twin takes BLOCK_W.
extern "C" int attention_batched_bf16(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int W, int H, int N, int hd,
                                      int groups, float scale, cudaStream_t stream) {
  GG_HEAD_DIM_SWITCH(hd, {
    return (int)gg::hm90::run<HD>(q, k, v, bias, out, W, H, N, groups, scale, stream);
  })
}

extern "C" int attention_batched_f32(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int W, int H, int N, int hd,
                                     int block_w, float scale, cudaStream_t stream) {
  return gg::batched<float>(q, k, v, bias, out, W, H, N, hd, block_w, scale, stream);
}
