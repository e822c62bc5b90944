// The Hopper (sm_90a) LayerNorm + GEMM core, in bf16:
//
//     y[M, Nout] = bf16(bf16(LN(x) @ wt^T) + b),   LN(x) = bf16((x - mu) rstd gamma + beta)
//
// with x (M, K) and y (M, Nout) bf16 rows, wt (Nout, K) bf16 (PyTorch's
// (out, in) layout: the K-major B operand of wgmma), gamma, beta (K) and b
// (Nout) f32 (b already rounded to bf16 by the caller: the qkv GEMM's
// ROUND_FIRST epilogue, common.cuh's ln_gemm_kernel).  K2's bf16 entry
// (fb_s2.cu) runs it for its qkv GEMM; it is written so that K1 and K9 can
// take it too.
//
// What bounds it on the H100 at stage 2 of a serving bucket of 16 (M =
// 65,536, K = 384, Nout = 1152): 5.8e10 flop (0.059 ms at the bf16 peak)
// against 201 MB of x, wt and y (0.060 ms at 3.35 TB/s); the first design
// (64 x 64 tiles, mma.sync, synchronously staged k-steps) recomputed each
// row's statistics for every one of the 18 column tiles and re-normalised
// each A tile on its way into shared memory.
//
// The design:
//   * Persistent blocks of 384 threads, one an SM, walk 128-row tiles of x.
//     A tile comes in by TMA (boxes of 64 columns x 128 rows, 128-byte
//     swizzle: the layout wgmma reads, K-major).  The two consumer
//     warpgroups each take 64 of its rows: each row's mean and rstd once,
//     in two passes in f32 (mean, then the mean of squared deviations, as
//     the JAX kernels do), the normalised row rounded to bf16 written back
//     in place, in the same swizzled layout.
//   * The block then walks the Nout columns in tiles of 64, two at a time,
//     k-box by k-box: a box's two B tiles (64 k x 64 columns each) are
//     waited for and their products issued (wgmma.m64n64k16, A and B from
//     shared memory), and the previous box's slots are released once its
//     products are done, so the ring refills under the products.  The
//     waits loop inside their asm and the releases are predicated: nothing
//     branches between the first product and the last wait.
//   * Warp 8 loads the x tiles, warp 9 keeps the ring of B boxes full: the
//     weights are the same for every row tile and come from L2.
//   * The epilogue bf16(bf16(acc) + b) goes into a staging tile in shared
//     memory (128-byte swizzle: conflict-free stores), and leaves by one
//     TMA store for each 64 x 64 tile, which also drops the rows past M;
//     with the k-box waits this took the kernel from 0.270 to 0.181 ms at
//     stage 2 of a serving bucket of 16 on an H100 (700 W), against 4-byte
//     stores straight from the accumulators and whole-step waits.
// Every output element is one thread's sum in an order fixed by the shape,
// so two calls are bitwise the same on any card.
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
constexpr int kConsumers = 256;             // two consumer warpgroups, 64 rows each,
constexpr int kThreads = kConsumers + 128;  // then the loader warpgroup
constexpr int kBoxA = kRows * 128;          // bytes of an x box
constexpr int kBoxB = kCols * 128;          // bytes of a B box
constexpr int kMaxSlots = 16;               // B boxes of the ring, at most
constexpr int kStage = 4 * kBoxB;           // each group's two 64 x 64 output tiles on their way out
constexpr int kSmemMax = 232448;            // what a block may opt in to (227 KB)

// The work of one call and its shared memory, from (M, K, Nout) alone.
struct Plan {
  int M, K, Nout;
  int KB;     // 64-column boxes of a row (K / 64)
  int S;      // B boxes of the ring
  int tiles;  // 128-row tiles of x
  int ncol;   // 64-column tiles of y

  __host__ __device__ int barrier_bytes() const { return 8 * (2 + 2 * S); }
  int smem_bytes() const { return 1024 + KB * kBoxA + kStage + S * kBoxB + barrier_bytes(); }
};

// The ring must hold two k-boxes of both column tiles of a step; K is a
// multiple of 64 up to 448 (the kernel's instances), Nout of 64.
cudaError_t make_plan(Plan* p, int M, int K, int Nout) {
  if (M < 1 || K < kBoxK || K % kBoxK || Nout < kCols || Nout % kCols) return cudaErrorInvalidValue;
  p->M = M;
  p->K = K;
  p->Nout = Nout;
  p->KB = K / kBoxK;
  p->tiles = (M + kRows - 1) / kRows;
  p->ncol = Nout / kCols;
  p->S = kMaxSlots;
  int slots = (kSmemMax - 1024 - p->barrier_bytes() - p->KB * kBoxA - kStage) / kBoxB;
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (slots < 4 || p->KB > 7) return cudaErrorInvalidValue;
  p->S = slots;
  return cudaSuccess;
}

// The shared memory of a block: the KB x boxes at the 1024-aligned base,
// the four output staging tiles (group c's tile i at 2 c + i), the S B
// boxes, then the mbarriers: x full, x empty (the 8 consumer warps), and
// each B slot's full and empty (the 8 consumer warps).
struct Smem {
  uint32_t a, stage, slots, bars;
  int S;
  __device__ Smem(const Plan& p, uint32_t base) : a(base), S(p.S) {
    stage = a + p.KB * kBoxA;
    slots = stage + kStage;
    bars = slots + S * kBoxB;
  }
  __device__ uint32_t out(int c, int i) const { return stage + (2 * c + i) * kBoxB; }
  __device__ uint32_t box_a(int b) const { return a + b * kBoxA; }
  __device__ uint32_t slot(int s) const { return slots + s * kBoxB; }
  __device__ uint32_t a_full() const { return bars; }
  __device__ uint32_t a_empty() const { return bars + 8; }
  __device__ uint32_t full(int s) const { return bars + 16 + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 16 + 8 * S + 8 * s; }
};

// LayerNorm of the 16 rows [r0, r0 + 16) of the x tile in place, one
// warp: each lane holds 16-byte chunks j = lane, lane + 32, .. of a row
// (box j / 8, 16-byte column j % 8, swizzled with the row).
template <int KC>
__device__ __forceinline__ void layer_norm_rows(uint8_t* tile, int r0, int K,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, float eps) {
  const int lane = threadIdx.x & 31;
  const int chunks = K / 8;
  for (int r = r0; r < r0 + 16; ++r) {
    uint4 raw[KC];
    float v[KC][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int j = lane + 32 * i;
      raw[i] = make_uint4(0, 0, 0, 0);
      if (j < chunks)
        raw[i] = *reinterpret_cast<const uint4*>(tile + (j >> 3) * kBoxA +
                                                 swizzle128(r, (j & 7) * 16));
      const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = unpack_bf16(w[t]);
        v[i][2 * t] = f.x;
        v[i][2 * t + 1] = f.y;
        sum += f.x + f.y;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / K;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < KC; ++i)
      if (lane + 32 * i < chunks)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float d = v[i][t] - mu;
          sq += d * d;
        }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(sq / K + eps);
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int j = lane + 32 * i;
      if (j >= chunks) continue;
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + 8 * j);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + 8 * j + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(beta + 8 * j);
      const float4 b1 = *reinterpret_cast<const float4*>(beta + 8 * j + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float n[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) n[t] = (v[i][t] - mu) * rs * g[t] + b[t];
      *reinterpret_cast<uint4*>(tile + (j >> 3) * kBoxA + swizzle128(r, (j & 7) * 16)) =
          make_uint4(pack_bf16(n[0], n[1]), pack_bf16(n[2], n[3]), pack_bf16(n[4], n[5]),
                     pack_bf16(n[6], n[7]));
    }
  }
}

__device__ __forceinline__ void arrive_nb(uint32_t bar) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(threadIdx.x & 31)
      : "memory");
}

// Waits (a loop inside the asm) until the phase of parity `parity` has
// completed; traps after 2^26 tries, as sm90.cuh's mbar_wait does.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\nadd.u32 n, n, 1;\nsetp.lt.u32 p, n, 67108864;\n@p bra WAIT_%=;\n"
      "trap;\nDONE_%=:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The group's leader thread (lane 0 of its first warp) waits until at most
// one of its output stores still reads shared memory.
__device__ __forceinline__ void store_wait_read(bool leader) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group.read 1;\n}\n" ::"r"(
                   (int)leader)
               : "memory");
}

// The leader's TMA store of a 64 x 64 output tile (rows past M are not written).
__device__ __forceinline__ void store_tile_tma(bool leader, const CUtensorMap* map, uint32_t src, int c0,
                                               int c1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%1, {%3, %4, %5}], [%2];\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"r"((int)leader),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(0)
      : "memory");
}

// A 64 x 64 accumulator of group c as bf16(bf16(acc) + b) into its staging
// tile (rows swizzled over 128 bytes, as the output map writes them), then
// one TMA store of the tile at (col0, row0).
__device__ __forceinline__ void epilogue(const float (&d)[32], uint32_t buf, const CUtensorMap* y_map,
                                         const float* __restrict__ bvec, int col0, int row0, int c,
                                         int warp, int g, int cc) {
  const bool leader = (threadIdx.x & 127) == 0;
  store_wait_read(leader);
  group_sync(c);
  const int r = 16 * warp + g;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 b = *reinterpret_cast<const float2*>(bvec + col0 + 8 * t + 2 * cc);
    const int byte = (8 * t + 2 * cc) * 2;
    const uint32_t v0 = pack_bf16(round_bf16(d[4 * t]) + b.x, round_bf16(d[4 * t + 1]) + b.y);
    const uint32_t v1 = pack_bf16(round_bf16(d[4 * t + 2]) + b.x, round_bf16(d[4 * t + 3]) + b.y);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(buf + swizzle128(r, byte)), "r"(v0) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(buf + swizzle128(r + 8, byte)), "r"(v1) : "memory");
  }
  fence_proxy_async();
  group_sync(c);
  store_tile_tma(leader, y_map, buf, col0, row0);
}

// One step of NT (1 or 2) column tiles from column tile ct, k-box by
// k-box: the box's NT B tiles waited for, their products issued, then the
// previous box's slots released once its products are done.  The waits
// loop inside their asm and nothing else branches between the first
// product and the last wait.
template <int KB, int NT>
__device__ __forceinline__ void gemm_step(const Smem& sm, RingPos& ring, uint32_t a0, const CUtensorMap* y_map,
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
        wgmma_m64n64k16_ss(d[i], desc<64>(a0 + b * kBoxA) + 2 * kk, bd[i] + 2 * kk);
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
#pragma unroll
  for (int i = 0; i < NT; ++i)
    epilogue(d[i], sm.out(c, i), y_map, bvec, (ct + i) * kCols, row0, c, warp, g, cc);
}

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
ln_gemm_sm90(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
             const __grid_constant__ CUtensorMap y_map, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ bvec, const Plan p, float eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const Smem sm(p, (raw + 1023) & ~1023u);
  uint8_t* tile = smem_raw + (sm.a - raw);
  const int S = p.S;

  if (threadIdx.x == 0) {
    mbar_init(sm.a_full(), 1);
    mbar_init(sm.a_empty(), 8);
    for (int s = 0; s < S; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    const int warp = (threadIdx.x - kConsumers) / 32;
    if ((threadIdx.x & 31) != 0) return;
    if (warp == 0) {  // the x tiles
      int n = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++n) {
        if (n > 0) mbar_wait(sm.a_empty(), (n - 1) & 1);
        mbar_expect_tx(sm.a_full(), KB * kBoxA);
        for (int b = 0; b < KB; ++b)
          tma_load(sm.box_a(b), &x_map, sm.a_full(), b * kBoxK, t * kRows, 0);
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

  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, cc = lane & 3;
  const uint32_t a0 = sm.a + c * (64 * 128);  // this group's 64 rows of box 0
  RingPos ring;
  int n = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++n) {
    mbar_wait(sm.a_full(), n & 1);
    layer_norm_rows<(8 * KB + 31) / 32>(tile, 64 * c + 16 * warp, p.K, gamma, beta, eps);
    fence_proxy_async();
    group_sync(c);
    const int row0 = t * kRows + 64 * c;
    int ct = 0;
    for (; ct + 1 < p.ncol; ct += 2) gemm_step<KB, 2>(sm, ring, a0, &y_map, bvec, row0, ct, c, warp, g, cc);
    if (ct < p.ncol) gemm_step<KB, 1>(sm, ring, a0, &y_map, bvec, row0, ct, c, warp, g, cc);
    release(sm.a_empty());
  }
  // the group's output stores have read their staging tiles before the block exits
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int KB>
cudaError_t launch_kb(const CUtensorMap (&maps)[3], const float* gamma, const float* beta,
                      const float* b, const Plan& p, float eps, int sms, cudaStream_t stream) {
  static bool opted_in = false;  // one per instance, and this library's own
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_gemm_sm90<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  ln_gemm_sm90<KB><<<grid, kThreads, p.smem_bytes(), stream>>>(maps[0], maps[1], maps[2], gamma,
                                                              beta, b, p, eps);
  return cudaGetLastError();
}

// One call: x (M, K), wt (Nout, K) and y (M, Nout) contiguous bf16 with
// 16-byte aligned bases; gamma, beta (K), b (Nout) f32.  K a multiple of
// 64 up to 448, Nout a multiple of 64; anything else returns
// cudaErrorInvalidValue.
cudaError_t run(const void* x, const float* gamma, const float* beta, const void* wt,
                const float* b, void* y, int M, int K, int Nout, float eps, cudaStream_t stream) {
  Plan p;
  cudaError_t e = make_plan(&p, M, K, Nout);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[3];
  e = encode_3d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 1, kBoxK, kRows,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = encode_3d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wt, K, Nout, 1, kBoxK, kCols,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = encode_3d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, Nout, M, 1, kCols, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  switch (p.KB) {
    case 1: return launch_kb<1>(maps, gamma, beta, b, p, eps, sms, stream);
    case 2: return launch_kb<2>(maps, gamma, beta, b, p, eps, sms, stream);
    case 3: return launch_kb<3>(maps, gamma, beta, b, p, eps, sms, stream);
    case 4: return launch_kb<4>(maps, gamma, beta, b, p, eps, sms, stream);
    case 5: return launch_kb<5>(maps, gamma, beta, b, p, eps, sms, stream);
    case 6: return launch_kb<6>(maps, gamma, beta, b, p, eps, sms, stream);
    default: return launch_kb<7>(maps, gamma, beta, b, p, eps, sms, stream);
  }
}

}  // namespace
}  // namespace lng90
}  // namespace gg
