// K13: a tiled matrix product c (M, N) = a (M, K) @ b (K, N), in two types:
//   bf16 x bf16 -> f32    with mma.sync.m16n8k16 (f32 accumulate);
//   int8 x int8 -> int32  with mma.sync.m16n8k32 (s32 accumulate, exact).
//
// Replaces tools/exp_int8_pallas.py:43 pallas_matmul (body matmul_kernel,
// :37), the JAX package's probe of whether the int8 path of the matrix unit
// runs at twice the bf16 rate.  The probe is the point: it is not wired into
// any model (the static-int8 GEMMs of ops/quant.py are XLA dots in the JAX
// package and torch._int_mm in the port).
//
// Layouts: a (M, K) row-major; bt (N, K) row-major, b transposed, which the
// Python wrapper makes: both mma operands then read K-contiguous words.  c
// (M, N) row-major in f32 or int32.  M and N multiples of 128, K of 64.
//
// What bounds it on the H100: 2 M N K operations against (M K + K N) e + 4 M
// N bytes (e the input element size).  At the tool's square shapes (4096,
// K, 4096) the tensor cores (0.14-0.28 ms bf16 at 989 TFLOP/s, half that in
// int8 at 1979 TOP/s); at its MLP shapes (131072, 384, 1536) and (131072,
// 1536, 384) the 4-byte output write (805 MB and 201 MB) is as long as or
// longer than the tensor-core time, so only the square shapes can show the
// int8 rate.
//
// The design is the simplest tiled one: a block of 8 warps per 128 x 128
// output tile, warps 2 (rows) x 4 (columns) of 64 x 32 each; the K loop
// steps 64 bytes of each row at a time (32 bf16 or 64 int8 values) through
// two shared-memory stages filled with cp.async while the other computes.
// A k-step of either instruction reads its A and B fragments at the same
// byte offsets (words 4c and 16 + 4c of a 32-byte row slice, rows g and
// g + 8), so one kernel serves both types.  No TMA or wgmma: that is the
// gap to the card's peak.
#include "common.cuh"

namespace gg {
namespace gemm {
namespace {

constexpr int kTile = 128;          // output rows and columns per block
constexpr int kStepBytes = 64;      // bytes of each row per K step
constexpr int kPitch = kStepBytes + 16;  // shared row pitch: conflict-free fragment reads
constexpr int kStage = 2 * kTile * kPitch;  // bytes of one stage (a and b tiles)
constexpr int kThreads = 256;

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1,
                                    bf16) {
  mma_bf16_16816(c, a, b0, b1);
}

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1,
                                    int8_t) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void copy16(unsigned char* dst, const unsigned char* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Rows [row0, row0 + 128) of a (rows, K) matrix, bytes [k0, k0 + 64) of
// each, into a shared tile of pitch kPitch.
__device__ __forceinline__ void stage(unsigned char* tile, const unsigned char* m, long row0,
                                      long row_bytes, long k0) {
  for (int i = threadIdx.x; i < kTile * 4; i += kThreads) {
    const int r = i >> 2, ch = i & 3;
    copy16(tile + r * kPitch + ch * 16, m + (row0 + r) * row_bytes + k0 + ch * 16);
  }
}

template <typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
tiled_gemm_kernel(const In* __restrict__ a, const In* __restrict__ bt, Acc* __restrict__ c,
                  int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const long m0 = (long)blockIdx.y * kTile, n0 = (long)blockIdx.x * kTile;
  const long row_bytes = (long)K * sizeof(In);
  const unsigned char* ab = reinterpret_cast<const unsigned char*>(a);
  const unsigned char* bb = reinterpret_cast<const unsigned char*>(bt);

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0;

  const int steps = (int)(row_bytes / kStepBytes);
  stage(smem, ab, m0, row_bytes, 0);
  stage(smem + kTile * kPitch, bb, n0, row_bytes, 0);
  asm volatile("cp.async.commit_group;\n");
  for (int s = 0; s < steps; ++s) {
    unsigned char* cur = smem + (s & 1) * kStage;
    if (s + 1 < steps) {
      unsigned char* nxt = smem + ((s + 1) & 1) * kStage;
      stage(nxt, ab, m0, row_bytes, (long)(s + 1) * kStepBytes);
      stage(nxt + kTile * kPitch, bb, n0, row_bytes, (long)(s + 1) * kStepBytes);
    }
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();
    const unsigned char* as = cur;
    const unsigned char* bs = cur + kTile * kPitch;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two mma k-steps of 32 bytes
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* p = as + (wm * 64 + mt * 16 + g) * kPitch + ks * 32 + 4 * cq;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* p = bs + (wn * 32 + nt * 8 + g) * kPitch + ks * 32 + 4 * cq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma(acc[mt][nt], af[mt], b0, b1, In());
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const long r0 = m0 + wm * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long col = n0 + wn * 32 + nt * 8 + 2 * cq;
      Acc* p0 = c + r0 * N + col;
      Acc* p1 = p0 + 8L * N;
      p0[0] = acc[mt][nt][0];
      p0[1] = acc[mt][nt][1];
      p1[0] = acc[mt][nt][2];
      p1[1] = acc[mt][nt][3];
    }
  }
}

template <typename In, typename Acc>
cudaError_t launch(const void* a, const void* bt, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  if (M % kTile || N % kTile || (K * (int)sizeof(In)) % kStepBytes || M < 1 || N < 1 ||
      K < 1 || M / kTile > 65535)
    return cudaErrorInvalidValue;
  const int smem = 2 * kStage;
  cudaError_t e = cudaFuncSetAttribute(tiled_gemm_kernel<In, Acc>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  tiled_gemm_kernel<In, Acc><<<dim3(N / kTile, M / kTile), kThreads, smem, stream>>>(
      static_cast<const In*>(a), static_cast<const In*>(bt), static_cast<Acc*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm
}  // namespace gg

extern "C" int tiled_gemm_bf16(const void* a, const void* bt, void* c, int M, int N, int K,
                               void* stream) {
  return (int)gg::gemm::launch<gg::bf16, float>(a, bt, c, M, N, K,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" int tiled_gemm_s8(const void* a, const void* bt, void* c, int M, int N, int K,
                             void* stream) {
  return (int)gg::gemm::launch<int8_t, int>(a, bt, c, M, N, K,
                                           static_cast<cudaStream_t>(stream));
}
