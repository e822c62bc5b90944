// K14: out = sum_{i=1..6} i * x through six slabs of shared memory, a
// probe of the shared-memory opt-in.
//
// Replaces tools/exp_r4_vmem.py:35 probe (kernel `kern`, :42), which
// computes out[r, c] = sum over i of x[0, r, c] * (i + 1) for x (1, 1024,
// 1024) f32 through a (6, 1024, 1024) f32 VMEM scratch of 24 MiB: over the
// TPU compiler's default scoped-VMEM limit, so the kernel only compiles
// when vmem_limit_bytes raises it.  The Hopper counterpart of that limit is
// the 48 KB of shared memory a block gets by default: more, up to 227 KB
// (232,448 B), only after cudaFuncSetAttribute(kernel,
// cudaFuncAttributeMaxDynamicSharedMemorySize, bytes).  So each block
// stages kRows = 8 full rows of x into six slabs, slab i = x * (i + 1),
// 6 x 32 KiB = 192 KiB of dynamic shared memory, then sums the slabs in
// order i = 0..5 and writes its rows: 128 blocks for 1024 rows.  Without
// the opt-in the launch is refused (cudaErrorInvalidValue) and runs
// nothing.
//
// What bounds it on the H100: 4 MiB read and 4 MiB written, 2.50 us at
// 3.35 TB/s; its 11 operations an element are nothing beside that.  It
// exists to need the shared memory, so the slabs stay; what the design
// does about the bytes is to read each element of x from device memory
// once, as float4 into registers, write the six scaled copies from there,
// and sum them with float4 shared-memory reads and float4 stores (cols a
// multiple of 4, x and out 16-byte aligned).  The opt-in is set only when
// the requested limit differs from the one last set.
#include <cuda_runtime.h>

namespace {

constexpr int kSlabs = 6;
constexpr int kRows = 8;  // rows of x a block stages
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
smem_probe_kernel(const float4* __restrict__ x, float4* __restrict__ out, int cols) {
  extern __shared__ float4 scr[];  // [kSlabs][kRows * cols / 4]
  const int n = kRows * cols / 4;
  const long base = (long)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float4 v = x[base + j];
#pragma unroll
    for (int i = 0; i < kSlabs; ++i) {
      const float f = i + 1.f;
      scr[i * n + j] = make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float4 s = scr[j];
#pragma unroll
    for (int i = 1; i < kSlabs; ++i) {
      const float4 t = scr[i * n + j];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    out[base + j] = s;
  }
}

}  // namespace

// x and out (rows, cols) f32, rows a multiple of 8, cols a multiple of 4,
// both 16-byte aligned.  limit is the opt-in handed to
// cudaFuncSetAttribute before the launch; 0 sets it back to the default
// 48 KB, so the launch is refused whatever an earlier call set.  The
// attribute is set only when the limit differs from the one last set.
// Returns the launch's cudaGetLastError().
extern "C" int smem_probe_f32(const void* x, void* out, int rows, int cols, int limit,
                              void* stream) {
  if (rows % kRows || cols < 4 || cols % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kSlabs * kRows * cols;
  static int last_limit = -1;
  const int want = limit > 0 ? limit : 48 * 1024;
  if (want != last_limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
    if (e != cudaSuccess) return (int)e;
    last_limit = want;
  }
  smem_probe_kernel<<<rows / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), cols);
  return (int)cudaGetLastError();
}
