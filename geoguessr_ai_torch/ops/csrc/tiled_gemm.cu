// K13: a tiled matrix product c (M, N) = a (M, K) @ b (K, N), in two types:
//   bf16 x bf16 -> f32    (the f32 sum);
//   int8 x int8 -> int32  (the int32 sum, exact).
//
// Replaces tools/exp_int8_pallas.py:43 pallas_matmul (body matmul_kernel,
// :37), the JAX package's probe of whether the int8 path of the matrix unit
// runs at twice the bf16 rate.  The probe is the point: it is not wired into
// any model (the static-int8 GEMMs of ops/quant.py are XLA dots in the JAX
// package and torch._int_mm in the port).
//
// Layouts: a (M, K) row-major; bt (N, K) row-major, b transposed, which the
// Python wrapper makes: both operands K-major, the only layout 8-bit wgmma
// reads.  c (M, N) row-major in f32 or int32.  M and N multiples of 128, K
// of 64 bytes.
//
// What bounds it on the H100: 2 M N K operations against (M K + K N) e + 4 M
// N bytes (e the input element size).  At the tool's square shapes (4096,
// K, 4096) the tensor cores (0.07-0.14 ms bf16 at 989 TFLOP/s, half that in
// int8 at 1979 TOP/s); at its MLP shapes (131072, 384, 1536) and (131072,
// 1536, 384) the 4-byte output write (805 MB and 201 MB) is as long as or
// longer than the tensor-core time, so only the square shapes can show the
// int8 rate.
//
// Both entries run the Hopper GEMM core of gemm_sm90.cuh (a TMA ring of A
// and B k-boxes, B shared by the two CTAs of a cluster by multicast,
// wgmma.m64n256k16 bf16 / m64n256k32 s8 on two consumer warpgroups,
// persistent blocks, the epilogue stored by TMA), the mainloop K11's
// out-projection runs too; the first design was mma.sync on 128 x 128
// tiles through two cp.async stages.
#include "gemm_sm90.cuh"

extern "C" int tiled_gemm_bf16(const void* a, const void* bt, void* c, int M, int N, int K,
                               void* stream) {
  if (M % 128 || N % 128) return (int)cudaErrorInvalidValue;
  return (int)gg::gemm90::run<gg::gemm90::kBf16F32>(a, bt, c, M, K, N,
                                                   static_cast<cudaStream_t>(stream));
}

extern "C" int tiled_gemm_s8(const void* a, const void* bt, void* c, int M, int N, int K,
                             void* stream) {
  if (M % 128 || N % 128) return (int)cudaErrorInvalidValue;
  return (int)gg::gemm90::run<gg::gemm90::kS8S32>(a, bt, c, M, K, N,
                                                 static_cast<cudaStream_t>(stream));
}

// The core's plan of a call with operands of in_bytes bytes an element,
// into out[0..6]: k-boxes, tile columns, ring stages, row tiles, column
// tiles, shared-memory bytes a block, and the CTAs a launch takes (the
// card's answer: a host call that needs a device).  The tests hold it
// against their mirror of make_plan.
extern "C" int tiled_gemm_plan(int M, int K, int N, int in_bytes, void* out) {
  gg::gemm90::Plan p;
  cudaError_t e = gg::gemm90::make_plan(&p, M, K, N, in_bytes);
  int sms = 0, grid = 0;
  if (e == cudaSuccess) e = gg::sm90::sm_count(&sms);
  if (e == cudaSuccess)
    e = p.BN == 256 ? gg::gemm90::grid_of<gg::gemm90::kS8S32, 256>(p, sms, &grid)
                    : gg::gemm90::grid_of<gg::gemm90::kS8S32, 128>(p, sms, &grid);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = p.KB;
  o[1] = p.BN;
  o[2] = p.S;
  o[3] = p.mtiles;
  o[4] = p.ntiles;
  o[5] = p.smem_bytes();
  o[6] = grid;
  return 0;
}
