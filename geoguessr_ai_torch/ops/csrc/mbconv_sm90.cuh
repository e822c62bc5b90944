// The Hopper (sm_90a) kernel of K10's bf16 entry (mbconv.cu): TinyViT's
// stage-0 MBConv with folded BatchNorm,
//
//   h = gelu(bn1(x . w1))           1x1 expand C -> E, zero where the halo
//                                   pixel is image padding
//   y = gelu(bn2(depthwise3x3(h)))
//   out = gelu(x + bn3(y . w3))     1x1 project E -> C, residual
//
// with x and out (B, H, W, C) bf16, C in {32, 64, 96}, E a multiple of 64,
// any H and W.  Rounding as mbconv.cu lists it (_mbconv_xla's order): each
// GEMM sums in f32, BN in f32 then rounded to bf16, GELU in f32 on that
// bf16 value then rounded, the depthwise MACs f32 over bf16 taps in (di,
// dj) order, the residual rounded before the last GELU.  Its PLAIN kind
// is the experimental K12a / K12b (fused_mbconv_exp.cu): plain biases in
// place of each BN, f32 taps, and only GELU's outputs rounded (run<>'s
// note).  The tanh GELU is
// 0.5 x (1 + tanh(u)) with tanh.approx.f32, one MUFU operation (the first
// design's x / (1 + exp(-2u)) took two and a division's refinement); the
// erf GELU keeps erff.
//
// What bounded the first design (mbconv.cuh: one block of 8 warps per
// (image, 8 x 16 tile), mma.sync, 25.45 ms at 512 images against a 1.31 ms
// tensor-core bound): weights staged synchronously by every thread for
// every tile, 32-bit fragment loads, one h load and one tap load for each
// 64 depthwise MACs of a warp, two MUFU operations a GELU, and phases that
// add up behind __syncthreads.  The design here:
//   * Persistent blocks of 384 threads, one an SM, walk 16 x 16 output
//     tiles (image-major, column tile fastest).  Warp 8 loads each tile's
//     18 x 18 x C halo of x by TMA through a 4D tensor map over (C, W, H,
//     B): its out-of-bounds zero fill is the conv's padding of x.  Rows of
//     C = 96 are 192 bytes, more than a 128-byte swizzle span, so the halo
//     comes as a box of 64 channels (128-byte swizzle) and one of 32 (64-
//     byte swizzle), the K-major layouts wgmma reads.  Warp 9 keeps a ring
//     of E-chunks (64 expanded channels: the w1 rows, the w3 columns, the
//     taps and the BN pairs) full by TMA; no thread copies weights.
//   * Two consumer warpgroups split the tile's rows: group c owns output
//     rows [8c, 8c + 8) and expands the 180 halo pixels they need (three
//     64-row wgmma tiles from the shared halo, 1.5x its 128 outputs),
//     applies BN1, GELU and the padding mask, and keeps the chunk in its
//     own shared buffer.  The groups share the halo and the ring and run
//     apart, so one group's products run under the other's depthwise and
//     GELU work.
//   * The depthwise output is the A operand of the project GEMM in
//     registers: row 16 w + g + 8 j of m-tile mt of warp w is output pixel
//     (2 w + mt, 2 g + j), so each thread computes a 2 x 2 block of pixels
//     for two channel pairs and reads a 4 x 4 neighbourhood of h words per
//     pair: 16 h loads and 9 tap loads for 36 MACs of each of two channels,
//     where the first design made 36 and 36.  The project is wgmma with A
//     from registers and B (the w3 chunk) from shared memory; its f32 sums
//     stay in registers across the chunks.
//   * The epilogue adds BN3, the residual (from device memory: the halo is
//     released after the last chunk's expand so that the next tile's halo
//     loads under this tile's last depthwise) and the last GELU.
// What bounds it now (an H100 at 700 W, 512 images: 9.8 ms against the
// tensor cores' 1.31 ms): instruction issue.  Each thread runs ~4000
// instructions an E-chunk (the depthwise FMAs, ~11 a GELU with its BN and
// roundings, the bf16 widening) on two warps a scheduler, above the MUFU
// (2.1 ms), FP32 (3.0 ms) and shared-memory (1.8 ms) floors; the project's
// 96 accumulators leave no registers for a third consumer group.  bf16
// pairs are widened by two integer operations (widen2), not the three of
// unpack_bf16's compiled form.
//
// Every output element is one thread's sum in an order fixed by the shape,
// so two calls are bitwise the same on any card.
//
// Everything here has internal linkage (the unnamed namespace below).
#pragma once

#include "sm90.cuh"

namespace gg {
namespace mb90 {
namespace {

using namespace sm90;

constexpr int kTile = 16;                    // output tile rows and columns
constexpr int kHw = kTile + 2;               // halo columns (and rows)
constexpr int kGroupRows = 8;                // output rows of a consumer group
constexpr int kGroupHalo = (kGroupRows + 2) * kHw;  // 180 halo pixels a group reads
constexpr int kExpandRows = 192;             // three 64-row wgmma tiles of the expand
constexpr int kGroupStart = kGroupRows * kHw;       // 144: group 1's first halo pixel
constexpr int kHaloRows = kGroupStart + kExpandRows;  // 336 halo rows in shared memory (324 loaded)
constexpr int kEc = 64;                      // expanded channels of a chunk
constexpr int kHPitch = 68;                  // pitch (elements) of a group's expanded chunk
constexpr int kConsumers = 256;              // two consumer warpgroups,
constexpr int kThreads = kConsumers + 128;   // then the loader warpgroup
constexpr int kProducerRegs = 40;            // registers a thread after setmaxnreg:
constexpr int kConsumerRegs = 232;           // 40 x 128 + 232 x 256 <= 65536
constexpr int kMaxSlots = 8;                 // E-chunks of the ring, at most
constexpr int kSmemMax = 232448;             // what a block may opt in to (227 KB)

// The channel boxes of a row of x (and of w1): 64 channels with the
// 128-byte swizzle, then the rest (32) with the 64-byte one.
template <int C>
struct Boxes {
  static_assert(C == 32 || C == 64 || C == 96, "C in {32, 64, 96}");
  static constexpr int n = (C + 63) / 64;
  __host__ __device__ static constexpr int width(int i) { return C - 64 * i < 64 ? C - 64 * i : 64; }
  __host__ __device__ static constexpr int row_bytes(int i) { return 2 * width(i); }
};

// Byte offsets into dynamic shared memory from its 1024-aligned base.
template <int C>
struct Layout {
  using X = Boxes<C>;
  // the halo: box 0, then box 1 (C = 96), kHaloRows rows each
  __host__ __device__ static constexpr int halo_box(int i) { return i == 0 ? 0 : kHaloRows * X::row_bytes(0); }
  static constexpr int halo = kHaloRows * 2 * C;
  // an E-chunk of the ring: w1 rows (box 0, box 1), w3 columns (C rows of
  // 64), the taps (9 x 64 f32), BN1's and BN2's (scale, bias) rows
  __host__ __device__ static constexpr int w1_box(int i) { return i == 0 ? 0 : kEc * X::row_bytes(0); }
  static constexpr int w3 = kEc * 2 * C;
  static constexpr int w2 = w3 + C * 128;
  static constexpr int sb1 = w2 + 9 * kEc * 4;
  static constexpr int sb2 = sb1 + 2 * kEc * 4;
  static constexpr int slot_tx = sb2 + 2 * kEc * 4;   // bytes TMA writes into a slot
  static constexpr int slot = (slot_tx + 1023) & ~1023;
  static constexpr int ring = halo;
  static constexpr int fixed = halo + 2 * kGroupHalo * kHPitch * 2;  // the halo, the groups' chunks
  // the ring's slots fill what the rest leaves, at most kMaxSlots
  static constexpr int fit = (kSmemMax - 1024 - fixed - 8 * (2 + 2 * kMaxSlots)) / slot;
  static constexpr int S = fit < kMaxSlots ? fit : kMaxSlots;
  __host__ __device__ static constexpr int h(int c) { return ring + S * slot + c * kGroupHalo * kHPitch * 2; }
  static constexpr int bar = ring + S * slot + 2 * kGroupHalo * kHPitch * 2;
  static constexpr int bytes = 1024 + bar + 8 * (2 + 2 * S);
  static_assert(S >= 2, "a ring of at least two E-chunks");
  static_assert(bytes <= kSmemMax, "shared memory");
};

// d (64 x 32, f32) += A (64 x 16, bf16 registers) . B (16 x 32, shared, K-major).
__device__ __forceinline__ void wgmma_m64n32k16_rs_k(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, shared, K-major).
__device__ __forceinline__ void wgmma_m64n64k16_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 96, f32) += A (64 x 16, bf16 registers) . B (16 x 96, shared, K-major).
__device__ __forceinline__ void wgmma_m64n96k16_rs_k(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 96) wgmma_m64n96k16_rs_k(d, a, db);
  else if constexpr (N == 64) wgmma_m64n64k16_rs_k(d, a, db);
  else wgmma_m64n32k16_rs_k(d, a, db);
}

// One TMA load of the 4D box at (c0, c1, c2, c3) into dst, completing on
// bar; coordinates outside the tensor (negative ones too) read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 32-bit shared-memory store made only when ok, without a branch.
__device__ __forceinline__ void st_shared_if(uint32_t addr, uint32_t v, bool ok) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.shared.b32 [%0], %1;\n}\n" ::"r"(addr),
      "r"(v), "r"((int)ok)
      : "memory");
}

// GELU in f32: the tanh form with one MUFU operation (tanh.approx), or erf.
template <bool EXACT>
__device__ __forceinline__ float gelu(float x) {
  if (EXACT) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  // u = sqrt(2/pi) (x + 0.044715 x^3)
  const float u = x * fmaf(0.0356774081363001f, x * x, 0.7978845608028654f);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(u));
  const float hx = 0.5f * x;
  return fmaf(hx, t, hx);
}

// Two f32 values rounded to bf16 (one conversion for both), back in f32.
__device__ __forceinline__ float2 round2(float a, float b) { return widen2(pack_bf16(a, b)); }

// gelu(bf16(v * s + b)) of a pair, packed as bf16; in the PLAIN kind
// (s = 1) GELU reads v + b unrounded.
template <bool EXACT, bool PLAIN>
__device__ __forceinline__ uint32_t bn_gelu2(float v0, float v1, float2 s, float2 b) {
  float2 r;
  if constexpr (PLAIN) r = make_float2(v0 + b.x, v1 + b.y);
  else r = round2(fmaf(v0, s.x, b.x), fmaf(v1, s.y, b.y));
  return pack_bf16(gelu<EXACT>(r.x), gelu<EXACT>(r.y));
}

// The expand's epilogue of one 64-row m-tile of group c's halo rows (this
// thread's rows lr, lr + 8 of it): BN1, GELU, zero where the halo pixel is
// image padding (in[j]), stored as bf16 pairs into the group's chunk (rows
// past its 180 pixels are not stored).
template <bool EXACT, bool PLAIN>
__device__ __forceinline__ void expand_epilogue(const float (&d)[32], uint32_t hbuf, int lr,
                                                const bool (&in)[2], const float* sb1, int cc) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ch = 8 * t + 2 * cc;
    const float2 s = *reinterpret_cast<const float2*>(sb1 + ch);
    const float2 b = *reinterpret_cast<const float2*>(sb1 + kEc + ch);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = lr + 8 * j;
      const uint32_t v = bn_gelu2<EXACT, PLAIN>(d[4 * t + 2 * j], d[4 * t + 2 * j + 1], s, b);
      st_shared_if(hbuf + (row * kHPitch + ch) * 2, in[j] ? v : 0u, row < kGroupHalo);
    }
  }
}

// The depthwise 3x3, BN2 and GELU of k-step ks (channels 16 ks + [0, 16))
// for this thread's 2 x 2 output pixels (rows oy, oy + 1 of its group,
// columns ox, ox + 1), as the A fragments a[mt] of the project GEMM's two
// m-tiles: a[mt][0] = (pixel (oy + mt, ox), channels 2cc, +1), a[mt][1] =
// (oy + mt, ox + 1), a[mt][2], a[mt][3] the same 8 channels further.
template <bool EXACT, bool PLAIN>
__device__ __forceinline__ void depthwise_ks(const bf16* hg, const float* w2, const float* sb2,
                                             int oy, int ox, int ks, int cc,
                                             uint32_t (&a)[2][4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ch = 16 * ks + 8 * hh + 2 * cc;
    float2 hv[4][4];  // h at rows oy .. oy + 3, columns ox .. ox + 3 of the group's chunk
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hv[r][q] = widen2(*reinterpret_cast<const uint32_t*>(hg + ((oy + r) * kHw + ox + q) * kHPitch + ch));
    float2 tap[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) tap[k] = *reinterpret_cast<const float2*>(w2 + k * kEc + ch);
    const float2 s = *reinterpret_cast<const float2*>(sb2 + ch);
    const float2 b = *reinterpret_cast<const float2*>(sb2 + kEc + ch);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float2 h = hv[mt + di][j + dj];
            s0 = fmaf(h.x, tap[di * 3 + dj].x, s0);
            s1 = fmaf(h.y, tap[di * 3 + dj].y, s1);
          }
        a[mt][2 * hh + j] = bn_gelu2<EXACT, PLAIN>(s0, s1, s, b);
      }
  }
}

// The expand's products over one channel box of WIDTH (64 or 32) channels:
// A the halo rows from a, B the chunk's w1 rows from w, both K-major with
// the box's swizzle.
template <int WIDTH>
__device__ __forceinline__ void expand_box(float (&d)[32], uint32_t a, uint32_t w) {
#pragma unroll
  for (int kk = 0; kk < WIDTH / 16; ++kk)
    wgmma_m64n64k16_ss(d, desc<WIDTH>(a) + 2 * kk, desc<WIDTH>(w) + 2 * kk);
}

// The tile schedule: tile t -> image, first output row and column.  Tiles
// are image-major, the column tile fastest.
struct Tiles {
  int H, W, ty, tx;
  __host__ __device__ long count(int B) const { return (long)B * ty * tx; }
  __device__ void decode(int t, int& b, int& y0, int& x0) const {
    x0 = (t % tx) * kTile;
    t /= tx;
    y0 = (t % ty) * kTile;
    b = t / ty;
  }
};

template <int C, bool EXACT, bool PLAIN>
__global__ void __launch_bounds__(kThreads, 1)
mbconv_sm90(const __grid_constant__ CUtensorMap x0_map, const __grid_constant__ CUtensorMap x1_map,
            const __grid_constant__ CUtensorMap w10_map, const __grid_constant__ CUtensorMap w11_map,
            const __grid_constant__ CUtensorMap w3_map, const __grid_constant__ CUtensorMap w2_map,
            const __grid_constant__ CUtensorMap sb1_map, const __grid_constant__ CUtensorMap sb2_map,
            const bf16* __restrict__ x, const float* __restrict__ sb3, bf16* __restrict__ out,
            const Tiles tl, int tiles, int E) {
  using L = Layout<C>;
  using X = Boxes<C>;
  constexpr int S = L::S;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t halo_full = base + L::bar, halo_empty = halo_full + 8;
  auto full = [&](int s) { return halo_full + 16 + 8 * s; };
  auto empty = [&](int s) { return halo_full + 16 + 8 * S + 8 * s; };
  auto slot = [&](int s) { return base + L::ring + s * L::slot; };
  const int chunks = E / kEc;

  if (threadIdx.x == 0) {
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, 8);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = (threadIdx.x - kConsumers) / 32;
    if ((threadIdx.x & 31) != 0) return;
    if (warp == 0) {  // each tile's halo, once the last one is released
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        int b, y0, x0;
        tl.decode(t, b, y0, x0);
        if (n > 0) mbar_wait(halo_empty, (n - 1) & 1);
        mbar_expect_tx(halo_full, kHw * kHw * 2 * C);
        tma_load_4d(base + L::halo_box(0), &x0_map, halo_full, 0, x0 - 1, y0 - 1, b);
        if constexpr (X::n == 2)
          tma_load_4d(base + L::halo_box(1), &x1_map, halo_full, 64, x0 - 1, y0 - 1, b);
      }
    } else if (warp == 1) {  // the ring of E-chunks, the same for every tile
      RingPos pos;
      bool wrapped = false;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int e = 0; e < chunks; ++e) {
          if (wrapped) mbar_wait(empty(pos.slot), pos.phase ^ 1);
          const uint32_t s = slot(pos.slot), bar = full(pos.slot);
          mbar_expect_tx(bar, L::slot_tx);
          tma_load(s + L::w1_box(0), &w10_map, bar, 0, e * kEc, 0);
          if constexpr (X::n == 2) tma_load(s + L::w1_box(1), &w11_map, bar, 64, e * kEc, 0);
          tma_load(s + L::w3, &w3_map, bar, e * kEc, 0, 0);
          tma_load(s + L::w2, &w2_map, bar, e * kEc, 0, 0);
          tma_load(s + L::sb1, &sb1_map, bar, e * kEc, 0, 0);
          tma_load(s + L::sb2, &sb2_map, bar, e * kEc, 0, 0);
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
  const uint32_t hbuf = base + L::h(c);
  const bf16* hg = reinterpret_cast<const bf16*>(gbase + L::h(c));
  const int oy = 2 * warp, ox = 2 * g;  // this thread's 2 x 2 pixels in its group's rows
  RingPos ring;
  int n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    int b, y0, x0;
    tl.decode(t, b, y0, x0);
    // this thread's expand rows lr + 8 j of each m-tile: inside the image?
    bool in[3][2];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = kGroupStart * c + 64 * mi + 16 * warp + g + 8 * j;  // halo pixel
        const int iy = y0 - 1 + p / kHw, ix = x0 - 1 + p % kHw;
        in[mi][j] = iy >= 0 && iy < tl.H && ix >= 0 && ix < tl.W;
      }
    float acc[2][C / 2];  // the project GEMM's sums: m-tiles mt = 0, 1
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) zero(acc[mt]);
    mbar_wait(halo_full, n & 1);

    for (int e = 0; e < chunks; ++e) {
      mbar_wait(full(ring.slot), ring.phase);
      const uint32_t s = slot(ring.slot);
      const float* w2 = reinterpret_cast<const float*>(gbase + (s - base) + L::w2);
      const float* sb1 = reinterpret_cast<const float*>(gbase + (s - base) + L::sb1);
      const float* sb2 = reinterpret_cast<const float*>(gbase + (s - base) + L::sb2);
      // 1. The expand of the group's three m-tiles from the halo: m-tiles 0
      //    and 1 issued together, m-tile 0's epilogue under m-tile 1's
      //    products, then m-tile 2 into m-tile 0's registers.
      auto issue = [&](float (&d)[32], int mi) {
        const int row0 = kGroupStart * c + 64 * mi;
        expand_box<X::width(0)>(d, base + L::halo_box(0) + row0 * X::row_bytes(0), s + L::w1_box(0));
        if constexpr (X::n == 2)
          expand_box<X::width(1)>(d, base + L::halo_box(1) + row0 * X::row_bytes(1), s + L::w1_box(1));
        wgmma_commit();
      };
      float d0[32], d1[32];
      zero(d0);
      zero(d1);
      fence_regs(d0);
      fence_regs(d1);
      group_sync(c);  // the group's reads of the last chunk are done
      wgmma_fence();
      issue(d0, 0);
      issue(d1, 1);
      wgmma_wait<1>();
      fence_regs(d0);
      expand_epilogue<EXACT, PLAIN>(d0, hbuf, 16 * warp + g, in[0], sb1, cc);
      zero(d0);
      fence_regs(d0);
      wgmma_fence();
      issue(d0, 2);
      wgmma_wait<1>();
      fence_regs(d1);
      expand_epilogue<EXACT, PLAIN>(d1, hbuf, 64 + 16 * warp + g, in[1], sb1, cc);
      wgmma_wait<0>();
      fence_regs(d0);
      expand_epilogue<EXACT, PLAIN>(d0, hbuf, 128 + 16 * warp + g, in[2], sb1, cc);
      if (e == chunks - 1) release(halo_empty);
      group_sync(c);  // the chunk is complete in shared memory

      // 2. The depthwise, BN2 and GELU of each k-step as the A fragments of
      // 3. the project GEMM, issued k-step by k-step.
      const uint64_t w3d = desc<64>(s + L::w3);
      uint32_t a[4][2][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        depthwise_ks<EXACT, PLAIN>(hg, w2, sb2, oy, ox, ks, cc, a[ks]);
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) wgmma_rs_k<C>(acc[mt], a[ks][mt], w3d + 2 * ks);
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) fence_regs(acc[mt]);
      release(empty(ring.slot));
      ring.next(S);
    }

    // 4. BN3, the residual and the last GELU: pixel (oy + mt, ox + j) of
    //    the group's rows is row g + 8 j of m-tile mt.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int py = y0 + kGroupRows * c + oy + mt, px = x0 + ox + j;
        if (py >= tl.H || px >= tl.W) continue;
        const long at = (((long)b * tl.H + py) * tl.W + px) * C + 2 * cc;
#pragma unroll
        for (int u = 0; u < C / 8; ++u) {
          const float2 s3 = __ldg(reinterpret_cast<const float2*>(sb3 + 8 * u + 2 * cc));
          const float2 b3 = __ldg(reinterpret_cast<const float2*>(sb3 + C + 8 * u + 2 * cc));
          const float v0 = acc[mt][4 * u + 2 * j], v1 = acc[mt][4 * u + 2 * j + 1];
          float2 p;  // PLAIN: s3 (ones) unread, nothing rounded before the GELU
          if constexpr (PLAIN) p = make_float2(v0 + b3.x, v1 + b3.y);
          else p = round2(fmaf(v0, s3.x, b3.x), fmaf(v1, s3.y, b3.y));
          const float2 xv = widen2(__ldg(reinterpret_cast<const unsigned int*>(x + at + 8 * u)));
          float2 r;
          if constexpr (PLAIN) r = make_float2(xv.x + p.x, xv.y + p.y);
          else r = round2(xv.x + p.x, xv.y + p.y);
          *reinterpret_cast<uint32_t*>(out + at + 8 * u) =
              pack_bf16(gelu<EXACT>(r.x), gelu<EXACT>(r.y));
        }
      }
  }
}

// A 4D tensor map over x (B, H, W, C) bf16: boxes of (box_c channels, the
// 18 x 18 halo, one image) in the swizzle of box_c channels' bytes.
cudaError_t encode_halo(CUtensorMap* map, const void* x, int B, int H, int W, int C, int box_c) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, kHw, kHw, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_c == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int C, bool EXACT, bool PLAIN>
cudaError_t launch(const CUtensorMap (&maps)[8], const void* x, const void* sb3, void* out,
                   const Tiles& tl, int tiles, int E, int grid, cudaStream_t stream) {
  static bool opted_in = false;  // one per instance, and this library's own
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(mbconv_sm90<C, EXACT, PLAIN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Layout<C>::bytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  mbconv_sm90<C, EXACT, PLAIN><<<grid, kThreads, Layout<C>::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      static_cast<const bf16*>(x), static_cast<const float*>(sb3), static_cast<bf16*>(out), tl,
      tiles, E);
  return cudaGetLastError();
}

// One call: x and out (B, H, W, C) bf16, w1t (E, C) and w3t (C, E) bf16,
// w2 (9, E), sb1, sb2 (2, E) and sb3 (2, C) f32, each contiguous with a
// 16-byte aligned base; E a multiple of 64, at most 2^31 - 1 tiles.
//   PLAIN = false (K10): (s, b) pairs are folded BatchNorms, rounded as
//     the note above says; exact picks the erf GELU.
//   PLAIN = true (K12): the scales are ones and are not read; GELU reads
//     the f32 sums + b unrounded, the residual is added in f32 to the
//     unrounded projection, and only GELU's outputs are rounded; the taps
//     are used as given (f32).  The tanh GELU only.
// The grid: persistent blocks, one an SM, each loading its next tile's
// halo under this one's last depthwise (K10, K12b); or, with
// one_tile_a_block, a block for each tile, which loads its halo, waits and
// computes (K12a).  Every tile is computed by the same code in the same
// order either way, so the two grids give the same bits.
template <int C, bool PLAIN = false>
cudaError_t run(const void* x, const void* w1t, const void* sb1, const void* w2, const void* sb2,
                const void* w3t, const void* sb3, void* out, int B, int H, int W, int E,
                bool exact, cudaStream_t stream, bool one_tile_a_block = false) {
  using X = Boxes<C>;
  Tiles tl{H, W, (H + kTile - 1) / kTile, (W + kTile - 1) / kTile};
  const long tiles = tl.count(B);
  if (tiles > 0x7fffffffL || E < kEc || E % kEc || (PLAIN && exact)) return cudaErrorInvalidValue;
  const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  auto sw = [](int width) { return width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B; };
  CUtensorMap maps[8];  // x box 0, x box 1, w1 box 0, w1 box 1, w3, w2, sb1, sb2
  cudaError_t e = encode_halo(&maps[0], x, B, H, W, C, X::width(0));
  if (e == cudaSuccess) e = X::n == 2 ? encode_halo(&maps[1], x, B, H, W, C, X::width(1)) : e;
  if (e == cudaSuccess) e = encode_3d(&maps[2], BF, 2, w1t, C, E, 1, X::width(0), kEc, sw(X::width(0)));
  if (e == cudaSuccess && X::n == 2)
    e = encode_3d(&maps[3], BF, 2, w1t, C, E, 1, X::width(1), kEc, sw(X::width(1)));
  if (e == cudaSuccess) e = encode_3d(&maps[4], BF, 2, w3t, E, C, 1, kEc, C, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess) e = encode_3d(&maps[5], F32, 4, w2, E, 9, 1, kEc, 9, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess) e = encode_3d(&maps[6], F32, 4, sb1, E, 2, 1, kEc, 2, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess) e = encode_3d(&maps[7], F32, 4, sb2, E, 2, 1, kEc, 2, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (X::n == 1) {
    maps[1] = maps[0];
    maps[3] = maps[2];
  }
  int grid = (int)tiles;
  if (!one_tile_a_block) {
    int sms = 0;
    if (e == cudaSuccess) e = sm_count(&sms);
    grid = tiles < sms ? (int)tiles : sms;
  }
  if (e != cudaSuccess) return e;
  if constexpr (PLAIN)
    return launch<C, false, true>(maps, x, sb3, out, tl, (int)tiles, E, grid, stream);
  else
    return exact ? launch<C, true, false>(maps, x, sb3, out, tl, (int)tiles, E, grid, stream)
                 : launch<C, false, false>(maps, x, sb3, out, tl, (int)tiles, E, grid, stream);
}

}  // namespace
}  // namespace mb90
}  // namespace gg
