// Building blocks shared by K1 (mha_fwd.cu) and K1ᵇ (mha_bwd.cu): bf16
// tensor-core products with mma.sync m16n8k16, operands from shared memory
// by ldmatrix (.trans where the product contracts over the tile's rows, so
// no transpose is ever staged), tiles copied in with cp.async into a ring
// of stages, and exp as one ex2.approx.
//
// Tiles are [rows][D] bf16 in shared memory with each row padded by 8
// elements (16 bytes): a row is 80 bytes at D = 32 and 144 at D = 64, so
// the eight 16-byte rows that one ldmatrix phase reads fall in distinct
// banks.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t. The
// C fragment c[0..1] is row g, columns 2t and 2t + 1; c[2..3] is row g + 8.
// The A fragment a[0] is (row g, k 2t..2t+1), a[1] (row g + 8, k 2t..),
// a[2] (row g, k 2t+8..), a[3] (row g + 8, k 2t+8..). So the C fragments of
// two neighbouring n-tiles, rounded to bf16 pairs, are one A fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mha {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x in one SFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16 (round to nearest even); the
// lower 16 bits hold the element with the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row stride of a staged tile, in elements.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
};

// Copy rows [row0, row0 + R) of a [*, D] bf16 matrix into a padded tile,
// 16 bytes a cp.async, spread over the block's T threads.
template <int D, int R, int T>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int row0) {
  constexpr int kChunks = R * D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kChunks; i += T) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    cp_async16(smem_u32(tile + row * Tile<D>::kStride + col),
               src + (size_t)(row0 + row) * D + col);
  }
}

// Copy R f32 values from src + row0 (R a multiple of 4).
template <int R, int T>
__device__ __forceinline__ void load_row_stat(float* dst, const float* src,
                                              int row0) {
#pragma unroll
  for (int i = threadIdx.x; i < R / 4; i += T)
    cp_async16(smem_u32(dst + 4 * i), src + row0 + 4 * i);
}

// A fragments of the 16 rows r and r + 8 (r = 16-row tile start + g) of a
// [*, D] bf16 matrix in global memory, all of D.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const bf16* base, int r, int t) {
  const bf16* ra = base + (size_t)r * D;
  const bf16* rb = ra + 8 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = ld32(ra + c);
    f[kk][1] = ld32(rb + c);
    f[kk][2] = ld32(ra + c + 8);
    f[kk][3] = ld32(rb + c + 8);
  }
}

// Lane offsets (row, column) into a tile for ldsm4 of the B operand of two
// n-tiles (16 rows n0.., columns k0..k0+15 of a [n][k] tile): matrices
// (n0, k0), (n0, k0 + 8), (n0 + 8, k0), (n0 + 8, k0 + 8) give b0, b1 of
// n-tile 0 and b0, b1 of n-tile 1.
__device__ __forceinline__ int ldsm_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int ldsm_col(int lane) {
  return ((lane >> 3) & 1) << 3;
}
// ... and for ldsm4_t of the B operand from a [k][n] tile (16 rows k0..,
// columns n0..n0+15): matrices (k0, n0), (k0 + 8, n0), (k0, n0 + 8),
// (k0 + 8, n0 + 8) give b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
__device__ __forceinline__ int ldsm_t_row(int lane) {
  return (lane & 7) + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int ldsm_t_col(int lane) {
  return (lane >> 4) << 3;
}

// c[mt][n] (16 rows x 16 columns of m-tile mt, C fragments) = A[mt] (16 x
// D, fragments) . B^T over 16 rows of a [n][D] tile starting at ``rows``
// (``lane_off`` = ldsm_row * stride + ldsm_col).
template <int D, int MT>
__device__ __forceinline__ void product_nt(float (&c)[MT][2][4],
                                           const uint32_t (&a)[MT][D / 16][4],
                                           const bf16* rows, int lane_off) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      c[mt][n][0] = c[mt][n][1] = c[mt][n][2] = c[mt][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldsm4(b, smem_u32(rows + lane_off + kk * 16));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(c[mt][0], a[mt][kk], b[0], b[1]);
      mma(c[mt][1], a[mt][kk], b[2], b[3]);
    }
  }
}

// The A fragment (16 rows x 16 columns) of bf16(x) for x in C-fragment
// layout over two n-tiles.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// acc[mt] (16 x D) += A[mt] (16 x 16) . B (16 rows of a [k][D] tile
// starting at ``rows``, ``lane_off`` = ldsm_t_row * stride + ldsm_t_col).
template <int D, int MT>
__device__ __forceinline__ void accumulate_nn(float (&acc)[MT][D / 8][4],
                                              const uint32_t (&a)[MT][4],
                                              const bf16* rows, int lane_off) {
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    uint32_t b[4];
    ldsm4_t(b, smem_u32(rows + lane_off + dn * 16));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(acc[mt][2 * dn], a[mt], b[0], b[1]);
      mma(acc[mt][2 * dn + 1], a[mt], b[2], b[3]);
    }
  }
}

// Rows r and r + 8 of a [*, D] bf16 matrix from acc * mul[0] (row r) and
// acc * mul[1] (row r + 8).
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, int r, int t,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1) {
  bf16* ra = base + (size_t)r * D;
  bf16* rb = ra + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ra + c) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(rb + c) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// As store_rows, in f32 (no rounding).
template <int D>
__device__ __forceinline__ void store_rows_f32(float* base, int r, int t,
                                               const float (&acc)[D / 8][4],
                                               float mul0, float mul1) {
  float* ra = base + (size_t)r * D;
  float* rb = ra + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(ra + c) =
        make_float2(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<float2*>(rb + c) =
        make_float2(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// One stage of a cp.async ring of NST stages: before the block computes on
// item i, wait for it and (one barrier) for every thread to have finished
// item i - 1, whose stage then takes item i + NST - 1. ``issue(j)`` copies
// item j (if it exists) and always commits a group, so that the count of
// groups in flight stays NST - 1.
template <int NST, class Issue>
__device__ __forceinline__ int ring_advance(int i, Issue&& issue) {
  cp_async_wait<NST - 2>();
  __syncthreads();
  issue(i + NST - 1);
  return i % NST;
}

// Let ``kernel`` take ``bytes`` of dynamic shared memory on ``device``
// (needed above 48 KB), once per device: ``done`` is the caller's own.
inline cudaError_t allow_smem(const void* kernel, int bytes, int device,
                              bool (&done)[64]) {
  if (bytes <= 48 * 1024 || (device < 64 && done[device])) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

}  // namespace mha
