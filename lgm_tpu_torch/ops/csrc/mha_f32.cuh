// Building blocks of K1 (mha_fwd_f32.cu) and K1ᵇ (mha_bwd_f32.cu) on f32
// inputs, at head dim D = 32 or 64: products on the tensor cores at f32
// grade by 3xTF32 on mma.sync m16n8k8, tiles copied in with cp.async
// through a ring of stages, exp as one ex2.approx (mha_wgmma.cuh).
//
// 3xTF32: an f32 operand x is split into hi = tf32(x) (round to nearest,
// 11 significant bits) and lo = tf32(x - hi), so x = hi + lo to about
// 2^-22 of |x|; a product a.b is taken as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b (the small terms first), each by the tensor cores with f32
// accumulation. The lo_a.lo_b term left out is about 2^-22 of |a b|. One
// pass of TF32 (hi only, 2^-11) is used where only the size of a logit
// matters: the row max that shifts the exponentials (mha_fwd_f32.cu).
//
// Tiles are [rows][D] f32 in shared memory, each row padded by 4 floats
// (a row is D + 4 floats, 4 mod 32 banks), so both reads of a B operand
// are free of bank conflicts: row g, column t (the contraction over D) at
// banks 4 g + t, and row 2 t (+ 1), column g (the contraction over the
// rows) at banks 8 t + g (+ 4).
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + t.
// A (16 x 8): a[0] = (row g, k t), a[1] = (g + 8, t), a[2] = (g, t + 4),
// a[3] = (g + 8, t + 4). B (8 x 8): b0 = (k t, column g), b1 = (k t + 4,
// g). C (16 x 8): c[0..1] = row g, columns 2 t and 2 t + 1; c[2..3] = row
// g + 8. A product that contracts over the 8 columns of a C fragment (P.V,
// dS.K, P^T.dO, dS^T.Q) takes the C fragment as its A operand with the
// k index permuted: k t is column 2 t and k t + 4 is column 2 t + 1, so A
// = {c[0], c[2], c[1], c[3]} and B reads rows 2 t and 2 t + 1 of the tile.
// The sum over the 8 columns is the same sum in another order.

#pragma once

#include "mha_wgmma.cuh"

namespace mha {
namespace f32 {

constexpr int kTile = 64;   // rows (keys or queries) a staged tile
constexpr int kStages = 2;  // stages of the cp.async ring

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  static constexpr int kStride = D + 4;               // floats a row
  static constexpr int kFloats = kTile * kStride;     // a tile
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// As split, computed where it stands: the compiler may not hoist it out of
// a loop, so a loop-invariant operand keeps its one f32 register instead
// of two TF32 halves held across the loop.
__device__ __forceinline__ void split_here(float x, uint32_t& hi,
                                          uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm volatile("cvt.rna.tf32.f32 %0, %1;"
               : "=r"(lo)
               : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b at f32 grade (3xTF32), a split into (ah, al) already; with
// Exact false, c += ah.tf32(b).
template <bool Exact>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if (Exact) {
    mma(c, al, bh0, bh1);
    mma(c, ah, bl0, bl1);
  }
  mma(c, ah, bh0, bh1);
}

// The TF32 halves of an A fragment (split_here where Here).
template <bool Here>
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (Here)
      split_here(a[i], ah[i], al[i]);
    else
      split(a[i], ah[i], al[i]);
  }
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

// Copy rows [row0, row0 + kTile) of a [*, D] f32 matrix into a padded
// tile, 16 bytes a cp.async, spread over the block's T threads.
template <int D, int T>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int row0) {
  constexpr int kChunks = kTile * D / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kChunks; i += T) {
    const int row = i / (D / 4), col = (i % (D / 4)) * 4;
    cp_async16(smem_u32(tile + row * Tile<D>::kStride + col),
               src + (size_t)(row0 + row) * D + col);
  }
}

// Copy kTile f32 values from src + row0.
template <int T>
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          int row0) {
  for (int i = threadIdx.x; i < kTile / 4; i += T)
    cp_async16(smem_u32(dst + 4 * i), src + row0 + 4 * i);
}

// One stage of a cp.async ring of NST stages: before the block computes on
// item i, wait for it and (one barrier) for every thread to have finished
// item i - 1, whose stage then takes item i + NST - 1. ``fetch(j)`` copies
// item j (if it exists) and always commits a group, so that the count of
// groups in flight stays NST - 1. Returns item i's stage.
template <int NST, class Fetch>
__device__ __forceinline__ int ring_advance(int i, Fetch&& fetch) {
  cp_async_wait<NST - 2>();
  __syncthreads();
  fetch(i + NST - 1);
  return i % NST;
}

// The A fragments of rows r and r + 8 of a [*, D] f32 matrix, all of D,
// from global memory (``row`` points at row r).
template <int D>
__device__ __forceinline__ void load_a(float (&a)[D / 8][4], const float* row,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    a[kk][0] = row[8 * kk + t];
    a[kk][1] = row[8 * D + 8 * kk + t];
    a[kk][2] = row[8 * kk + t + 4];
    a[kk][3] = row[8 * D + 8 * kk + t + 4];
  }
}

// c[n] = A.B^T for N n-tiles of 8 tile rows each (tile rows 8 n .. + 7 from
// ``rows``), contracted over D: 3xTF32 where Exact, else one TF32 pass.
// A's fragments are split into TF32 halves at each call where Here (a
// loop-invariant A then holds one register an element, not two).
template <int D, int N, bool Exact, bool Here = false>
__device__ __forceinline__ void product_nt(float (&c)[N][4],
                                           const float (&a)[D / 8][4],
                                           const float* rows, int g, int t) {
  constexpr int RS = Tile<D>::kStride;
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_a<Here>(a[kk], ah, al);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float* b = rows + (8 * n + g) * RS + 8 * kk + t;
      mma3<Exact>(c[n], ah, al, b[0], b[4]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
}

// acc[dn] += X.B, 3xTF32: X the C fragments x[n] (16 rows x 8 columns
// each), contracted with the 8 N tile rows from ``rows`` (8 n .. + 7 for
// x[n], in the permuted order of the header note), B the tile's columns
// 8 dn .. + 7. The step's products are summed on the tensor cores from 0
// and then added to acc by one rounded f32 add an element: the tensor
// cores' f32 accumulation does not round to nearest, so a long sum kept
// there (3 products an 8-row step, over thousands of rows) drifts by
// about 1e-5 of its size, where rounded adds stay at f32 grade.
template <int D, int N>
__device__ __forceinline__ void accumulate_nn(float (&acc)[D / 8][4],
                                              const float (&x)[N][4],
                                              const float* rows, int g,
                                              int t) {
  constexpr int RS = Tile<D>::kStride;
  float part[D / 8][4];
  zero<D>(part);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float a[4] = {x[n][0], x[n][2], x[n][1], x[n][3]};
    uint32_t ah[4], al[4];
    split_a<false>(a, ah, al);
    const float* b = rows + (8 * n + 2 * t) * RS + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      mma3<true>(part[dn], ah, al, b[8 * dn], b[RS + 8 * dn]);
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = __fadd_rn(acc[dn][e], part[dn][e]);
}

// Rows r and r + 8 of a [*, D] f32 matrix (``row`` points at row r) from
// acc * mul0 (row r) and acc * mul1 (row r + 8).
template <int D>
__device__ __forceinline__ void store_rows(float* row, int t,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = 8 * dn + 2 * t;
    *reinterpret_cast<float2*>(row + c) =
        make_float2(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<float2*>(row + 8 * D + c) =
        make_float2(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

}  // namespace f32
}  // namespace mha
