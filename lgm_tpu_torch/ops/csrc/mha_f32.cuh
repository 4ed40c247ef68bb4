// Building blocks of K1 (mha_fwd_f32.cu) and K1ᵇ (mha_bwd_f32.cu) on f32
// inputs, at head dim D = 32 or 64, and of their operand split
// (mha_split_tf32.cu): products on the tensor cores at f32 grade by 3xTF32
// on wgmma.mma_async m64nNk8 (.tf32), tiles loaded by TMA into 128-byte-
// swizzled shared memory on mbarriers (mha_wgmma.cuh).
//
// 3xTF32: an f32 operand x is split into hi = rna(x) (TF32, 10 explicit
// mantissa bits, rounded to nearest with ties away from zero, the low 13
// bits of the f32 pattern zero) and lo = rna(x - hi), so x = hi + lo to
// about 2^-22 of |x|; a product a.b is taken as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b (the small terms first), each by the tensor cores with f32
// accumulation. The lo_a.lo_b term left out is about 2^-22 of |a b|. One
// pass of TF32 (hi only, 2^-11) is used where only the size of a logit
// matters: the row max that shifts the exponentials (mha_fwd_f32.cu).
// The streamed operands are split once a call by the split pass
// (mha_split_tf32.cu) into planes of hi and of lo; P and dS are split in
// registers where they are made.
//
// TF32 wgmma reads A and B K-major only (no transpose for .tf32). So a
// product over D (Q.K^T, dO.V^T, K.Q^T, V.dO^T) reads the row-major
// [rows][D] planes as they are, and a product over the rows (P.V, dS.K,
// P^T.dO, dS^T.Q) reads a transposed [D][rows] plane of V, K, dO or Q.
//
// Shared-memory layout of a K-major f32 tile (the same whether its rows
// are the M or N dim and its columns D or keys): 32-column blocks (128
// bytes a row: one swizzle atom), each block rows x 128 bytes from a
// 1024-byte-aligned base, TMA's SWIZZLE_128B (the 16-byte chunk c of row r
// at chunk c ^ (r % 8)), the descriptor's layout type the same, 8-row
// groups 1024 bytes apart (SBO). A k-step of 8 columns (32 bytes) is at
// +32 bytes inside its block: k-step kk at block kk / 4, + (kk % 4) 32.
// A row-major tile at D = 32 is one block (as a bf16 tile at D = 64), at
// D = 64 two; a transposed tile of 32 keys is one block of D rows.
//
// Fragment layouts (PTX ISA, wgmma m64nNk8 .tf32; lane = 4 g + t, warp w of
// the warpgroup): the accumulator d[4 j + 0..1] = row 16 w + g, columns
// 8 j + 2 t and + 1, d[4 j + 2..3] = row 16 w + g + 8; the register A
// fragment of a k-step a[0] = (row 16 w + g, k t), a[1] = (+ 8, k t), a[2]
// = (g, k t + 4), a[3] = (g + 8, k t + 4). A product that contracts over
// the 8 columns of an accumulator group (P.V, dS.K, P^T.dO, dS^T.Q) takes
// the accumulators as its A operand with the k index permuted: k t is
// column 2 t and k t + 4 is column 2 t + 1, so A = {d[0], d[2], d[1],
// d[3]}, and the B operand's k-row p must be the row kPerm[p] of its
// 8-row group, {0, 2, 4, 6, 1, 3, 5, 7}: the split pass writes each 8-row
// group of a transposed plane in that order. The sum over the 8 rows is
// the same sum in another order.

#pragma once

#include "mha_wgmma.cuh"

namespace mha {
namespace tf32 {

constexpr int kRows = 32;          // rows (keys or queries) a streamed tile
constexpr int kBlock = kRows * 128;  // a 32-column block of such a tile
// Shared memory a block may take (227 KB) less the alignment slack and
// the barriers.
constexpr int kSmemMax = 232448;
constexpr int kSmemSlack = 2048;

// Row p of a transposed plane's 8-row group holds row kPerm[p] (header).
__host__ __device__ constexpr int perm8(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// rna(x) as TF32 in an f32 pattern: the magnitude rounded to nearest at
// bit 13, ties away from zero, the low 13 bits cleared (the plain version,
// ops/mha.py::tf32_rna, does the same integer arithmetic).
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// Matrix descriptor of a K-major f32 tile at shared address ``addr``
// (header: 128-byte swizzle, 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The byte offset of k-step kk (8 columns) in a K-major tile whose
// 32-column blocks are ``block`` bytes apart.
__device__ __forceinline__ constexpr uint32_t kstep(int kk, int block) {
  return (uint32_t)((kk >> 2) * block + (kk & 3) * 32);
}

// d (64 x 32) (+)= A . B^T, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) (+)= A . B, A the four registers of a k-step's fragment a
// warp, B K-major in shared memory.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= A . B, as mma_rs_n32.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  if constexpr (N == 64) mma_rs_n64(d, a, b, accumulate);
  else mma_rs_n32(d, a, b, accumulate);
}

// d (64 x 32) = A (64 rows x D, K-major, 32-column blocks ``ablock`` bytes
// apart) . B^T (32 rows x D, blocks kBlock apart), contracted over D: the
// three 3xTF32 products from the halves' tiles (lo.hi, hi.lo, hi.hi) where
// Exact, else hi.hi alone. Issued, not committed.
template <int D, bool Exact>
__device__ __forceinline__ void product_nt(float (&d)[16], uint32_t a_hi,
                                           uint32_t a_lo, int ablock,
                                           uint32_t b_hi, uint32_t b_lo) {
  if (Exact) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma_ss_n32(d, desc(a_lo + kstep(kk, ablock)),
                 desc(b_hi + kstep(kk, kBlock)), kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma_ss_n32(d, desc(a_hi + kstep(kk, ablock)),
                 desc(b_lo + kstep(kk, kBlock)), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss_n32(d, desc(a_hi + kstep(kk, ablock)),
               desc(b_hi + kstep(kk, kBlock)), Exact || kk > 0);
}

// part (64 x D) = X . B from 0, 3xTF32: X the register fragments of four
// k-steps (32 rows) split into halves (xh, xl), B a transposed tile (D
// rows x 32 permuted rows, one block) of halves (b_hi, b_lo). Issued, not
// committed.
template <int D>
__device__ __forceinline__ void product_nn(float (&part)[D / 2],
                                           const uint32_t (&xh)[4][4],
                                           const uint32_t (&xl)[4][4],
                                           uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<D>(part, xl[kk], desc(b_hi + 32 * kk), kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<D>(part, xh[kk], desc(b_lo + 32 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<D>(part, xh[kk], desc(b_hi + 32 * kk), 1);
}

// The register A fragments, split into halves, of a 64 x 32 accumulator
// tile x, the k index permuted (header).
__device__ __forceinline__ void to_a(uint32_t (&xh)[4][4],
                                     uint32_t (&xl)[4][4],
                                     const float (&x)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(x[4 * kk], xh[kk][0], xl[kk][0]);
    split(x[4 * kk + 2], xh[kk][1], xl[kk][1]);
    split(x[4 * kk + 1], xh[kk][2], xl[kk][2]);
    split(x[4 * kk + 3], xh[kk][3], xl[kk][3]);
  }
}

// acc += part, one rounded f32 add an element: the tensor cores' f32
// accumulation does not round to nearest, so a long sum kept there
// (thousands of rows) drifts by about 1e-5 of its size, where a step's
// products summed there from 0 and added here stay at f32 grade.
template <int N>
__device__ __forceinline__ void add_rn(float (&acc)[N],
                                      const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// Box of 32 columns (x .. x + 31) and ``map``'s box rows (y ..) into
// ``dst``, counted on ``bar``'s transaction bytes.
__device__ __forceinline__ void tma(void* dst, const CUtensorMap* map,
                                    uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// ``rows`` rows from row y of a row-major [*, D] plane (boxes of 32 x 32)
// into a K-major tile whose 32-column blocks are rows x 128 bytes apart.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int y, int rows) {
#pragma unroll
  for (int cb = 0; cb < D / 32; ++cb)
    for (int rb = 0; rb < rows / kRows; ++rb)
      tma(dst + cb * rows * 128 + rb * kBlock, map, bar, 32 * cb,
          y + kRows * rb);
}

}  // namespace tf32

// --- host: tensor maps of the f32 planes ------------------------------------

// The tensor map of an f32 matrix at ``ptr`` (16-byte aligned) of ``outer``
// rows of ``inner`` floats, read in boxes of 32 floats x ``box_rows`` rows
// into 128-byte-swizzled shared memory (mha_f32.cuh's tile layout): a
// row-major plane [BH rows, D] (box rows 32) or a transposed plane [BH D,
// rows] (box rows D).
inline cudaError_t f32_map(CUtensorMap* map, const void* ptr, long inner,
                           long outer, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The hi and lo planes of one operand: a row-major pair ([BH, R, D]) or a
// transposed pair ([BH, D, R], rows permuted in 8-row groups).
struct PlaneMaps {
  CUtensorMap hi, lo;
};

inline cudaError_t rows_maps(PlaneMaps* m, const void* hi, const void* lo,
                             int BH, int R, int D) {
  cudaError_t err = f32_map(&m->hi, hi, D, (long)BH * R, tf32::kRows);
  if (err == cudaSuccess) err = f32_map(&m->lo, lo, D, (long)BH * R,
                                        tf32::kRows);
  return err;
}

inline cudaError_t cols_maps(PlaneMaps* m, const void* hi, const void* lo,
                             int BH, int R, int D) {
  cudaError_t err = f32_map(&m->hi, hi, R, (long)BH * D, D);
  if (err == cudaSuccess) err = f32_map(&m->lo, lo, R, (long)BH * D, D);
  return err;
}

}  // namespace mha
