// Building blocks of K1 (mha_fwd_wgmma.cu) and K1ᵇ (mha_bwd_wgmma.cu) on
// Hopper, at head dim D = 32 or 64: TMA loads of 64-row boxes of a [rows,
// D] bf16 matrix into swizzled shared memory, completing on mbarriers;
// warpgroup products (wgmma.mma_async m64nNk16, bf16 in, f32 accumulate)
// with B, and A where it is staged, read by the tensor cores from those
// tiles through matrix descriptors, or A from registers.
//
// Layout of a staged tile: a row is 2D bytes (128 at D = 64, 64 at D =
// 32), rows at that stride from a 1024-byte-aligned base, and the row one
// swizzle atom wide: TMA's SWIZZLE_128B at D = 64 (the 16-byte chunk c of
// row r at chunk c ^ (r % 8)), SWIZZLE_64B at D = 32 (chunk c of row r at
// c ^ ((r / 2) % 4)), the descriptor's layout type the same. Either way
// the 8-row groups lie 16 D bytes apart (the SBO: 1024 or 512). Read
// K-major (the contraction over D, S = Q.K^T): D / 16 k-steps of 16
// columns, each at +32 bytes of the start address. Read MN-major (the
// contraction over the rows, P.V): the D columns are the atom's width, and
// the k-step of 16 rows is at +32 D bytes.
//
// Accumulator layout of m64nNk16 (PTX ISA): in warp w of the warpgroup,
// lane 4 g + t holds d[4 j + 0..1] = row 16 w + g, columns 8 j + 2 t and
// + 1, and d[4 j + 2..3] = row 16 w + g + 8 (j < N / 8). The register A
// operand (rows 16 w .. + 15 of a 64 x 16 k-step) is the m16n8k16 A
// fragment, so A of a k-step is the accumulators of two neighbouring
// 8-column groups, rounded to bf16 pairs (``to_a``), whatever N is.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mha {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

namespace wg {

constexpr int kBoxRows = 64;  // rows a TMA box

// A staged [rows, D] bf16 tile.
template <int D>
struct Rows {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  static constexpr int kBytes = 2 * D;                 // a row
  static constexpr int kBoxBytes = kBoxRows * kBytes;  // a 64-row box
  static constexpr int kGroupBytes = 8 * kBytes;       // 8 rows (SBO)
  static constexpr uint64_t kLayout = D == 64 ? 1 : 2;  // 128B : 64B swizzle
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` of ``bar`` has completed. A
// wait that outlasts 2^24 polls (seconds, where a legitimate one takes
// microseconds) traps: a fault in the ring's protocol becomes a launch
// error instead of a kernel that never ends.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// --- TMA --------------------------------------------------------------------

// Box (rows row .. row + 63, all columns) of the matrix ``map`` describes
// into ``dst``, counted on ``bar``'s transaction bytes.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row)
      : "memory");
}

// ``bytes`` (a multiple of 16) contiguous bytes from 16-byte-aligned
// ``src`` into ``dst``, counted on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Matrix descriptor of a swizzled tile of D-column rows at shared address
// ``addr``: 8-row groups 16 D bytes apart (SBO; LBO unused, the rows one
// atom wide), the swizzle of Rows<D>.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(Rows<D>::kGroupBytes >> 4) << 32) |
         (Rows<D>::kLayout << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous product owns across the wait (or the issue).
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128) (+)= A . B^T, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= A . B^T, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) (+)= A . B^T, as mma_ss_n64.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= A . B, A four registers of the m16n8k16 A fragment a
// warp, B MN-major in shared memory (descriptor).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 32) (+)= A . B, as mma_rs_n64.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int accumulate) {
  if constexpr (N == 128) mma_ss_n128(d, a, b, accumulate);
  else if constexpr (N == 64) mma_ss_n64(d, a, b, accumulate);
  else mma_ss_n32(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  if constexpr (N == 64) mma_rs_n64(d, a, b, accumulate);
  else mma_rs_n32(d, a, b, accumulate);
}

// d (64 x N) = A (64 x D, K-major tile at ``a``) . B^T (N x D, K-major
// tile at ``b``): D / 16 k-steps of 16 columns.
template <int N, int D>
__device__ __forceinline__ void product_nt(float (&d)[N / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<N>(d, desc<D>(a + 32 * kk), desc<D>(b + 32 * kk), kk);
}

// acc (64 x D) += A (64 x 16 K steps, register fragments) . B (16 K rows
// a step x D, MN-major tile at ``b``).
template <int K, int D>
__device__ __forceinline__ void accumulate_nn(float (&acc)[D / 2],
                                              const uint32_t (&a)[K][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    mma_rs<D>(acc, a[kk], desc<D>(b + 16 * Rows<D>::kBytes * kk), 1);
}

// The register A fragments (K steps of 16 columns) of bf16(x), x in the
// accumulator layout of a 64 x 16 K product.
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K][4],
                                     const float (&x)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Rows r and r + 8 of a [*, D] matrix from acc (accumulator layout) times
// mul0 (row r) and mul1 (row r + 8), in bf16 or (f32) unrounded.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, int r, int t,
                                           const float (&acc)[D / 2],
                                           float mul0, float mul1) {
  bf16* ra = base + (size_t)r * D;
  bf16* rb = ra + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(ra + c) =
        pack_bf16(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    *reinterpret_cast<uint32_t*>(rb + c) =
        pack_bf16(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}
template <int D>
__device__ __forceinline__ void store_rows(float* base, int r, int t,
                                           const float (&acc)[D / 2],
                                           float mul0, float mul1) {
  float* ra = base + (size_t)r * D;
  float* rb = ra + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(ra + c) =
        make_float2(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    *reinterpret_cast<float2*>(rb + c) =
        make_float2(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}

}  // namespace wg

// --- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime (the
// library links no libcuda); null where the driver has none.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [rows, D] bf16 matrix at ``ptr`` (16-byte aligned),
// read in 64-row boxes into shared memory swizzled as Rows<D> says.
template <int D>
inline cudaError_t rows_map(CUtensorMap* map, const void* ptr, long rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {wg::Rows<D>::kBytes};
  const cuuint32_t box[2] = {D, wg::kBoxRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace mha
