// Kernel K1: full (unmasked) multi-head attention forward for the U-Net's
// cross-view MVAttention, bf16 in and out.
//
// Replaces lgm_tpu/ops/mha.py::_fwd_kernel (via _mha_fwd / mha_kresident),
// the TPU's K-resident Pallas kernel. The function is the same: per
// (batch*head, query row) the exact softmax of the scaled logits — the row
// max taken over ALL keys before any exponential, no online rescaling —
// with P rounded to bf16 before the P.V product, f32 accumulation, the f32
// row sum of the unrounded P as divisor, and the output rounded to bf16.
//
// The TPU called its kernel only where S >= 2048 (lgm_tpu/models/unet.py:
// 61-62): that gate is a VMEM/HBM decision of that chip (dense XLA
// attention won below it there). The function is the same at every site,
// so the port calls this kernel at every MVAttention site: S = 4096/D = 32,
// S = 1024/D = 64 and S = 256/D = 64 at the big preset.
//
// What bounds it on an H100: 2 * BH * S^2 * D multiply-adds per pass on the
// tensor cores are cheap (16 * 4096^2 * 32 * 4 = 34 GFLOP, ~35 us at 989
// TFLOP/s bf16), but every one of the BH * S^2 logits needs one exp on the
// SFU (16 per clock per SM: 2.7e8 exps, ~65 us). It is exp-bound.
//
// The simple design: one block of 4 warps per (bh, 64-row query tile); each
// warp owns 16 query rows, keeps its Q fragments in registers and streams
// K and V through shared memory 64 keys at a time (V stored transposed so
// that the P.V operand loads are 32-bit words). Two passes over the keys:
// pass 1 forms the logits with mma.sync m16n8k16 (bf16 -> f32) and keeps
// the row max; pass 2 forms them again, exponentiates against the final
// max, sums the f32 P and feeds bf16(P) straight from the accumulator
// registers into the P.V mma (the C fragment of Q.K^T is the A fragment of
// P.V). Recomputing Q.K^T doubles the cheap tensor-core work and keeps the
// exps at one per logit; a later PR can move to wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block (4 warps x 16)
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kPad = 8;   // bf16 padding per shared row: conflict-free loads

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> one register of two bf16 (round to nearest even); the
// lower 16 bits hold the element with the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage keys [key0, key0 + 64) of one head into ks[key][d].
template <int D>
__device__ __forceinline__ void load_k(__nv_bfloat16 (*ks)[D + kPad],
                                       const __nv_bfloat16* kb, int key0) {
  for (int i = threadIdx.x; i < kBK * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&ks[row][col]) =
        *reinterpret_cast<const uint4*>(kb + (size_t)(key0 + row) * D + col);
  }
}

// Stage the same keys' values transposed, vt[d][key], so that the P.V
// B-fragment (two consecutive keys of one d) is one 32-bit word.
template <int D>
__device__ __forceinline__ void load_vt(__nv_bfloat16 (*vt)[kBK + kPad],
                                        const __nv_bfloat16* vb, int key0) {
  for (int i = threadIdx.x; i < kBK * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 raw =
        *reinterpret_cast<const uint4*>(vb + (size_t)(key0 + row) * D + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[col + j][row] = e[j];
  }
}

// Scaled logits of a warp's 16 query rows against the staged key tile, in
// C-fragment layout: s[n][0..1] row g, s[n][2..3] row g + 8, key columns
// n * 8 + 2t and + 1.
template <int D>
__device__ __forceinline__ void logits(float (&s)[kBK / 8][4],
                                       const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16 (*ks)[D + kPad],
                                       int g, int t, float scale) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + 2 * t];
      const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
      mma_bf16_16816(s[n], qf[kk], b);
    }
  }
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= scale;
}

template <int D>
__global__ void __launch_bounds__(128)
mha_fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kBK + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const size_t base = (size_t)blockIdx.y * S * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;  // rows r0 and r0 + 8

  // A fragments of this warp's 16 query rows, all of D.
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* qa = q + base + (size_t)r0 * D;
    const __nv_bfloat16* qb = qa + 8 * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = ld32(qa + c);
      qf[kk][1] = ld32(qb + c);
      qf[kk][2] = ld32(qa + c + 8);
      qf[kk][3] = ld32(qb + c + 8);
    }
  }

  float s[kBK / 8][4];

  // Pass 1: exact row max over all keys.
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int key0 = 0; key0 < S; key0 += kBK) {
    __syncthreads();
    load_k<D>(ks, kb, key0);
    __syncthreads();
    logits<D>(s, qf, ks, g, t, scale);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // Pass 2: P = exp(logits - max), f32 row sums, bf16(P) . V.
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int key0 = 0; key0 < S; key0 += kBK) {
    __syncthreads();
    load_k<D>(ks, kb, key0);
    load_vt<D>(vt, vb, key0);
    __syncthreads();
    logits<D>(s, qf, ks, g, t, scale);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = &vt[n * 8 + g][kk * 16 + 2 * t];
        const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16_16816(acc[n], a, b);
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  __nv_bfloat16* oa = o + base + (size_t)r0 * D;
  __nv_bfloat16* ob = oa + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: [BH, S, D] contiguous bf16 on device ``device``; D in {32, 64};
// S a multiple of 64. Launches on ``stream``; returns cudaGetLastError().
int mha_fwd_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                 int S, int D, float scale, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S % kBQ != 0 || (D != 32 && D != 64)) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kBQ, BH);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  if (D == 32)
    mha_fwd_kernel<32><<<grid, 128, 0, st>>>(qq, kk, vv, oo, S, scale);
  else
    mha_fwd_kernel<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, S, scale);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
