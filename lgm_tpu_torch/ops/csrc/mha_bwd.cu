// Kernel K1 backward (K1ᵇ): gradients of full (unmasked) multi-head
// attention for the U-Net's cross-view MVAttention, bf16 in and out.
//
// Replaces lgm_tpu/ops/mha.py::_bwd_kernel (via _mha_bwd, the VJP of
// mha_kresident), the TPU's fused one-pass backward. The function is the
// same: from the residuals q, k, v, o and the cotangent dO, per
// (batch*head) it recomputes the exact softmax of the scaled logits (row
// max over ALL keys, then the f32 row sum; no online rescaling), the
// normalized f32 P, dP = dO.V^T, D = rowsum(dO o O) in f32 and
// dS = P o (dP - D); dO, dS and P are rounded to bf16 before their
// products, every product accumulates in f32, and
//   dq = dS.K * scale,  dK = dS^T.Q * scale,  dV = P^T.dO
// are rounded to bf16.
//
// What bounds it on an H100: 8 * BH * S^2 * D tensor-core multiply-adds
// (Q.K^T twice, dO.V^T twice, dS.K, dS^T.Q, P^T.dO; 2 flops each) are
// cheap next to the exponentials: the simple design below evaluates
// exp(logit - max) three times per logit (row sum, dq pass, dK/dV pass),
// against one in the least work, on the SFUs (16 per clock per SM). It is
// exp- and latency-bound.
//
// The simple design, two kernels because dK and dV sum over every query
// block (the TPU carried them in VMEM scratch across its sequential grid;
// blocks here run in parallel and in no order):
//  (a) one block of 4 warps per (bh, 64-row query tile), each warp owning
//      16 query rows with Q and dO fragments in registers (mha_fwd.cu's
//      mma.sync m16n8k16 fragment layout). Pass 1 takes the exact row max,
//      pass 2 the f32 row sum, then D = rowsum(dO o O); the three row
//      statistics go to a [3, BH, S] f32 buffer (on the TPU such a
//      1-wide residual padded 128x in VMEM; here it is 12 bytes a row).
//      Pass 3 recomputes P, forms dP and dS and accumulates dq.
//  (b) one block of 4 warps per (bh, 64-key tile), each warp owning 16
//      keys with K and V fragments in registers; it walks the query tiles,
//      recomputes S^T = K.Q^T and P^T from the stored statistics, forms
//      dP^T = V.dO^T and dS^T, and accumulates dK and dV in registers.
// No atomics; every output element is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // rows per block (4 warps x 16)
constexpr int kBK = 64;   // keys (kernel a) / queries (kernel b) per tile
constexpr int kPad = 8;   // bf16 padding per shared row

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one head, [row][d].
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*dst)[D + kPad],
                                           const __nv_bfloat16* src, int row0) {
  for (int i = threadIdx.x; i < kBK * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&dst[row][col]) =
        *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * D + col);
  }
}

// The same rows transposed, [d][row]: the B operand of a product that
// contracts over rows (two consecutive rows of one d are one word).
template <int D>
__device__ __forceinline__ void stage_rows_t(__nv_bfloat16 (*dst)[kBK + kPad],
                                             const __nv_bfloat16* src, int row0) {
  for (int i = threadIdx.x; i < kBK * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 raw =
        *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * D + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[col + j][row] = e[j];
  }
}

// A fragments of a warp's 16 rows (r0 and r0 + 8 for this lane), all of D.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const __nv_bfloat16* base, int r0, int t) {
  const __nv_bfloat16* ra = base + (size_t)r0 * D;
  const __nv_bfloat16* rb = ra + 8 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = ld32(ra + c);
    f[kk][1] = ld32(rb + c);
    f[kk][2] = ld32(ra + c + 8);
    f[kk][3] = ld32(rb + c + 8);
  }
}

// c[n] = A (16 x D, fragments) . B^T for the 64 staged rows of B [row][d]:
// C-fragment layout, c[n][0..1] row g, c[n][2..3] row g + 8, columns
// n * 8 + 2t and + 1.
template <int D>
__device__ __forceinline__ void product_nt(float (&c)[kBK / 8][4],
                                           const uint32_t (&af)[D / 16][4],
                                           const __nv_bfloat16 (*bs)[D + kPad],
                                           int g, int t) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const __nv_bfloat16* br = &bs[n * 8 + g][kk * 16 + 2 * t];
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_bf16_16816(c[n], af[kk], b);
    }
  }
}

// acc (16 x D) += bf16(x) (16 x 64, C-fragment layout) . B (64 x D), with B
// staged transposed [d][row].
template <int D>
__device__ __forceinline__ void accumulate_nn(float (&acc)[D / 8][4],
                                              const float (&x)[kBK / 8][4],
                                              const __nv_bfloat16 (*bt)[kBK + kPad],
                                              int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(x[2 * kk][0], x[2 * kk][1]),
        pack_bf16(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]),
    };
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* br = &bt[n * 8 + g][kk * 16 + 2 * t];
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_bf16_16816(acc[n], a, b);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int r0, int t,
                                           const float (&acc)[D / 8][4],
                                           float mul) {
  __nv_bfloat16* ra = base + (size_t)r0 * D;
  __nv_bfloat16* rb = ra + 8 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ra + c) = pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(rb + c) = pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (a) Row statistics and dq, one 64-row query tile per block.
template <int D>
__global__ void __launch_bounds__(128)
mha_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                  int BH, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 kt[D][kBK + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)blockIdx.y * S * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;  // rows r0 and r0 + 8

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, q + base, r0, t);
  load_a<D>(df, dout + base, r0, t);

  // D = rowsum(dO o O) in f32 from the bf16 values.
  float d0 = 0.f, d1 = 0.f;
  {
    const __nv_bfloat16* da = dout + base + (size_t)r0 * D;
    const __nv_bfloat16* oa = o + base + (size_t)r0 * D;
    for (int c = t; c < D; c += 4) {
      d0 += __bfloat162float(da[c]) * __bfloat162float(oa[c]);
      d1 += __bfloat162float(da[c + 8 * D]) * __bfloat162float(oa[c + 8 * D]);
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
  }

  float s[kBK / 8][4];

  // Pass 1: exact row max over all keys.
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int key0 = 0; key0 < S; key0 += kBK) {
    __syncthreads();
    stage_rows<D>(ks, kb, key0);
    __syncthreads();
    product_nt<D>(s, qf, ks, g, t);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      m0 = fmaxf(m0, fmaxf(s[n][0] * scale, s[n][1] * scale));
      m1 = fmaxf(m1, fmaxf(s[n][2] * scale, s[n][3] * scale));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // Pass 2: f32 row sum of exp(logit - max).
  float l0 = 0.f, l1 = 0.f;
  for (int key0 = 0; key0 < S; key0 += kBK) {
    __syncthreads();
    stage_rows<D>(ks, kb, key0);
    __syncthreads();
    product_nt<D>(s, qf, ks, g, t);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      l0 += expf(s[n][0] * scale - m0) + expf(s[n][1] * scale - m0);
      l1 += expf(s[n][2] * scale - m1) + expf(s[n][3] * scale - m1);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    const size_t row = (size_t)blockIdx.y * S + r0;
    const size_t plane = (size_t)BH * S;
    stats[row] = m0;
    stats[row + 8] = m1;
    stats[plane + row] = l0;
    stats[plane + row + 8] = l1;
    stats[2 * plane + row] = d0;
    stats[2 * plane + row + 8] = d1;
  }

  // Pass 3: P, dP = dO.V^T, dS = P o (dP - D), dq += bf16(dS).K.
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float dp[kBK / 8][4];
  for (int key0 = 0; key0 < S; key0 += kBK) {
    __syncthreads();
    stage_rows<D>(ks, kb, key0);
    stage_rows<D>(vs, vb, key0);
    stage_rows_t<D>(kt, kb, key0);
    __syncthreads();
    product_nt<D>(s, qf, ks, g, t);
    product_nt<D>(dp, df, vs, g, t);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = expf(s[n][0] * scale - m0) / l0 * (dp[n][0] - d0);
      s[n][1] = expf(s[n][1] * scale - m0) / l0 * (dp[n][1] - d0);
      s[n][2] = expf(s[n][2] * scale - m1) / l1 * (dp[n][2] - d1);
      s[n][3] = expf(s[n][3] * scale - m1) / l1 * (dp[n][3] - d1);
    }
    accumulate_nn<D>(acc, s, kt, g, t);
  }
  store_rows<D>(dq + base, r0, t, acc, scale);
}

// (b) dK and dV, one 64-key tile per block.
template <int D>
__global__ void __launch_bounds__(128)
mha_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ stats,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   int BH, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 ds_[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 qt[D][kBK + kPad];
  __shared__ __align__(16) __nv_bfloat16 dt[D][kBK + kPad];
  __shared__ float sm[kBK], sl[kBK], sd[kBK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)blockIdx.y * S * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* db = dout + base;
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;  // keys r0 and r0 + 8
  const size_t plane = (size_t)BH * S;
  const float* st = stats + (size_t)blockIdx.y * S;

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k + base, r0, t);
  load_a<D>(vf, v + base, r0, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  float p[kBK / 8][4], dp[kBK / 8][4];
  for (int q0 = 0; q0 < S; q0 += kBK) {
    __syncthreads();
    stage_rows<D>(qs, qb, q0);
    stage_rows<D>(ds_, db, q0);
    stage_rows_t<D>(qt, qb, q0);
    stage_rows_t<D>(dt, db, q0);
    for (int i = threadIdx.x; i < kBK; i += blockDim.x) {
      sm[i] = st[q0 + i];
      sl[i] = st[plane + q0 + i];
      sd[i] = st[2 * plane + q0 + i];
    }
    __syncthreads();
    product_nt<D>(p, kf, qs, g, t);   // S^T: rows = keys, columns = queries
    product_nt<D>(dp, vf, ds_, g, t); // dP^T
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        p[n][e] = expf(p[n][e] * scale - sm[j]) / sl[j];
        dp[n][e] = p[n][e] * (dp[n][e] - sd[j]);
      }
    }
    accumulate_nn<D>(dv_acc, p, dt, g, t);   // dV += bf16(P^T) . dO
    accumulate_nn<D>(dk_acc, dp, qt, g, t);  // dK += bf16(dS^T) . Q
  }
  store_rows<D>(dk + base, r0, t, dk_acc, scale);
  store_rows<D>(dv + base, r0, t, dv_acc, 1.f);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const __nv_bfloat16* o,
           const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, float* stats, int BH, int S, float scale,
           cudaStream_t st) {
  const dim3 grid(S / kBQ, BH);
  mha_bwd_dq_kernel<D><<<grid, 128, 0, st>>>(q, k, v, o, dout, dq, stats, BH,
                                             S, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_kernel<D><<<grid, 128, 0, st>>>(q, k, v, dout, stats, dk, dv,
                                              BH, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq, dk, dv: [BH, S, D] contiguous bf16; stats: [3, BH,
// S] f32 scratch; all on device ``device``. D in {32, 64}; S a multiple of
// 64. Launches both kernels on ``stream``; returns cudaGetLastError().
int mha_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv, void* stats,
                 int BH, int S, int D, float scale, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S % kBQ != 0 || (D != 32 && D != 64)) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* oo = static_cast<const __nv_bfloat16*>(o);
  const auto* gg = static_cast<const __nv_bfloat16*>(dout);
  auto* a = static_cast<__nv_bfloat16*>(dq);
  auto* b = static_cast<__nv_bfloat16*>(dk);
  auto* c = static_cast<__nv_bfloat16*>(dv);
  auto* s = static_cast<float*>(stats);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch<32>(qq, kk, vv, oo, gg, a, b, c, s, BH, S, scale, st);
  return launch<64>(qq, kk, vv, oo, gg, a, b, c, s, BH, S, scale, st);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
