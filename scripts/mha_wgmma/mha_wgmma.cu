// Probe: K1 and K1ᵇ with their products on wgmma instead of mma.sync, to
// time the two tensor-core routes against each other on the card
// (scripts/mha_wgmma/run.py). Not part of the package: the package keeps
// the route that measured faster (lgm_tpu_torch/ops/csrc/mha_*.cu).
//
// The function is the package kernels' (the same statistics, roundings and
// outputs). What differs: a warpgroup (4 warps) owns 64 rows and issues
// each product as wgmma.mma_async m64nNk16 with A (Q, dO, K, V, P, dS)
// from registers in the m16n8k16 fragment layout and B read by the tensor
// cores from shared memory through a descriptor; tiles are 64 rows staged
// by cp.async in the no-swizzle core-matrix layout (8 rows x 16 bytes
// contiguous; 16-byte chunk i of a tile at byte 16 i), which serves as the
// K-major B of S = Q.K^T and dP = dO.V^T (LBO 128, SBO 16 D bytes) and as
// the MN-major B of P.V, dS.K, P^T.dO and dS^T.Q (LBO 16 D, SBO 128). Each
// product is waited for before its result is used (no overlap inside a
// warpgroup; other warpgroups of the SM fill in).

#include "mha_common.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace mha;

constexpr int kBK = 64;
constexpr int kStages = 3;

__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Rows [row0, row0 + R) of a [*, D] bf16 matrix into the core-matrix layout.
template <int D, int R, int T>
__device__ __forceinline__ void load_tile_cm(bf16* tile, const bf16* src,
                                             int row0) {
  constexpr int C = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * C; i += T) {
    const int row = (i / (8 * C)) * 8 + (i & 7), c = (i >> 3) % C;
    cp_async16(smem_u32(tile) + 16 * i, src + (size_t)(row0 + row) * D + c * 8);
  }
}

// Wait for item i of the ring, make the copies visible to the tensor cores'
// (async-proxy) reads, and refill the stage freed by item i - 1.
template <class Issue>
__device__ __forceinline__ int advance(int i, Issue&& issue) {
  cp_async_wait<kStages - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  issue(i + kStages - 1);
  return i % kStages;
}

// s (64 rows x 64 columns) = A (64 x D, fragments) . B^T, B a [64][D] tile.
template <int D>
__device__ __forceinline__ void wg_nt(float (&s)[32],
                                      const uint32_t (&a)[D / 16][4],
                                      const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_t0_m64n64k16(s, a[kk], desc(tile + kk * 128, 128, 16 * D), kk);
}

// acc (64 x D) += A (64 x 64, four k-step fragments) . B, B a [64][D] tile.
template <int D>
__device__ __forceinline__ void wg_nn(float (&acc)[D / 2],
                                      const uint32_t (&a)[4][4],
                                      const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = desc(tile + kk * 16 * D, 16 * D, 128);
    if constexpr (D == 32) wgmma_t1_m64n32k16(acc, a[kk], b, 1);
    else wgmma_t1_m64n64k16(acc, a[kk], b, 1);
  }
}

__device__ __forceinline__ void to_a4(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void store_acc(bf16* base, int r, int t,
                                          const float (&acc)[D / 2],
                                          float mul0, float mul1) {
  bf16* ra = base + (size_t)r * D;
  bf16* rb = ra + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(ra + col) =
        pack_bf16(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    *reinterpret_cast<uint32_t*>(rb + col) =
        pack_bf16(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int S, float scale) {
  constexpr int T = NWG * 128, kTile = kBK * D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kStages * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.y * S * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int r = blockIdx.x * 64 * NWG + warp * 16 + g;
  const float c = scale * kLog2e;
  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + base, r, t);
  const int nT = S / kBK;
  auto issue = [&](int i) {
    if (i < 2 * nT) {
      const int st = i % kStages, key0 = (i % nT) * kBK;
      load_tile_cm<D, kBK, T>(ks + st * kTile, kb, key0);
      if (i >= nT) load_tile_cm<D, kBK, T>(vs + st * kTile, vb, key0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int i = 0; i < nT; ++i) {
    const bf16* kt = ks + advance(i, issue) * kTile;
    wg_fence();
    wg_nt<D>(s, qf, kt);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  const float m0 = quad_max(mx0) * c, m1 = quad_max(mx1) * c;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int i = nT; i < 2 * nT; ++i) {
    const int st = advance(i, issue);
    wg_fence();
    wg_nt<D>(s, qf, ks + st * kTile);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = ex2(fmaf(s[j], c, (j & 2) ? -m1 : -m0));
      if (j & 2) l1 += s[j]; else l0 += s[j];
    }
    uint32_t a[4][4];
    to_a4(a, s);
    wg_fence();
    wg_nn<D>(acc, a, vs + st * kTile);
    wg_commit();
    wg_wait_all();
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_acc<D>(o + base, r, t, acc, 1.f / l0, 1.f / l1);
  if (lse != nullptr && t == 0) {
    float* lr = lse + (size_t)blockIdx.y * S + r;
    lr[0] = (m0 + log2f(l0)) * kLn2;
    lr[8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          bf16* __restrict__ dq, float* __restrict__ drow, int S,
          float scale) {
  constexpr int T = NWG * 128, kTile = kBK * D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kStages * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.y * S * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int r = blockIdx.x * 64 * NWG + warp * 16 + g;
  const float c = scale * kLog2e;
  const int nT = S / kBK;
  auto issue = [&](int i) {
    if (i < nT) {
      const int st = i % kStages;
      load_tile_cm<D, kBK, T>(ks + st * kTile, kb, i * kBK);
      load_tile_cm<D, kBK, T>(vs + st * kTile, vb, i * kBK);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, q + base, r, t);
  load_a<D>(df, dout + base, r, t);
  float nl2[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)blockIdx.y * S + r + 8 * h;
    nl2[h] = -lse[row] * kLog2e;
    float d = 0.f;
    for (int c0 = 8 * t; c0 < D; c0 += 32)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d = fmaf(__bfloat162float(dout[row * D + c0 + e]),
                 __bfloat162float(o[row * D + c0 + e]), d);
    dr[h] = quad_sum(d);
    if (t == 0) drow[row] = dr[h];
  }
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
  for (int i = 0; i < nT; ++i) {
    const int st = advance(i, issue);
    const bf16* kt = ks + st * kTile;
    wg_fence();
    wg_nt<D>(s, qf, kt);
    wg_nt<D>(dp, df, vs + st * kTile);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      s[j] = ex2(fmaf(s[j], c, nl2[h])) * (dp[j] - dr[h]);
    }
    uint32_t a[4][4];
    to_a4(a, s);
    wg_fence();
    wg_nn<D>(acc, a, kt);
    wg_commit();
    wg_wait_all();
  }
  store_acc<D>(dq + base, r, t, acc, scale, scale);
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ drow,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale) {
  constexpr int T = NWG * 128, kTile = kBK * D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kStages * kTile;
  float* ls = reinterpret_cast<float*>(dos + kStages * kTile);
  float* drs = ls + kStages * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* lb = lse + (size_t)blockIdx.y * S;
  const float* drb = drow + (size_t)blockIdx.y * S;
  const int r = blockIdx.x * 64 * NWG + warp * 16 + g;
  const float c = scale * kLog2e;
  const int nT = S / kBK;
  auto issue = [&](int i) {
    if (i < nT) {
      const int st = i % kStages;
      load_tile_cm<D, kBK, T>(qs + st * kTile, q + base, i * kBK);
      load_tile_cm<D, kBK, T>(dos + st * kTile, dout + base, i * kBK);
      load_row_stat<kBK, T>(ls + st * kBK, lb, i * kBK);
      load_row_stat<kBK, T>(drs + st * kBK, drb, i * kBK);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k + base, r, t);
  load_a<D>(vf, v + base, r, t);
  float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
  for (int i = 0; i < nT; ++i) {
    const int st = advance(i, issue);
    const bf16* qt = qs + st * kTile;
    const bf16* dt = dos + st * kTile;
    const float* lt = ls + st * kBK;
    const float* drt = drs + st * kBK;
    wg_fence();
    wg_nt<D>(s, kf, qt);
    wg_nt<D>(dp, vf, dt);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 L = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
      const float2 Dd = *reinterpret_cast<const float2*>(drt + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], c, -((e & 1) ? L.y : L.x) * kLog2e));
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? Dd.y : Dd.x));
      }
    }
    uint32_t ap[4][4], ads[4][4];
    to_a4(ap, s);
    to_a4(ads, dp);
    wg_fence();
    wg_nn<D>(dv_acc, ap, dt);
    wg_nn<D>(dk_acc, ads, qt);
    wg_commit();
    wg_wait_all();
  }
  store_acc<D>(dk + base, r, t, dk_acc, scale, scale);
  store_acc<D>(dv + base, r, t, dv_acc, 1.f, 1.f);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, int NWG>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int S, float scale, cudaStream_t st) {
  constexpr int smem = 2 * kStages * kBK * D * 2;
  cudaError_t err = allow_smem(fwd_kernel<D, NWG>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<D, NWG><<<dim3(S / (64 * NWG), BH), NWG * 128, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      S, scale);
  return (int)cudaGetLastError();
}

template <int D, int NWG>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dq, void* dk, void* dv,
        void* drow, int BH, int S, float scale, cudaStream_t st) {
  constexpr int smem_q = 2 * kStages * kBK * D * 2;
  constexpr int smem_kv = smem_q + 2 * kStages * kBK * 4;
  cudaError_t err = allow_smem(dq_kernel<D, NWG>, smem_q);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel<D, NWG>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / (64 * NWG), BH);
  dq_kernel<D, NWG><<<grid, NWG * 128, smem_q, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, (const float*)lse, (bf16*)dq, (float*)drow, S,
      scale);
  dkv_kernel<D, NWG><<<grid, NWG * 128, smem_kv, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)drow, (bf16*)dk, (bf16*)dv, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// As mha_fwd_bf16 / mha_bwd_bf16 of the package, with nwg warpgroups (1,
// 2 or 4) of 64 rows a block; S a multiple of 64 * nwg.
int wg_mha_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int BH, int S, int D, float scale, int nwg,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % (64 * nwg) != 0) return (int)cudaErrorInvalidValue;
#define FWD(d, n) \
  if (D == d && nwg == n) return fwd<d, n>(q, k, v, o, lse, BH, S, scale, st);
  FWD(32, 1) FWD(32, 2) FWD(32, 4) FWD(64, 1) FWD(64, 2) FWD(64, 4)
#undef FWD
  return (int)cudaErrorInvalidValue;
}

int wg_mha_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dq, void* dk,
               void* dv, void* drow, int BH, int S, int D, float scale,
               int nwg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % (64 * nwg) != 0) return (int)cudaErrorInvalidValue;
#define BWD(d, n)                                                          \
  if (D == d && nwg == n)                                                  \
    return bwd<d, n>(q, k, v, o, dout, lse, dq, dk, dv, drow, BH, S, scale, \
                     st);
  BWD(32, 1) BWD(32, 2) BWD(32, 4) BWD(64, 1) BWD(64, 2) BWD(64, 4)
#undef BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
