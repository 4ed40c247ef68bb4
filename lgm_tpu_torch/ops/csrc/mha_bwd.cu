// Kernel K1 backward (K1ᵇ): gradients of full (unmasked) multi-head
// attention for the U-Net's cross-view MVAttention, bf16 in and out.
//
// Replaces lgm_tpu/ops/mha.py::_bwd_kernel (via _mha_bwd, the VJP of
// mha_kresident), the TPU's fused one-pass backward. The function is the
// same: per (batch*head) the normalized f32 P of the exact softmax of the
// scaled logits, dP = dO.V^T, D = rowsum(dO o O) in f32 and
// dS = P o (dP - D); dS and P are rounded to bf16 before their products,
// every product accumulates in f32, and
//   dq = dS.K * scale,  dK = dS^T.Q * scale,  dV = P^T.dO
// are rounded to bf16. The one difference is where P's statistics come
// from: the TPU kernel recomputed the row max and sum (it stored none), this
// one reads L = m + log(l) per row, which K1 wrote in the forward, and
// takes P = exp(s - L) directly: equal to exp(s - m) / l up to f32
// rounding.
//
// What bounds it on an H100: 2 BH S^2 exps on the SFUs (one per logit in
// each kernel below) and 14 BH S^2 D tensor-core flops (seven products:
// Q.K^T and dO.V^T in each kernel, dS.K, dS^T.Q, P^T.dO), ~0.26 ms and
// ~0.24 ms at S = 4096/D = 32, BH = 32 (from an H100 SXM's published
// peaks at 700 W); the two overlap. Behind them come the shared-memory
// reads of the B operands and the f32 arithmetic of dS.
//
// The design: two kernels, deterministic (no atomics; every output element
// is written once), because dK and dV sum over every query tile and dq over
// every key tile (the TPU carried dK, dV in VMEM scratch across its
// sequential grid; blocks here run in parallel and in no order).
//  (a) dq: a block of NW warps owns 16 * MT * NW query rows; each warp
//      keeps the Q and dO fragments of its MT m-tiles in registers, and
//      forms D = rowsum(dO o O) for its rows, which it also writes for (b).
//      128-key K and V tiles stream through a 2-stage cp.async ring (the
//      next tile's copy in flight while this one computes); per 16-key
//      chunk: S = Q.K^T, dP = dO.V^T (K, V by ldmatrix), P = 2^(s c - L2)
//      (one FMA and one ex2 per logit; c = scale log2e, L2 = L log2e), dS,
//      and dq += bf16(dS).K with K by ldmatrix.trans from the same tile.
//  (b) dK/dV: a block owns 16 * MT * NW keys, K and V fragments in
//      registers; Q, dO and the rows' L and D tiles stream through the
//      ring; per 16-query chunk: S^T = K.Q^T, dP^T = V.dO^T, P^T and dS^T
//      with the column statistics in registers, dV += bf16(P^T).dO and
//      dK += bf16(dS^T).Q, dO and Q by ldmatrix.trans.
// Two exps per logit and seven products in all; nothing is transposed in
// shared memory. (MT, NW) of each kernel is chosen by the caller so that
// the grid fills the card at small S.
//
// Queries and keys may differ in number (Sq against Sk), as under the
// view-sharded U-Net, where each vp rank holds the queries of its own
// views and the keys and values of all of them. (a) runs over Sq rows and
// streams Sk keys; (b) runs over Sk keys and streams Sq queries, 128 a
// tile, or 64 where Sq is not a multiple of 128 (Sq 64 or 192, which the
// wrapper takes): a template parameter, so the 128-query
// kernel is the one built before. The tile size changes no sum: (b)
// accumulates over 16-query chunks in the same order either way. A rank's
// dK and dV are partial sums over its own queries, which the vp ranks then
// sum; rounding each partial to bf16 would round vp times where one
// process rounds once, so (b) writes them in f32 when the caller asks
// (dk32, dv32) and the caller rounds the sum.

#include "mha_common.cuh"

namespace {

using namespace mha;

constexpr int kBK = 128;  // keys (a) / queries (b, or 64: BQ) per tile
constexpr int kStages = 2;

template <int D, int MT, int NW, int BQ = kBK>
struct BwdConfig {
  static constexpr int kThreads = NW * 32;
  static constexpr int kRows = 16 * MT * NW;  // rows (a) / keys (b) a block
  static constexpr int kTile = kBK * Tile<D>::kStride;  // bf16 elements
  static constexpr int kQTile = BQ * Tile<D>::kStride;  // (b)'s Q, dO tiles
  // (a): K and V rings; (b): Q and dO rings, then L and D rings (f32).
  static constexpr int kSmemDq = 2 * kStages * kTile * 2;
  static constexpr int kSmemDkv =
      2 * kStages * kQTile * 2 + 2 * kStages * BQ * 4;
};

// (a) D and dq, 16 * MT * NW query rows a block.
template <int D, int MT, int NW>
__global__ void __launch_bounds__(NW * 32)
mha_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  bf16* __restrict__ dq, float* __restrict__ drow, int Sq,
                  int Sk, float scale) {
  using C = BwdConfig<D, MT, NW>;
  constexpr int RS = Tile<D>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kStages * C::kTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)blockIdx.y * Sq * D;  // q, o, dO, dq
  const bf16* kb = k + (size_t)blockIdx.y * Sk * D;
  const bf16* vb = v + (size_t)blockIdx.y * Sk * D;
  const int r0 = blockIdx.x * C::kRows + warp * 16 * MT;
  const int off_nt = ldsm_row(lane) * RS + ldsm_col(lane);
  const int off_t = ldsm_t_row(lane) * RS + ldsm_t_col(lane);
  const float c = scale * kLog2e;

  const int nT = Sk / kBK;
  auto issue = [&](int i) {
    if (i < nT) {
      const int st = i % kStages;
      load_tile<D, kBK, C::kThreads>(ks + st * C::kTile, kb, i * kBK);
      load_tile<D, kBK, C::kThreads>(vs + st * C::kTile, vb, i * kBK);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  uint32_t qf[MT][D / 16][4], df[MT][D / 16][4];
  float nl2[MT][2], dr[MT][2];  // -L log2e and D of rows g, g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = r0 + 16 * mt + g;
    load_a<D>(qf[mt], q + base, r, t);
    load_a<D>(df[mt], dout + base, r, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)blockIdx.y * Sq + r + 8 * h;
      nl2[mt][h] = -lse[row] * kLog2e;
      // D = rowsum(dO o O) in f32 from the bf16 values; lane t takes the
      // columns 8t.. (and 32 + 8t.. at D = 64).
      float d = 0.f;
#pragma unroll
      for (int c0 = 8 * t; c0 < D; c0 += 32) {
        const uint4 a = *reinterpret_cast<const uint4*>(dout + row * D + c0);
        const uint4 b = *reinterpret_cast<const uint4*>(o + row * D + c0);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(pa[e]);
          const float2 fb = __bfloat1622float2(pb[e]);
          d = fmaf(fa.x, fb.x, d);
          d = fmaf(fa.y, fb.y, d);
        }
      }
      dr[mt][h] = quad_sum(d);
      if (t == 0) drow[row] = dr[mt][h];
    }
  }

  float acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  float s[MT][2][4], dp[MT][2][4];
  for (int i = 0; i < nT; ++i) {
    const int st = ring_advance<kStages>(i, issue);
    const bf16* kt = ks + st * C::kTile;
    const bf16* vt = vs + st * C::kTile;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      product_nt<D, MT>(s, qf, kt + 16 * j * RS, off_nt);
      product_nt<D, MT>(dp, df, vt + 16 * j * RS, off_nt);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float p = ex2(fmaf(s[mt][n][e], c, nl2[mt][h]));
            s[mt][n][e] = p * (dp[mt][n][e] - dr[mt][h]);
          }
        to_a(a[mt], s[mt]);
      }
      accumulate_nn<D, MT>(acc, a, kt + 16 * j * RS, off_t);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<D>(dq + base, r0 + 16 * mt + g, t, acc[mt], scale, scale);
}

// (b) dK and dV, 16 * MT * NW keys a block, BQ queries a staged tile;
// into bf16 dk, dv, or f32 dk32, dv32 where those are not null.
template <int D, int MT, int NW, int BQ>
__global__ void __launch_bounds__(NW * 32)
mha_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ drow, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, float* __restrict__ dk32,
                   float* __restrict__ dv32, int Sq, int Sk, float scale) {
  using C = BwdConfig<D, MT, NW, BQ>;
  constexpr int RS = Tile<D>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kStages * C::kQTile;
  float* ls = reinterpret_cast<float*>(dos + kStages * C::kQTile);
  float* drs = ls + kStages * BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)blockIdx.y * Sk * D;  // k, v, dk, dv
  const bf16* qb = q + (size_t)blockIdx.y * Sq * D;
  const bf16* db = dout + (size_t)blockIdx.y * Sq * D;
  const float* lb = lse + (size_t)blockIdx.y * Sq;
  const float* drb = drow + (size_t)blockIdx.y * Sq;
  const int r0 = blockIdx.x * C::kRows + warp * 16 * MT;  // keys
  const int off_nt = ldsm_row(lane) * RS + ldsm_col(lane);
  const int off_t = ldsm_t_row(lane) * RS + ldsm_t_col(lane);
  const float c = scale * kLog2e;

  const int nT = Sq / BQ;
  auto issue = [&](int i) {
    if (i < nT) {
      const int st = i % kStages;
      load_tile<D, BQ, C::kThreads>(qs + st * C::kQTile, qb, i * BQ);
      load_tile<D, BQ, C::kThreads>(dos + st * C::kQTile, db, i * BQ);
      load_row_stat<BQ, C::kThreads>(ls + st * BQ, lb, i * BQ);
      load_row_stat<BQ, C::kThreads>(drs + st * BQ, drb, i * BQ);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  uint32_t kf[MT][D / 16][4], vf[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a<D>(kf[mt], k + base, r0 + 16 * mt + g, t);
    load_a<D>(vf[mt], v + base, r0 + 16 * mt + g, t);
  }

  float dk_acc[MT][D / 8][4], dv_acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mt][n][e] = dv_acc[mt][n][e] = 0.f;

  float s[MT][2][4], dp[MT][2][4];
  for (int i = 0; i < nT; ++i) {
    const int st = ring_advance<kStages>(i, issue);
    const bf16* qt = qs + st * C::kQTile;
    const bf16* dt = dos + st * C::kQTile;
    const float* lt = ls + st * BQ;
    const float* drt = drs + st * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      product_nt<D, MT>(s, kf, qt + 16 * j * RS, off_nt);   // S^T
      product_nt<D, MT>(dp, vf, dt + 16 * j * RS, off_nt);  // dP^T
      // Statistics of this thread's query columns 16 j + 8 n + 2 t, + 1.
      float2 nl2[2], dr[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * j + 8 * n + 2 * t;
        const float2 L = *reinterpret_cast<const float2*>(lt + col);
        nl2[n] = make_float2(-L.x * kLog2e, -L.y * kLog2e);
        dr[n] = *reinterpret_cast<const float2*>(drt + col);
      }
      uint32_t ap[MT][4], ads[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][n][e], c,
                                     (e & 1) ? nl2[n].y : nl2[n].x));
            s[mt][n][e] = p;
            dp[mt][n][e] = p * (dp[mt][n][e] - ((e & 1) ? dr[n].y : dr[n].x));
          }
        to_a(ap[mt], s[mt]);
        to_a(ads[mt], dp[mt]);
      }
      accumulate_nn<D, MT>(dv_acc, ap, dt + 16 * j * RS, off_t);
      accumulate_nn<D, MT>(dk_acc, ads, qt + 16 * j * RS, off_t);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = r0 + 16 * mt + g;
    if (dk32 != nullptr) {
      store_rows_f32<D>(dk32 + base, r, t, dk_acc[mt], scale, scale);
      store_rows_f32<D>(dv32 + base, r, t, dv_acc[mt], 1.f, 1.f);
    } else {
      store_rows<D>(dk + base, r, t, dk_acc[mt], scale, scale);
      store_rows<D>(dv + base, r, t, dv_acc[mt], 1.f, 1.f);
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  bf16 *dq, *dk, *dv;
  float *dk32, *dv32;
  float* drow;
  int BH, Sq, Sk;
  float scale;
  cudaStream_t st;
  int device;
};

template <int D, int MT, int NW>
int launch_dq(const Args& a) {
  using C = BwdConfig<D, MT, NW>;
  if (a.Sq % C::kRows != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err =
      allow_smem((const void*)mha_bwd_dq_kernel<D, MT, NW>, C::kSmemDq,
                 a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dq_kernel<D, MT, NW>
      <<<dim3(a.Sq / C::kRows, a.BH), C::kThreads, C::kSmemDq, a.st>>>(
          a.q, a.k, a.v, a.o, a.dout, a.lse, a.dq, a.drow, a.Sq, a.Sk,
          a.scale);
  return (int)cudaGetLastError();
}

template <int D, int MT, int NW, int BQ>
int launch_dkv_bq(const Args& a) {
  using C = BwdConfig<D, MT, NW, BQ>;
  if (a.Sk % C::kRows != 0 || a.Sq % BQ != 0)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err =
      allow_smem((const void*)mha_bwd_dkv_kernel<D, MT, NW, BQ>, C::kSmemDkv,
                 a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_kernel<D, MT, NW, BQ>
      <<<dim3(a.Sk / C::kRows, a.BH), C::kThreads, C::kSmemDkv, a.st>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.drow, a.dk, a.dv, a.dk32, a.dv32,
          a.Sq, a.Sk, a.scale);
  return (int)cudaGetLastError();
}

// 128 queries a tile where Sq allows, else 64.
template <int D, int MT, int NW>
int launch_dkv(const Args& a) {
  return a.Sq % kBK == 0 ? launch_dkv_bq<D, MT, NW, kBK>(a)
                         : launch_dkv_bq<D, MT, NW, kBK / 2>(a);
}

template <int D>
int launch_d(const Args& a, int mt_q, int nw_q, int mt_kv, int nw_kv) {
#define K1B_CASE(launch, MT, NW) \
  case MT * 10 + NW:             \
    err = launch<D, MT, NW>(a);  \
    break;
  int err = (int)cudaErrorInvalidValue;
  switch (mt_q * 10 + nw_q) {
    K1B_CASE(launch_dq, 2, 8) K1B_CASE(launch_dq, 2, 4)
    K1B_CASE(launch_dq, 1, 8) K1B_CASE(launch_dq, 1, 4)
    K1B_CASE(launch_dq, 1, 2) K1B_CASE(launch_dq, 1, 1)
  }
  if (err != 0) return err;
  err = (int)cudaErrorInvalidValue;
  switch (mt_kv * 10 + nw_kv) {
    K1B_CASE(launch_dkv, 2, 8) K1B_CASE(launch_dkv, 2, 4)
    K1B_CASE(launch_dkv, 1, 8) K1B_CASE(launch_dkv, 1, 4)
    K1B_CASE(launch_dkv, 1, 2) K1B_CASE(launch_dkv, 1, 1)
  }
#undef K1B_CASE
  return err;
}

}  // namespace

extern "C" {

// q, o, dout, dq: [BH, Sq, D] and k, v: [BH, Sk, D] contiguous bf16,
// 16-byte aligned; dk, dv: [BH, Sk, D], bf16, or f32 where dkv_f32 is not
// 0; lse (K1's statistic): [BH, Sq] f32; drow: [BH, Sq] f32 scratch; all
// on device ``device``. D = 32 (ops/mha.py routes D = 64 to
// mha_bwd_wgmma.cu); Sk a multiple of 128 and of the
// dK/dV kernel's block rows 16 * mt_kv * nw_kv; Sq a multiple of 64 and of
// the dq kernel's block rows 16 * mt_q * nw_q; scale > 0; (mt_q, nw_q) and
// (mt_kv, nw_kv) each in {(2, 8), (2, 4), (1, 8), (1, 4), (1, 2), (1, 1)}.
// Launches both kernels on ``stream``; returns cudaGetLastError().
int mha_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* dq, void* dk,
                 void* dv, void* drow, int BH, int Sq, int Sk, int D,
                 float scale, int mt_q, int nw_q, int mt_kv, int nw_kv,
                 int dkv_f32, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Sk % kBK != 0 || Sq <= 0 || Sq % (kBK / 2) != 0 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q),
               static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),
               static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout),
               static_cast<const float*>(lse),
               static_cast<bf16*>(dq),
               dkv_f32 ? nullptr : static_cast<bf16*>(dk),
               dkv_f32 ? nullptr : static_cast<bf16*>(dv),
               dkv_f32 ? static_cast<float*>(dk) : nullptr,
               dkv_f32 ? static_cast<float*>(dv) : nullptr,
               static_cast<float*>(drow),
               BH, Sq, Sk, scale, static_cast<cudaStream_t>(stream), device};
  if (D != 32) return (int)cudaErrorInvalidValue;
  return launch_d<32>(a, mt_q, nw_q, mt_kv, nw_kv);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
