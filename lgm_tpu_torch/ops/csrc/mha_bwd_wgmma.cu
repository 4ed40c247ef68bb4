// Kernel K1ᵇ, Hopper's design, at head dim D = 32 or 64: gradients of
// full (unmasked) multi-head attention, bf16 in and out (dK, dV in f32 for
// a vp rank's partial sums).
//
// Replaces lgm_tpu/ops/mha.py::_bwd_kernel (via _mha_bwd), with the same
// function and roundings: P = 2^(s c - L2) from K1's row statistic (c =
// scale log2e, L2 = L log2e), dP = dO.V^T, D = rowsum(dO o O) in f32, dS =
// P o (dP - D); dS and P rounded to bf16 before their products, every
// product accumulated in f32, and
//   dq = dS.K * scale,  dK = dS^T.Q * scale,  dV = P^T.dO.
// ops/mha.py routes every call here, as it does K1.
//
// What bounds it on an H100 (SXM peaks at 700 W): the tensor cores, 10 BH
// S^2 D flops for the five products of the function (0.27 ms at the
// ImageDream finetune's S 5120, BH 20, D 64; 0.174 ms at LGM big's bs2
// site, S 4096, BH 32, D 32); this design forms Q.K^T and dO.V^T in each
// of its two kernels, 14 BH S^2 D in all, for determinism. The BH S^2
// exps, one a logit in each kernel, come next (0.13 ms each at S 5120).
//
// The design is a deterministic split (no atomics; every output element
// written once), each kernel a producer warpgroup feeding NC consumer
// warpgroups (1, 2, or at D = 32 4) of 64 rows through a ring of
// TMA-loaded, swizzled stages on mbarriers (see mha_fwd_wgmma.cu), the
// products on wgmma.mma_async, a tile taken in steps of KS rows (64, or 32
// at NC = 4, whose four consumers share the 102 registers a thread gets at
// 640 threads and keep 16 warps of exps in flight on an SM):
//  (a) dq: a consumer owns 64 query rows, Q and dO in shared memory (TMA,
//      once), forms D = rowsum(dO o O) for its rows from global memory and
//      writes it for (b); 128-key K and V tiles stream; per step of KS keys
//      S = Q.K^T and dP = dO.V^T (m64nKSk16, both operands K-major from
//      shared memory), P and dS in registers, dq += bf16(dS).K with dS the
//      register A operand and K read MN-major from the same tile.
//  (b) dK/dV: a consumer owns 64 keys, K and V in shared memory; BQ-query
//      tiles of Q and dO stream (BQ 128, or 64 where Sq is not a multiple
//      of 128), with the rows' L and D beside them (bulk copies); per KS
//      queries S^T = K.Q^T and dP^T = V.dO^T, then dV += bf16(P^T).dO and
//      dK += bf16(dS^T).Q, dO and Q read MN-major. The sums run over the
//      same 16-query steps in the same order whatever BQ and KS are.
// A dq row reads its own q, dO, o rows and every key in order, so a vp
// rank's rows (Sq = S / vp) are bit for bit the full call's.

#include "mha_wgmma.cuh"

namespace {

using namespace mha;

constexpr int kTile = 128;                 // keys (a) / queries (b) a tile

// ptxas gives every thread the launch bound's share of the registers
// (65,536 / (128 (NC + 1)): 168 at NC = 2, 102 at NC = 4), so the
// consumers fit in it.
constexpr int kStages = 4;

// Keys (dq) or queries (dK/dV) a step of the consumers' products: 64, or
// 32 where four consumer warpgroups share the registers.
template <int NC>
constexpr int kStep = NC == 4 ? 32 : 64;

template <int D, int NC>
struct DqLayout {
  static constexpr int kBoxBytes = wg::Rows<D>::kBoxBytes;
  static constexpr int kTileBytes = kTile * wg::Rows<D>::kBytes;
  static constexpr int kDo = NC * kBoxBytes;          // after the Q boxes
  static constexpr int kRing = 2 * NC * kBoxBytes;
  static constexpr int kStage = 2 * kTileBytes;       // K, then V
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

template <int D, int NC, int BQ>
struct DkvLayout {
  static constexpr int kBoxBytes = wg::Rows<D>::kBoxBytes;
  static constexpr int kV = NC * kBoxBytes;           // after the K boxes
  static constexpr int kRing = 2 * NC * kBoxBytes;
  // Q tile, dO tile, then BQ L and BQ D values, rounded up to 1024 bytes.
  static constexpr int kQBytes = BQ * wg::Rows<D>::kBytes;
  static constexpr int kStatBytes = 2 * BQ * 4;
  static constexpr int kStage = 2 * kQBytes + 1024;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ void init_ring(uint64_t* bars, int consumers) {
  wg::mbar_init(bars, 1);
  for (int s = 0; s < kStages; ++s) {
    wg::mbar_init(bars + 1 + s, 1);
    wg::mbar_init(bars + 1 + kStages + s, consumers * 128);
  }
  wg::fence_barrier_init();
}

// (a) D and dq, 64 NC query rows a block.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mha_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ drow, int Sq, int Sk,
                        float scale) {
  using L = DqLayout<D, NC>;
  constexpr int kBoxBytes = L::kBoxBytes, kTileBytes = L::kTileBytes;
  constexpr int KS = kStep<NC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = in_full + 1;
  uint64_t* empty = full + kStages;
  const int nT = Sk / kTile;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * 64 * NC;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) init_ring(in_full, NC);
  __syncthreads();

  if (group == 0) {
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(in_full, 2 * NC * kBoxBytes);
      for (int c = 0; c < NC; ++c) {
        const int row = bh * Sq + row0 + 64 * c;
        wg::tma_box(smem + c * kBoxBytes, &tq, in_full, row);
        wg::tma_box(smem + L::kDo + c * kBoxBytes, &tdo, in_full, row);
      }
      for (int i = 0; i < nT; ++i) {
        const int s = i % kStages;
        if (i >= kStages) wg::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        unsigned char* kt = smem + L::kRing + s * L::kStage;
        const int key = bh * Sk + i * kTile;
        wg::mbar_expect_tx(&full[s], 2 * kTileBytes);
        wg::tma_box(kt, &tk, &full[s], key);
        wg::tma_box(kt + kBoxBytes, &tk, &full[s], key + 64);
        wg::tma_box(kt + kTileBytes, &tv, &full[s], key);
        wg::tma_box(kt + kTileBytes + kBoxBytes, &tv, &full[s], key + 64);
      }
    }
  } else {
    const int c = group - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float cc = scale * kLog2e;
    const uint32_t q_tile = smem_u32(smem + c * kBoxBytes);
    const uint32_t do_tile = smem_u32(smem + L::kDo + c * kBoxBytes);
    const uint32_t ring = smem_u32(smem + L::kRing);
    const int r = row0 + 64 * c + 16 * warp + g;

    float nl2[2], dr[2];  // -L log2e and D of rows r, r + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * Sq + r + 8 * h;
      nl2[h] = -lse[row] * kLog2e;
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
      dr[h] = quad_sum(d);
      if (t == 0) drow[row] = dr[h];
    }

    // Each 128-key tile in steps of KS keys (the registers of one step's
    // S and dP fit beside dq's); dq sums its 16-key steps in key order
    // whatever KS is.
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float s[KS / 2], dp[KS / 2];
    uint32_t a[KS / 16][4];
    wg::mbar_wait(in_full, 0);
    for (int i = 0; i < nT; ++i) {
      const int st = i % kStages;
      const uint32_t kt = ring + st * L::kStage;
      wg::mbar_wait(&full[st], (i / kStages) & 1);
#pragma unroll
      for (int h = 0; h < kTile / KS; ++h) {
        const uint32_t kh = kt + h * KS * wg::Rows<D>::kBytes;
        wg::own(s);
        wg::own(dp);
        wg::fence();
        wg::product_nt<KS, D>(s, q_tile, kh);
        wg::product_nt<KS, D>(dp, do_tile, kh + kTileBytes);
        wg::commit();
        wg::wait<0>();  // and the previous dq product
        wg::own(s);
        wg::own(dp);
        wg::own(acc);
        wg::own(a);
        if (h == 0 && i > 0) wg::mbar_arrive(&empty[(i - 1) % kStages]);
#pragma unroll
        for (int e = 0; e < KS / 2; ++e) {
          const int hr = (e >> 1) & 1;
          const float p = ex2(fmaf(s[e], cc, nl2[hr]));
          s[e] = p * (dp[e] - dr[hr]);
        }
        wg::to_a<KS / 16>(a, s);
        wg::fence();
        wg::accumulate_nn<KS / 16, D>(acc, a, kh);
        wg::commit();
      }
    }
    wg::wait<0>();
    wg::own(acc);
    wg::own(a);
    wg::store_rows<D>(dq + (size_t)bh * Sq * D, r, t, acc, scale, scale);
  }
}

// (b) dK and dV, 64 NC keys a block, BQ queries a streamed tile; into bf16
// dk, dv, or f32 dk32, dv32 where those are not null.
template <int D, int NC, int BQ>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mha_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ drow,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ dk32, float* __restrict__ dv32,
                         int Sq, int Sk, float scale) {
  using L = DkvLayout<D, NC, BQ>;
  constexpr int kBoxBytes = L::kBoxBytes;
  constexpr int KS = kStep<NC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = in_full + 1;
  uint64_t* empty = full + kStages;
  const int nT = Sq / BQ;
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * 64 * NC;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) init_ring(in_full, NC);
  __syncthreads();

  if (group == 0) {
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(in_full, 2 * NC * kBoxBytes);
      for (int c = 0; c < NC; ++c) {
        const int key = bh * Sk + key0 + 64 * c;
        wg::tma_box(smem + c * kBoxBytes, &tk, in_full, key);
        wg::tma_box(smem + L::kV + c * kBoxBytes, &tv, in_full, key);
      }
      for (int i = 0; i < nT; ++i) {
        const int s = i % kStages;
        if (i >= kStages) wg::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        unsigned char* qt = smem + L::kRing + s * L::kStage;
        const int row = bh * Sq + i * BQ;
        wg::mbar_expect_tx(&full[s], 2 * L::kQBytes + L::kStatBytes);
#pragma unroll
        for (int b = 0; b < BQ / 64; ++b) {
          wg::tma_box(qt + b * kBoxBytes, &tq, &full[s], row + 64 * b);
          wg::tma_box(qt + L::kQBytes + b * kBoxBytes, &tdo, &full[s],
                      row + 64 * b);
        }
        wg::bulk_copy(qt + 2 * L::kQBytes, lse + row, BQ * 4, &full[s]);
        wg::bulk_copy(qt + 2 * L::kQBytes + BQ * 4, drow + row, BQ * 4,
                      &full[s]);
      }
    }
  } else {
    const int c = group - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float cc = scale * kLog2e;
    const uint32_t k_tile = smem_u32(smem + c * kBoxBytes);
    const uint32_t v_tile = smem_u32(smem + L::kV + c * kBoxBytes);

    // Each BQ-query tile in steps of KS queries: the same 16-query steps in
    // the same order whatever BQ and KS are.
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    float s[KS / 2], dp[KS / 2];
    uint32_t ap[KS / 16][4], ads[KS / 16][4];
    wg::mbar_wait(in_full, 0);
    for (int i = 0; i < nT; ++i) {
      const int st = i % kStages;
      unsigned char* stage = smem + L::kRing + st * L::kStage;
      const float* lt =
          reinterpret_cast<const float*>(stage + 2 * L::kQBytes);
      const float* drt = lt + BQ;
      wg::mbar_wait(&full[st], (i / kStages) & 1);
#pragma unroll
      for (int h = 0; h < BQ / KS; ++h) {
        const uint32_t qt = smem_u32(stage) + h * KS * wg::Rows<D>::kBytes;
        const uint32_t dt = qt + L::kQBytes;
        wg::own(s);
        wg::own(dp);
        wg::fence();
        wg::product_nt<KS, D>(s, k_tile, qt);   // S^T
        wg::product_nt<KS, D>(dp, v_tile, dt);  // dP^T
        wg::commit();
        wg::wait<0>();  // and the previous dK, dV products
        wg::own(s);
        wg::own(dp);
        wg::own(dk_acc);
        wg::own(dv_acc);
        wg::own(ap);
        wg::own(ads);
        if (h == 0 && i > 0) wg::mbar_arrive(&empty[(i - 1) % kStages]);
        // Column statistics of this thread's queries KS h + 8 j + 2 t, + 1.
#pragma unroll
        for (int j = 0; j < KS / 8; ++j) {
          const int col = KS * h + 8 * j + 2 * t;
          const float2 Lq = *reinterpret_cast<const float2*>(lt + col);
          const float2 Dq = *reinterpret_cast<const float2*>(drt + col);
          const float n0 = -Lq.x * kLog2e, n1 = -Lq.y * kLog2e;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * j + e;
            const float p = ex2(fmaf(s[k], cc, (e & 1) ? n1 : n0));
            s[k] = p;
            dp[k] = p * (dp[k] - ((e & 1) ? Dq.y : Dq.x));
          }
        }
        wg::to_a<KS / 16>(ap, s);
        wg::to_a<KS / 16>(ads, dp);
        wg::fence();
        wg::accumulate_nn<KS / 16, D>(dv_acc, ap, dt);
        wg::accumulate_nn<KS / 16, D>(dk_acc, ads, qt);
        wg::commit();
      }
    }
    wg::wait<0>();
    wg::own(dk_acc);
    wg::own(dv_acc);
    wg::own(ap);
    wg::own(ads);

    const int r = key0 + 64 * c + 16 * warp + g;
    const size_t base = (size_t)bh * Sk * D;
    if (dk32 != nullptr) {
      wg::store_rows<D>(dk32 + base, r, t, dk_acc, scale, scale);
      wg::store_rows<D>(dv32 + base, r, t, dv_acc, 1.f, 1.f);
    } else {
      wg::store_rows<D>(dk + base, r, t, dk_acc, scale, scale);
      wg::store_rows<D>(dv + base, r, t, dv_acc, 1.f, 1.f);
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

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D, int NC>
int launch_dq(const Args& a, const Maps& m) {
  using L = DqLayout<D, NC>;
  if (a.Sq % (64 * NC) != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err =
      allow_smem((const void*)mha_bwd_dq_wgmma_kernel<D, NC>, L::kSmem,
                 a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dq_wgmma_kernel<D, NC>
      <<<dim3(a.Sq / (64 * NC), a.BH), 128 * (NC + 1), L::kSmem, a.st>>>(
          m.q, m.k, m.v, m.dout, a.o, a.dout, a.lse, a.dq, a.drow, a.Sq,
          a.Sk, a.scale);
  return (int)cudaGetLastError();
}

template <int D, int NC, int BQ>
int launch_dkv_bq(const Args& a, const Maps& m) {
  using L = DkvLayout<D, NC, BQ>;
  if (a.Sk % (64 * NC) != 0 || a.Sq % BQ != 0)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err =
      allow_smem((const void*)mha_bwd_dkv_wgmma_kernel<D, NC, BQ>, L::kSmem,
                 a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_wgmma_kernel<D, NC, BQ>
      <<<dim3(a.Sk / (64 * NC), a.BH), 128 * (NC + 1), L::kSmem, a.st>>>(
          m.q, m.k, m.v, m.dout, a.lse, a.drow, a.dk, a.dv, a.dk32, a.dv32,
          a.Sq, a.Sk, a.scale);
  return (int)cudaGetLastError();
}

// 128 queries a tile where Sq allows, else 64.
template <int D, int NC>
int launch_dkv(const Args& a, const Maps& m) {
  return a.Sq % kTile == 0 ? launch_dkv_bq<D, NC, kTile>(a, m)
                           : launch_dkv_bq<D, NC, kTile / 2>(a, m);
}

template <int D>
int launch(const Args& a, const void* q, const void* k, const void* v,
           const void* dout, int nc_q, int nc_kv) {
  Maps m;
  cudaError_t err = rows_map<D>(&m.q, q, (long)a.BH * a.Sq);
  if (err == cudaSuccess) err = rows_map<D>(&m.k, k, (long)a.BH * a.Sk);
  if (err == cudaSuccess) err = rows_map<D>(&m.v, v, (long)a.BH * a.Sk);
  if (err == cudaSuccess)
    err = rows_map<D>(&m.dout, dout, (long)a.BH * a.Sq);
  if (err != cudaSuccess) return (int)err;
  // Four consumer warpgroups a block at D = 32 only (at D = 64 their
  // registers would not fit).
  int e = (int)cudaErrorInvalidValue;
  if constexpr (D == 32)
    if (nc_q == 4) e = launch_dq<D, 4>(a, m);
  if (nc_q == 2) e = launch_dq<D, 2>(a, m);
  if (nc_q == 1) e = launch_dq<D, 1>(a, m);
  if (e != 0) return e;
  e = (int)cudaErrorInvalidValue;
  if constexpr (D == 32)
    if (nc_kv == 4) e = launch_dkv<D, 4>(a, m);
  if (nc_kv == 2) e = launch_dkv<D, 2>(a, m);
  if (nc_kv == 1) e = launch_dkv<D, 1>(a, m);
  return e;
}

}  // namespace

extern "C" {

// q, o, dout, dq: [BH, Sq, D] and k, v: [BH, Sk, D] contiguous bf16,
// 16-byte aligned; dk, dv: [BH, Sk, D], bf16, or f32 where dkv_f32 is not
// 0; lse (K1's statistic) and drow (f32 scratch): [BH, Sq], 16-byte
// aligned; all on device ``device``. D must be 32 or 64; Sk a multiple of 128
// and of 64 * nc_kv; Sq a multiple of 64 and of 64 * nc_q; scale > 0;
// nc_q, nc_kv (consumer warpgroups a block of each kernel) 1 or 2.
// Launches both kernels on ``stream``; returns cudaGetLastError() (or the
// error that refused them).
int mha_bwd_wgmma_bf16(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dq, void* dk, void* dv, void* drow, int BH,
                       int Sq, int Sk, int D, float scale, int nc_q,
                       int nc_kv, int dkv_f32, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 32 && D != 64) || Sk % kTile != 0 || Sq <= 0 || Sq % 64 != 0 ||
      !(scale > 0.f) || reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(drow) % 16 != 0)
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
  return D == 32 ? launch<32>(a, q, k, v, dout, nc_q, nc_kv)
                 : launch<64>(a, q, k, v, dout, nc_q, nc_kv);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
