// Kernel K1ᵇ on f32 inputs, Hopper's design, at head dim D = 32 or 64:
// gradients of full (unmasked) multi-head attention, f32 in and out.
//
// Replaces lgm_tpu/ops/mha.py::_bwd_kernel (via _mha_bwd) where lgm_tpu
// runs it on f32 inputs (``--mixed-precision fp32`` training). The
// function is the exact softmax-attention backward in f32, the port's plain
// version at f32 (ops/mha.py::mha_bwd_reference): P = 2^(s c - L2) from
// the forward's row statistic (c = scale log2e, L2 = L log2e), dP = dO.V^T,
// D = rowsum(dO o O), dS = P o (dP - D), and
//   dq = dS.K * scale,  dK = dS^T.Q * scale,  dV = P^T.dO,
// every product at f32 grade (3xTF32, mha_f32.cuh), nothing rounded below
// f32 (lgm_tpu's kernel body rounds dO, dS and P to bf16 at any input
// dtype; see README). A vp rank's dK and dV are its partial sums over its
// own queries, f32 as every output here.
//
// What bounds it on an H100 (SXM peaks at 700 W): the tensor cores, 10 BH
// Sq Sk D flops for the five products of the function, three TF32
// products each: 30 BH Sq Sk D against 495 TFLOP/s, 1.04 ms at LGM big's
// bs2 site (S 4096, BH 32, D 32). This design forms Q.K^T and dO.V^T in
// each of its two kernels, 42 BH Sq Sk D in all, for determinism. The BH
// Sq Sk exps, one a logit in each kernel, come next (0.13 ms each there).
//
// The design, the bf16 K1ᵇ's (mha_bwd_wgmma.cu) on TF32 operands: the
// wrapper first runs the split pass (mha_split_tf32.cu), which writes the
// hi and lo planes of Q, K, V and dO row-major and of Q, K and dO
// transposed. Then a deterministic split (no atomics; every output element
// written once) into two kernels, each a producer warpgroup feeding NC
// consumer warpgroups (1, or 2 at D = 32) of 64 rows through a ring of
// TMA-loaded, swizzled stages of 32 rows on full/empty mbarriers, the
// products on wgmma.mma_async m64nNk8 .tf32, each product's sum over a
// 32-row step taken from 0 on the tensor cores and added to its output row
// by rounded f32 adds:
//  (a) dq: a consumer owns 64 query rows, the halves of Q and dO in shared
//      memory (TMA, once), forms D = rowsum(dO o O) for its rows from
//      global memory and writes it for (b); 32-key tiles of K, V (row-major)
//      and K^T stream; per tile S = Q.K^T and dP = dO.V^T (m64n32k8, both
//      operands K-major from shared memory, three products each), P and dS
//      in registers, dq += dS.K with dS split into the register A operand
//      and K read from the transposed tile. The dq product of tile i runs
//      while the products of tile i + 1 are issued.
//  (b) dK/dV: a consumer owns 64 keys, the halves of K and V in shared
//      memory; 32-query tiles of Q, dO (row-major), dO^T and Q^T stream,
//      with the rows' L and D beside them (bulk copies); per tile S^T =
//      K.Q^T and dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q, P^T
//      and dS^T the register A operands, dO and Q read from the transposed
//      tiles.
// A dq row reads its own q, dO, o rows and every key in order, so a vp
// rank's rows (Sq = S / vp) are bit for bit the full call's.

#include "mha_f32.cuh"

namespace {

using namespace mha;
using tf32::kRows;

template <int D, int NC>
struct DqLayout {
  static constexpr int kHalf = 64 * D * 4;     // a consumer's Q hi (...)
  static constexpr int kRes = NC * 4 * kHalf;  // Q hi, Q lo, dO hi, dO lo
  static constexpr int kTile = kRows * D * 4;  // a 32-key plane tile
  // K hi, K lo, V hi, V lo (row-major), K^T hi, K^T lo.
  static constexpr int kStage = 6 * kTile;
  static constexpr int kFit =
      (tf32::kSmemMax - tf32::kSmemSlack - kRes) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBars = kRes + kStages * kStage;
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kStages >= 2, "at least two stages");
};

template <int D, int NC>
struct DkvLayout {
  static constexpr int kHalf = 64 * D * 4;     // a consumer's K hi (...)
  static constexpr int kRes = NC * 4 * kHalf;  // K hi, K lo, V hi, V lo
  static constexpr int kTile = kRows * D * 4;  // a 32-query plane tile
  // Q hi, Q lo, dO hi, dO lo (row-major), dO^T hi, dO^T lo, Q^T hi, Q^T
  // lo, then 32 L and 32 D values (1024 bytes kept for them).
  static constexpr int kStats = 8 * kTile;
  static constexpr int kStage = kStats + 1024;
  static constexpr int kFit =
      (tf32::kSmemMax - tf32::kSmemSlack - kRes) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBars = kRes + kStages * kStage;
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kStages >= 2, "at least two stages");
};

struct DqMaps {
  PlaneMaps q, dout, k, v, kt;
};

struct DkvMaps {
  PlaneMaps k, v, q, dout, dout_t, q_t;
};

__device__ __forceinline__ void init_ring(uint64_t* bars, int stages,
                                          int consumers) {
  wg::mbar_init(bars, 1);
  for (int s = 0; s < stages; ++s) {
    wg::mbar_init(bars + 1 + s, 1);
    wg::mbar_init(bars + 1 + stages + s, consumers * 4);  // a warp each
  }
  wg::fence_barrier_init();
}

// (a) D and dq, 64 NC query rows a block.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mha_bwd_dq_f32_kernel(const __grid_constant__ DqMaps m,
                      const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dq,
                      float* __restrict__ drow, int Sq, int Sk, float scale) {
  using L = DqLayout<D, NC>;
  constexpr int S = L::kStages, kTile = L::kTile, kHalf = L::kHalf;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = in_full + 1;
  uint64_t* empty = full + S;
  const int nT = Sk / kRows;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * 64 * NC;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) init_ring(in_full, S, NC);
  __syncthreads();

  if (group == 0) {
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(in_full, L::kRes);
      for (int c = 0; c < NC; ++c) {
        const int row = bh * Sq + row0 + 64 * c;
        unsigned char* r = smem + c * 4 * kHalf;
        tf32::load_rows<D>(r, &m.q.hi, in_full, row, 64);
        tf32::load_rows<D>(r + kHalf, &m.q.lo, in_full, row, 64);
        tf32::load_rows<D>(r + 2 * kHalf, &m.dout.hi, in_full, row, 64);
        tf32::load_rows<D>(r + 3 * kHalf, &m.dout.lo, in_full, row, 64);
      }
      for (int i = 0; i < nT; ++i) {
        const int s = i % S;
        if (i >= S) wg::mbar_wait(&empty[s], (i / S - 1) & 1);
        unsigned char* st = smem + L::kRes + s * L::kStage;
        const int key = i * kRows;
        wg::mbar_expect_tx(&full[s], L::kStage);
        tf32::load_rows<D>(st, &m.k.hi, &full[s], bh * Sk + key, kRows);
        tf32::load_rows<D>(st + kTile, &m.k.lo, &full[s], bh * Sk + key,
                           kRows);
        tf32::load_rows<D>(st + 2 * kTile, &m.v.hi, &full[s], bh * Sk + key,
                           kRows);
        tf32::load_rows<D>(st + 3 * kTile, &m.v.lo, &full[s], bh * Sk + key,
                           kRows);
        tf32::tma(st + 4 * kTile, &m.kt.hi, &full[s], key, bh * D);
        tf32::tma(st + 5 * kTile, &m.kt.lo, &full[s], key, bh * D);
      }
    }
  } else {
    const int c = group - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float cc = scale * kLog2e;
    const uint32_t q_hi = smem_u32(smem + c * 4 * kHalf);
    const uint32_t q_lo = q_hi + kHalf;
    const uint32_t do_hi = q_hi + 2 * kHalf;
    const uint32_t do_lo = q_hi + 3 * kHalf;
    const uint32_t ring = smem_u32(smem + L::kRes);
    const int r = row0 + 64 * c + 16 * warp + g;

    float nl2[2], dr[2];  // -L log2e and D of rows r, r + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * Sq + r + 8 * h;
      nl2[h] = -lse[row] * kLog2e;
      // D = rowsum(dO o O) in f32; lane t takes the columns t, t + 4, ...
      float d = 0.f;
#pragma unroll
      for (int col = t; col < D; col += 4)
        d = fmaf(dout[row * D + col], o[row * D + col], d);
      dr[h] = quad_sum(d);
      if (t == 0) drow[row] = dr[h];
    }

    float acc[D / 2], part[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = part[j] = 0.f;
    float s[16], dp[16];
    uint32_t ah[4][4], al[4][4];
    wg::mbar_wait(in_full, 0);
    for (int i = 0; i < nT; ++i) {
      const int st = i % S;
      const uint32_t kt = ring + st * L::kStage;
      wg::mbar_wait(&full[st], (i / S) & 1);
      wg::own(s);
      wg::own(dp);
      wg::fence();
      tf32::product_nt<D, true>(s, q_hi, q_lo, 64 * 128, kt, kt + kTile);
      tf32::product_nt<D, true>(dp, do_hi, do_lo, 64 * 128, kt + 2 * kTile,
                                kt + 3 * kTile);
      wg::commit();
      wg::wait<0>();  // and the previous tile's dq product
      wg::own(s);
      wg::own(dp);
      wg::own(part);
      wg::own(ah);
      wg::own(al);
      if (i > 0) {
        tf32::add_rn(acc, part);
        if (lane == 0) wg::mbar_arrive(&empty[(i - 1) % S]);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int hr = (e >> 1) & 1;
        const float p = ex2(fmaf(s[e], cc, nl2[hr]));
        s[e] = p * (dp[e] - dr[hr]);
      }
      tf32::to_a(ah, al, s);
      wg::fence();
      tf32::product_nn<D>(part, ah, al, kt + 4 * kTile, kt + 5 * kTile);
      wg::commit();
    }
    wg::wait<0>();
    wg::own(part);
    wg::own(ah);
    wg::own(al);
    tf32::add_rn(acc, part);
    wg::store_rows<D>(dq + (size_t)bh * Sq * D, r, t, acc, scale, scale);
  }
}

// (b) dK and dV, 64 NC keys a block, 32 queries a streamed tile.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mha_bwd_dkv_f32_kernel(const __grid_constant__ DkvMaps m,
                       const float* __restrict__ lse,
                       const float* __restrict__ drow, float* __restrict__ dk,
                       float* __restrict__ dv, int Sq, int Sk, float scale) {
  using L = DkvLayout<D, NC>;
  constexpr int S = L::kStages, kTile = L::kTile, kHalf = L::kHalf;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = in_full + 1;
  uint64_t* empty = full + S;
  const int nT = Sq / kRows;
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * 64 * NC;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) init_ring(in_full, S, NC);
  __syncthreads();

  if (group == 0) {
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(in_full, L::kRes);
      for (int c = 0; c < NC; ++c) {
        const int key = bh * Sk + key0 + 64 * c;
        unsigned char* r = smem + c * 4 * kHalf;
        tf32::load_rows<D>(r, &m.k.hi, in_full, key, 64);
        tf32::load_rows<D>(r + kHalf, &m.k.lo, in_full, key, 64);
        tf32::load_rows<D>(r + 2 * kHalf, &m.v.hi, in_full, key, 64);
        tf32::load_rows<D>(r + 3 * kHalf, &m.v.lo, in_full, key, 64);
      }
      for (int i = 0; i < nT; ++i) {
        const int s = i % S;
        if (i >= S) wg::mbar_wait(&empty[s], (i / S - 1) & 1);
        unsigned char* st = smem + L::kRes + s * L::kStage;
        const int q0 = i * kRows;
        const int row = bh * Sq + q0;
        wg::mbar_expect_tx(&full[s], L::kStats + 2 * kRows * 4);
        tf32::load_rows<D>(st, &m.q.hi, &full[s], row, kRows);
        tf32::load_rows<D>(st + kTile, &m.q.lo, &full[s], row, kRows);
        tf32::load_rows<D>(st + 2 * kTile, &m.dout.hi, &full[s], row, kRows);
        tf32::load_rows<D>(st + 3 * kTile, &m.dout.lo, &full[s], row, kRows);
        tf32::tma(st + 4 * kTile, &m.dout_t.hi, &full[s], q0, bh * D);
        tf32::tma(st + 5 * kTile, &m.dout_t.lo, &full[s], q0, bh * D);
        tf32::tma(st + 6 * kTile, &m.q_t.hi, &full[s], q0, bh * D);
        tf32::tma(st + 7 * kTile, &m.q_t.lo, &full[s], q0, bh * D);
        wg::bulk_copy(st + L::kStats, lse + row, kRows * 4, &full[s]);
        wg::bulk_copy(st + L::kStats + kRows * 4, drow + row, kRows * 4,
                      &full[s]);
      }
    }
  } else {
    const int c = group - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int t = (lane & 3), g = lane >> 2;
    const float cc = scale * kLog2e;
    const uint32_t k_hi = smem_u32(smem + c * 4 * kHalf);
    const uint32_t k_lo = k_hi + kHalf;
    const uint32_t v_hi = k_hi + 2 * kHalf;
    const uint32_t v_lo = k_hi + 3 * kHalf;

    float dk_acc[D / 2], dv_acc[D / 2], pk[D / 2], pv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    float s[16], dp[16];
    uint32_t aph[4][4], apl[4][4], adh[4][4], adl[4][4];
    wg::mbar_wait(in_full, 0);
    for (int i = 0; i < nT; ++i) {
      const int st = i % S;
      unsigned char* stage = smem + L::kRes + st * L::kStage;
      const uint32_t qt = smem_u32(stage);
      const float* lt = reinterpret_cast<const float*>(stage + L::kStats);
      const float* drt = lt + kRows;
      wg::mbar_wait(&full[st], (i / S) & 1);
      wg::own(s);
      wg::own(dp);
      wg::fence();
      tf32::product_nt<D, true>(s, k_hi, k_lo, 64 * 128, qt, qt + kTile);
      tf32::product_nt<D, true>(dp, v_hi, v_lo, 64 * 128, qt + 2 * kTile,
                                qt + 3 * kTile);
      wg::commit();
      wg::wait<0>();
      wg::own(s);
      wg::own(dp);
      // P^T and dS^T; this thread's columns are queries 8 j + 2 t, + 1.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * t;
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
      tf32::to_a(aph, apl, s);
      tf32::to_a(adh, adl, dp);
      wg::own(pv);
      wg::own(pk);
      wg::fence();
      tf32::product_nn<D>(pv, aph, apl, qt + 4 * kTile, qt + 5 * kTile);
      tf32::product_nn<D>(pk, adh, adl, qt + 6 * kTile, qt + 7 * kTile);
      wg::commit();
      wg::wait<0>();
      wg::own(pv);
      wg::own(pk);
      wg::own(aph);
      wg::own(apl);
      wg::own(adh);
      wg::own(adl);
      if (lane == 0) wg::mbar_arrive(&empty[st]);
      tf32::add_rn(dv_acc, pv);
      tf32::add_rn(dk_acc, pk);
    }

    const int r = key0 + 64 * c + 16 * warp + g;
    const size_t base = (size_t)bh * Sk * D;
    wg::store_rows<D>(dk + base, r, t, dk_acc, scale, scale);
    wg::store_rows<D>(dv + base, r, t, dv_acc, 1.f, 1.f);
  }
}

struct Args {
  const float *o, *dout, *lse;
  float *dq, *dk, *dv, *drow;
  int BH, Sq, Sk;
  float scale;
  cudaStream_t st;
  int device;
};

template <int D, int NC>
int launch_dq(const Args& a, const DqMaps& m) {
  using L = DqLayout<D, NC>;
  if (a.Sq % (64 * NC) != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err =
      allow_smem((const void*)mha_bwd_dq_f32_kernel<D, NC>, L::kSmem,
                 a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dq_f32_kernel<D, NC>
      <<<dim3(a.Sq / (64 * NC), a.BH), 128 * (NC + 1), L::kSmem, a.st>>>(
          m, a.o, a.dout, a.lse, a.dq, a.drow, a.Sq, a.Sk, a.scale);
  return (int)cudaGetLastError();
}

template <int D, int NC>
int launch_dkv(const Args& a, const DkvMaps& m) {
  using L = DkvLayout<D, NC>;
  if (a.Sk % (64 * NC) != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err =
      allow_smem((const void*)mha_bwd_dkv_f32_kernel<D, NC>, L::kSmem,
                 a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_f32_kernel<D, NC>
      <<<dim3(a.Sk / (64 * NC), a.BH), 128 * (NC + 1), L::kSmem, a.st>>>(
          m, a.lse, a.drow, a.dk, a.dv, a.Sq, a.Sk, a.scale);
  return (int)cudaGetLastError();
}

// Two consumer warpgroups a block at D = 32 where the wrapper asks; one
// at D = 64, where the dK/dV kernel's four accumulators and two products'
// A operands take one warpgroup's share of a 256-thread block, and the
// dq kernel's two would spill (and ran no faster at S 1024).
template <int D>
int launch(const Args& a, const DqMaps& mq, const DkvMaps& mkv, int nc_q,
           int nc_kv) {
  int e = (int)cudaErrorInvalidValue;
  if constexpr (D == 32)
    if (nc_q == 2) e = launch_dq<D, 2>(a, mq);
  if (nc_q == 1) e = launch_dq<D, 1>(a, mq);
  if (e != 0) return e;
  if constexpr (D == 32)
    if (nc_kv == 2) return launch_dkv<D, 2>(a, mkv);
  return launch_dkv<D, 1>(a, mkv);
}

}  // namespace

extern "C" {

// planes: the split pass's fourteen planes (mha_split_tf32.cu), hi then lo
// of each: Q, dO ([BH, Sq, D]), K, V ([BH, Sk, D]) row-major, then Q^T, dO^T
// ([BH, D, Sq]) and K^T ([BH, D, Sk]), rows permuted; o, dout, dq: [BH,
// Sq, D]; dk, dv: [BH, Sk, D]; lse (K1's statistic) and drow (f32
// scratch): [BH, Sq]; all contiguous f32, 16-byte aligned, on device
// ``device``. D must be 32 or 64; Sk a multiple of 128 and of 64 nc_kv; Sq
// a multiple of 64 and of 64 nc_q; scale > 0; nc_q and nc_kv 1, or 2 at
// D = 32. Launches both kernels on ``stream``; returns cudaGetLastError()
// (or the error that refused them).
int mha_bwd_f32(void* const* planes, const void* o, const void* dout,
                const void* lse, void* dq, void* dk, void* dv, void* drow,
                int BH, int Sq, int Sk, int D, float scale, int nc_q,
                int nc_kv, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 32 && D != 64) || Sk % 128 != 0 || Sq <= 0 || Sq % 64 != 0 ||
      !(scale > 0.f) || !(nc_q == 1 || (nc_q == 2 && D == 32)) ||
      !(nc_kv == 1 || (nc_kv == 2 && D == 32)) ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(drow) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  DqMaps mq;
  DkvMaps mkv;
  err = rows_maps(&mq.q, planes[0], planes[1], BH, Sq, D);
  if (err == cudaSuccess)
    err = rows_maps(&mq.dout, planes[2], planes[3], BH, Sq, D);
  if (err == cudaSuccess)
    err = rows_maps(&mq.k, planes[4], planes[5], BH, Sk, D);
  if (err == cudaSuccess)
    err = rows_maps(&mq.v, planes[6], planes[7], BH, Sk, D);
  if (err == cudaSuccess)
    err = cols_maps(&mkv.q_t, planes[8], planes[9], BH, Sq, D);
  if (err == cudaSuccess)
    err = cols_maps(&mkv.dout_t, planes[10], planes[11], BH, Sq, D);
  if (err == cudaSuccess)
    err = cols_maps(&mq.kt, planes[12], planes[13], BH, Sk, D);
  if (err != cudaSuccess) return (int)err;
  mkv.k = mq.k;
  mkv.v = mq.v;
  mkv.q = mq.q;
  mkv.dout = mq.dout;
  const Args a{static_cast<const float*>(o), static_cast<const float*>(dout),
               static_cast<const float*>(lse), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(drow), BH, Sq, Sk, scale,
               static_cast<cudaStream_t>(stream), device};
  return D == 32 ? launch<32>(a, mq, mkv, nc_q, nc_kv)
                 : launch<64>(a, mq, mkv, nc_q, nc_kv);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
