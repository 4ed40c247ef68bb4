// Kernel K1ᵇ on f32 inputs, at head dim D = 32 or 64: gradients of full
// (unmasked) multi-head attention, f32 in and out.
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
// The design is a deterministic split (no atomics; every output element
// written once) into two kernels on the stream, each a block of NW warps
// (NW 8 where the rows fill the card in 128-row blocks, else 4) with 16
// rows a warp held in registers as A fragments, the streamed operand in a
// 2-stage cp.async ring of 64-row tiles, 16 rows a step (two n-tiles):
//  (a) dq: a warp owns 16 query rows, Q and dO in registers, forms D =
//      rowsum(dO o O) for its rows and writes it for (b); per step of 16
//      keys S = Q.K^T and dP = dO.V^T, P and dS in registers, then dq +=
//      dS.K with dS the A operand and K read from the same tile.
//  (b) dK/dV: a warp owns 16 keys, K and V in registers; 64-query tiles of
//      Q and dO stream, with the rows' L and D beside them; per step of 16
//      queries S^T = K.Q^T and dP^T = V.dO^T, then dV += P^T.dO and dK +=
//      dS^T.Q, dO and Q read from the same tiles.
// A dq row reads its own q, dO, o rows and every key in order, so a vp
// rank's rows (Sq = S / vp) are bit for bit the full call's.

#include "mha_f32.cuh"

namespace {

using namespace mha;
using namespace mha::f32;

constexpr int kStep = 16;  // keys (a) / queries (b) a step: two n-tiles

template <int D>
struct DqLayout {
  static constexpr int kSmem = 2 * kStages * Tile<D>::kFloats * 4;  // K, V
};

template <int D>
struct DkvLayout {
  // Q and dO tiles, then kTile L and kTile D values, a stage.
  static constexpr int kStage = 2 * Tile<D>::kFloats + 2 * kTile;
  static constexpr int kSmem = kStages * kStage * 4;
};

// (a) D and dq, 16 NW query rows a block.
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
mha_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dq,
                      float* __restrict__ drow, int Sq, int Sk, float scale) {
  constexpr int RS = Tile<D>::kStride, TF = Tile<D>::kFloats;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kStages * TF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  const int r = blockIdx.x * 16 * NW + 16 * warp + g;  // rows r, r + 8
  const size_t row = (size_t)bh * Sq + r;
  const float cc = scale * kLog2e;

  const int nT = Sk / kTile;
  auto fetch = [&](int i) {
    if (i < nT) {
      const int st = i % kStages;
      load_tile<D, NW * 32>(ks + st * TF, kb, i * kTile);
      load_tile<D, NW * 32>(vs + st * TF, vb, i * kTile);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);

  float qa[D / 8][4], da[D / 8][4];
  load_a<D>(qa, q + row * D, t);
  load_a<D>(da, dout + row * D, t);
  float nl2[2], dr[2];  // -L log2e and D of rows r, r + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t rh = row + 8 * h;
    nl2[h] = -lse[rh] * kLog2e;
    // D = rowsum(dO o O) in f32; lane t takes the columns t, t + 4, ...
    float d = 0.f;
#pragma unroll
    for (int c = t; c < D; c += 4) d = fmaf(dout[rh * D + c], o[rh * D + c], d);
    dr[h] = quad_sum(d);
    if (t == 0) drow[rh] = dr[h];
  }

  float acc[D / 8][4];
  zero<D>(acc);
  float s[kStep / 8][4], dp[kStep / 8][4];
  for (int i = 0; i < nT; ++i) {
    const int st = ring_advance<kStages>(i, fetch);
    const float* kt = ks + st * TF;
    const float* vt = vs + st * TF;
#pragma unroll
    for (int j = 0; j < kTile / kStep; ++j) {
      product_nt<D, kStep / 8, true, true>(s, qa, kt + j * kStep * RS, g,
                                           t);
      product_nt<D, kStep / 8, true, true>(dp, da, vt + j * kStep * RS, g,
                                           t);
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = ex2(fmaf(s[n][e], cc, nl2[h]));
          s[n][e] = p * (dp[n][e] - dr[h]);
        }
      accumulate_nn<D, kStep / 8>(acc, s, kt + j * kStep * RS, g, t);
    }
  }
  store_rows<D>(dq + row * D, t, acc, scale, scale);
}

// (b) dK and dV, 16 NW keys a block.
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
mha_bwd_dkv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ drow, float* __restrict__ dk,
                       float* __restrict__ dv, int Sq, int Sk, float scale) {
  using L = DkvLayout<D>;
  constexpr int RS = Tile<D>::kStride, TF = Tile<D>::kFloats;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* db = dout + (size_t)bh * Sq * D;
  const int r = blockIdx.x * 16 * NW + 16 * warp + g;  // keys r, r + 8
  const size_t key = (size_t)bh * Sk + r;
  const float cc = scale * kLog2e;

  // Stage st: the Q tile, the dO tile, then L and D of its queries.
  const int nT = Sq / kTile;
  auto fetch = [&](int i) {
    if (i < nT) {
      float* stage = smem + (i % kStages) * L::kStage;
      load_tile<D, NW * 32>(stage, qb, i * kTile);
      load_tile<D, NW * 32>(stage + TF, db, i * kTile);
      load_stat<NW * 32>(stage + 2 * TF, lse + (size_t)bh * Sq, i * kTile);
      load_stat<NW * 32>(stage + 2 * TF + kTile, drow + (size_t)bh * Sq,
                         i * kTile);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);

  float ka[D / 8][4], va[D / 8][4];
  load_a<D>(ka, k + key * D, t);
  load_a<D>(va, v + key * D, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  float s[kStep / 8][4], dp[kStep / 8][4];
  for (int i = 0; i < nT; ++i) {
    const float* qt = smem + ring_advance<kStages>(i, fetch) * L::kStage;
    const float* dt = qt + TF;
    const float* lt = qt + 2 * TF;
    const float* drt = lt + kTile;
#pragma unroll
    for (int j = 0; j < kTile / kStep; ++j) {
      product_nt<D, kStep / 8, true, true>(s, ka, qt + j * kStep * RS, g,
                                           t);
      product_nt<D, kStep / 8, true, true>(dp, va, dt + j * kStep * RS, g,
                                           t);
      // The columns are queries j kStep + 8 n + 2 t (+ 1).
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * kStep + 8 * n + 2 * t + (e & 1);
          const float p = ex2(fmaf(s[n][e], cc, -lt[col] * kLog2e));
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - drt[col]);
        }
      accumulate_nn<D, kStep / 8>(dv_acc, s, dt + j * kStep * RS, g, t);
      accumulate_nn<D, kStep / 8>(dk_acc, dp, qt + j * kStep * RS, g, t);
    }
  }
  store_rows<D>(dk + key * D, t, dk_acc, scale, scale);
  store_rows<D>(dv + key * D, t, dv_acc, 1.f, 1.f);
}

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *drow;
  int BH, Sq, Sk;
  float scale;
  cudaStream_t st;
  int device;
};

template <int D, int NW>
int launch_dq(const Args& a) {
  constexpr int kSmem = DqLayout<D>::kSmem;
  if (a.Sq % (16 * NW) != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err = allow_smem(
      (const void*)mha_bwd_dq_f32_kernel<D, NW>, kSmem, a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dq_f32_kernel<D, NW>
      <<<dim3(a.Sq / (16 * NW), a.BH), NW * 32, kSmem, a.st>>>(
          a.q, a.k, a.v, a.o, a.dout, a.lse, a.dq, a.drow, a.Sq, a.Sk,
          a.scale);
  return (int)cudaGetLastError();
}

template <int D, int NW>
int launch_dkv(const Args& a) {
  constexpr int kSmem = DkvLayout<D>::kSmem;
  if (a.Sk % (16 * NW) != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err = allow_smem(
      (const void*)mha_bwd_dkv_f32_kernel<D, NW>, kSmem, a.device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_f32_kernel<D, NW>
      <<<dim3(a.Sk / (16 * NW), a.BH), NW * 32, kSmem, a.st>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.drow, a.dk, a.dv, a.Sq, a.Sk,
          a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int nw_q, int nw_kv) {
  const int e = nw_q == 8 ? launch_dq<D, 8>(a) : launch_dq<D, 4>(a);
  if (e != 0) return e;
  return nw_kv == 8 ? launch_dkv<D, 8>(a) : launch_dkv<D, 4>(a);
}

}  // namespace

extern "C" {

// q, o, dout, dq: [BH, Sq, D] and k, v, dk, dv: [BH, Sk, D], contiguous
// f32, 16-byte aligned; lse (K1's statistic) and drow (f32 scratch): [BH,
// Sq], 16-byte aligned; all on device ``device``. D must be 32 or 64; Sk a
// multiple of 128 and of 16 * nw_kv; Sq a multiple of 64 and of 16 * nw_q;
// scale > 0; nw_q, nw_kv (warps a block of each kernel) 4 or 8. Launches
// both kernels on ``stream``; returns cudaGetLastError() (or the error
// that refused them).
int mha_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dq, void* dk,
                void* dv, void* drow, int BH, int Sq, int Sk, int D,
                float scale, int nw_q, int nw_kv, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 32 && D != 64) || Sk % 128 != 0 || Sq <= 0 || Sq % kTile != 0 ||
      !(scale > 0.f) || (nw_q != 4 && nw_q != 8) ||
      (nw_kv != 4 && nw_kv != 8) ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(drow) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(o),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(dq),         static_cast<float*>(dk),
               static_cast<float*>(dv),         static_cast<float*>(drow),
               BH, Sq, Sk, scale, static_cast<cudaStream_t>(stream), device};
  return D == 32 ? launch<32>(a, nw_q, nw_kv) : launch<64>(a, nw_q, nw_kv);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
