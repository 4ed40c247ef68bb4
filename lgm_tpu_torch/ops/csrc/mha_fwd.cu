// Kernel K1: full (unmasked) multi-head attention forward for the U-Net's
// cross-view MVAttention, bf16 in and out, and the f32 logsumexp of each
// row for the backward.
//
// Replaces lgm_tpu/ops/mha.py::_fwd_kernel (via _mha_fwd / mha_kresident),
// the TPU's K-resident Pallas kernel. The function is the same: per
// (batch*head, query row) the exact softmax of the scaled logits — the row
// max taken over ALL keys before any exponential, no online rescaling —
// with P rounded to bf16 before the P.V product, f32 accumulation, the f32
// row sum of the unrounded P as divisor, and the output rounded to bf16.
// Where the caller passes a buffer it also writes L = m + log(l) per row
// (m the row max, l that sum), which K1ᵇ reads instead of recomputing the
// softmax statistics; the TPU kernel stored none (see ops/mha.py).
//
// Queries and keys may differ in number: Sq query rows attend to Sk keys.
// Under the view-sharded U-Net each vp rank holds the queries of its own
// views (Sq = S / vp) and the keys and values of all of them (Sk = S);
// every row's arithmetic reads only its own q row and all Sk keys in tile
// order, so a rank's rows are bit for bit the rows of the Sq = Sk call.
//
// The TPU called its kernel only where S >= 2048 (lgm_tpu/models/unet.py:
// 61-62): that gate is a VMEM/HBM decision of that chip. The port calls
// K1 at every MVAttention site; ops/mha.py routes D = 32 (S = 4096 at the
// big preset) here and D = 64 (LGM's S 1024 and 256 sites, the diffusion
// U-Net's level 0) to mha_fwd_wgmma.cu, so this design is built at D = 32
// only.
//
// What bounds it on an H100: BH * S^2 exps on the SFUs (16 per clock per
// SM), about 65 us at S = 4096, BH = 16, against ~35 us of tensor-core
// work for the three products (Q.K^T twice, P.V) (both from an H100 SXM's
// published peaks at 700 W). Behind those come the copies of K (twice)
// and V from L2 into every block, the shared-memory reads of the B
// operands (each warp reads the whole key tile once per product) and the
// per-logit f32 arithmetic.
//
// The design: a block of NW warps owns 16 * MT * NW query rows; each warp
// owns MT m-tiles of 16 rows with their Q fragments in registers, so one
// ldmatrix of K or V feeds MT products. K and V stream through shared
// memory 128 keys a tile in a 2-stage cp.async ring (the copy of tile
// i + 1 is in flight while tile i computes). Two passes over the keys:
// pass 1 forms Q.K^T (mma.sync m16n8k16, K by ldmatrix) and keeps the raw
// row max; pass 2 forms it again, takes P = 2^(s * scale * log2e - m2)
// (one FMA and one ex2 per logit), sums the f32 P, and feeds bf16(P) from
// the accumulator registers straight into the P.V product, whose V operand
// ldmatrix.trans reads from the [key][d] tile as it was copied. The output
// is multiplied by 1/l once per row. (MT, NW) is chosen by the caller so
// that the grid fills the card at small S.

#include "mha_common.cuh"

namespace {

using namespace mha;

constexpr int kBK = 128;  // keys per tile
constexpr int kStages = 2;

template <int D, int MT, int NW>
struct FwdConfig {
  static constexpr int kThreads = NW * 32;
  static constexpr int kRows = 16 * MT * NW;  // query rows per block
  static constexpr int kTile = kBK * Tile<D>::kStride;  // bf16 elements
  static constexpr int kSmem = 2 * kStages * kTile * 2;  // K and V rings
};

template <int D, int MT, int NW>
__global__ void __launch_bounds__(NW * 32)
mha_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, float scale) {
  using C = FwdConfig<D, MT, NW>;
  constexpr int RS = Tile<D>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kStages * C::kTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)blockIdx.y * Sq * D;  // q, o
  const bf16* kb = k + (size_t)blockIdx.y * Sk * D;
  const bf16* vb = v + (size_t)blockIdx.y * Sk * D;
  // m-tile mt holds rows r0 + 16 mt + g and + 8.
  const int r0 = blockIdx.x * C::kRows + warp * 16 * MT;
  const int off_nt = ldsm_row(lane) * RS + ldsm_col(lane);
  const int off_t = ldsm_t_row(lane) * RS + ldsm_t_col(lane);
  const float c = scale * kLog2e;

  uint32_t qf[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_a<D>(qf[mt], q + base, r0 + 16 * mt + g, t);

  // Items 0..nT-1: K tiles of pass 1; nT..2nT-1: K and V tiles of pass 2.
  const int nT = Sk / kBK;
  auto issue = [&](int i) {
    if (i < 2 * nT) {
      const int st = i % kStages, key0 = (i % nT) * kBK;
      load_tile<D, kBK, C::kThreads>(ks + st * C::kTile, kb, key0);
      if (i >= nT) load_tile<D, kBK, C::kThreads>(vs + st * C::kTile, vb, key0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float s[MT][2][4];

  // Pass 1: exact row max of the raw logits over all keys.
  float mx[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY;
  for (int i = 0; i < nT; ++i) {
    const bf16* kt = ks + ring_advance<kStages>(i, issue) * C::kTile;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      product_nt<D, MT>(s, qf, kt + 16 * j * RS, off_nt);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mx[mt][0] = fmaxf(mx[mt][0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[mt][1] = fmaxf(mx[mt][1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
    }
  }
  // m2 = max * scale * log2e (scale > 0, so the max commutes with it).
  float m2[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) m2[mt][h] = quad_max(mx[mt][h]) * c;

  // Pass 2: P = 2^(s c - m2), f32 row sums, acc += bf16(P) . V.
  float acc[MT][D / 8][4];
  float l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }
  for (int i = nT; i < 2 * nT; ++i) {
    const int st = ring_advance<kStages>(i, issue);
    const bf16* kt = ks + st * C::kTile;
    const bf16* vt = vs + st * C::kTile;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      product_nt<D, MT>(s, qf, kt + 16 * j * RS, off_nt);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[mt][n][0] = ex2(fmaf(s[mt][n][0], c, -m2[mt][0]));
          s[mt][n][1] = ex2(fmaf(s[mt][n][1], c, -m2[mt][0]));
          s[mt][n][2] = ex2(fmaf(s[mt][n][2], c, -m2[mt][1]));
          s[mt][n][3] = ex2(fmaf(s[mt][n][3], c, -m2[mt][1]));
          l[mt][0] += s[mt][n][0] + s[mt][n][1];
          l[mt][1] += s[mt][n][2] + s[mt][n][3];
        }
        to_a(a[mt], s[mt]);
      }
      accumulate_nn<D, MT>(acc, a, vt + 16 * j * RS, off_t);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = quad_sum(l[mt][0]), l1 = quad_sum(l[mt][1]);
    const int r = r0 + 16 * mt + g;
    store_rows<D>(o + base, r, t, acc[mt], 1.f / l0, 1.f / l1);
    if (lse != nullptr && t == 0) {
      // Rounded adds and multiplies, never contracted into an FMA with
      // log2f's last product: nvcc contracted them in some instantiations
      // and not in others, so a row's L depended on the block, and a vp
      // rank's rows were not the full-length call's.
      float* lr = lse + (size_t)blockIdx.y * Sq + r;
      lr[0] = __fmul_rn(__fadd_rn(m2[mt][0], log2f(l0)), kLn2);
      lr[8] = __fmul_rn(__fadd_rn(m2[mt][1], log2f(l1)), kLn2);
    }
  }
}

template <int D, int MT, int NW>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int BH, int Sq, int Sk, float scale, cudaStream_t st, int device) {
  using C = FwdConfig<D, MT, NW>;
  if (Sq % C::kRows != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err = allow_smem(
      (const void*)mha_fwd_kernel<D, MT, NW>, C::kSmem, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Sq / C::kRows, BH);
  mha_fwd_kernel<D, MT, NW><<<grid, C::kThreads, C::kSmem, st>>>(
      q, k, v, o, lse, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
             int BH, int Sq, int Sk, float scale, int mt, int nw,
             cudaStream_t st, int device) {
#define K1_CASE(MT, NW)                                                   \
  case MT * 10 + NW:                                                      \
    return launch<D, MT, NW>(q, k, v, o, lse, BH, Sq, Sk, scale, st, device);
  switch (mt * 10 + nw) {
    K1_CASE(2, 8) K1_CASE(2, 4) K1_CASE(1, 8) K1_CASE(1, 4) K1_CASE(1, 2)
    K1_CASE(1, 1)
  }
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o: [BH, Sq, D] and k, v: [BH, Sk, D], contiguous bf16 on device
// ``device``, 16-byte aligned; lse: [BH, Sq] f32 or null (then not
// written). D = 32; Sk a multiple of 128; Sq a multiple of the
// block's rows 16 * mt * nw; scale > 0; (mt, nw)
// in {(2, 8), (2, 4), (1, 8), (1, 4), (1, 2), (1, 1)}. Launches on
// ``stream``; returns cudaGetLastError().
int mha_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Sq, int Sk, int D, float scale, int mt,
                 int nw, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Sk % kBK != 0 || Sq <= 0 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto* ll = static_cast<float*>(lse);
  if (D != 32) return (int)cudaErrorInvalidValue;
  return launch_d<32>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, mt, nw, st,
                      device);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
