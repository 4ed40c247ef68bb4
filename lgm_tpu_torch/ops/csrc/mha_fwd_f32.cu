// Kernel K1 on f32 inputs, at head dim D = 32 or 64: the forward of full
// (unmasked) multi-head attention, f32 in and out, and the f32 logsumexp of
// each row where the caller asks for it.
//
// Replaces lgm_tpu/ops/mha.py::_fwd_kernel (via _mha_fwd / mha_kresident)
// where lgm_tpu runs it on f32 inputs (``--mixed-precision fp32``). The
// function is exact softmax attention in f32, the port's plain version at
// f32 (ops/mha.py::mha_reference): per (batch*head, query row) the row max
// of the scaled logits over ALL keys before any exponential (two passes
// over the keys, no online rescaling), P = 2^(s c - m2) in f32 (c = scale
// log2e), the f32 row sum l of P as divisor, P.V with f32 accumulation,
// and L = (m2 + log2 l) ln 2. Nothing is rounded below f32: lgm_tpu's
// kernel body rounds P to bf16 at any input dtype, but lgm_tpu runs f32
// attention exactly wherever its kernel does not (README). A row reads
// only its own q row and every key in order, whatever the block and Sq,
// so a vp rank's rows (Sq = S / vp) are bit for bit the rows of the Sq =
// Sk call.
//
// What bounds it on an H100 (SXM peaks at 700 W): the tensor cores. The
// function's Q.K^T and P.V are 4 BH Sq Sk D flops; at f32 grade each takes
// three TF32 products (3xTF32, mha_f32.cuh), 12 BH Sq Sk D TF32 flops
// against 495 TFLOP/s: 0.21 ms at LGM big's S 4096 sites (BH 16, D 32).
// The exact softmax forms Q.K^T once more for the row max, here in one
// TF32 pass (it only shifts the exponentials): 14 BH Sq Sk D in all. The
// BH Sq Sk exps on the SFUs (0.06 ms there) come next.
//
// The design: a block of NW warps owns 16 NW query rows, each warp 16 rows
// with their Q fragments in registers (f32, split into TF32 halves at each
// product). K and V stream through shared memory 64 keys a tile in a
// 2-stage cp.async ring (the copy of tile i + 1 is in flight while tile i
// computes). Pass 1 forms Q.K^T 32 keys a step (four independent n-tiles)
// in one TF32 pass and keeps the raw row max; pass 2 forms it again at
// f32 grade, takes P = 2^(s c - m2) (one FMA and one ex2 a logit), sums
// the f32 P, and feeds P from the accumulator registers straight in as
// the A operand of P.V (k index permuted, mha_f32.cuh), V read from the
// [key][d] tile as it was copied. The output is multiplied by 1/l once a
// row. NW is 8 where the rows fill the card in 128-row blocks, else 4.

#include "mha_f32.cuh"

namespace {

using namespace mha;
using namespace mha::f32;

constexpr int kStep = 32;  // keys a step of the products: four n-tiles

template <int D, int NW>
struct FwdLayout {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kRows = 16 * NW;  // query rows a block
  static constexpr int kSmem = 2 * kStages * Tile<D>::kFloats * 4;  // K, V
};

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
mha_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int Sq, int Sk, float scale) {
  using L = FwdLayout<D, NW>;
  constexpr int RS = Tile<D>::kStride, TF = Tile<D>::kFloats;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kStages * TF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  const int r = blockIdx.x * L::kRows + 16 * warp + g;  // rows r, r + 8
  const size_t row = (size_t)bh * Sq + r;
  const float cc = scale * kLog2e;

  float qa[D / 8][4];
  load_a<D>(qa, q + row * D, t);

  // Items 0..nT-1: K tiles of pass 1; nT..2nT-1: K and V tiles of pass 2.
  const int nT = Sk / kTile;
  auto fetch = [&](int i) {
    if (i < 2 * nT) {
      const int st = i % kStages, key0 = (i % nT) * kTile;
      load_tile<D, L::kThreads>(ks + st * TF, kb, key0);
      if (i >= nT) load_tile<D, L::kThreads>(vs + st * TF, vb, key0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);

  float s[kStep / 8][4];

  // Pass 1: the row max of the raw logits over all keys (one TF32 pass:
  // the max only shifts the exponentials, and P = 2^(s c - m2) / l does not
  // depend on it beyond rounding).
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int i = 0; i < nT; ++i) {
    const float* kt = ks + ring_advance<kStages>(i, fetch) * TF;
#pragma unroll
    for (int j = 0; j < kTile / kStep; ++j) {
      product_nt<D, kStep / 8, false>(s, qa, kt + j * kStep * RS, g, t);
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    }
  }
  // m2 = max * scale * log2e (scale > 0, so the max commutes with it).
  const float m0 = quad_max(mx0) * cc, m1 = quad_max(mx1) * cc;

  // Pass 2: P = 2^(s c - m2), f32 row sums, acc += P.V, all at f32 grade.
  float acc[D / 8][4];
  zero<D>(acc);
  float l0 = 0.f, l1 = 0.f;
  for (int i = nT; i < 2 * nT; ++i) {
    const int st = ring_advance<kStages>(i, fetch);
    const float* kt = ks + st * TF;
    const float* vt = vs + st * TF;
#pragma unroll
    for (int j = 0; j < kTile / kStep; ++j) {
      product_nt<D, kStep / 8, true>(s, qa, kt + j * kStep * RS, g, t);
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n) {
        s[n][0] = ex2(fmaf(s[n][0], cc, -m0));
        s[n][1] = ex2(fmaf(s[n][1], cc, -m0));
        s[n][2] = ex2(fmaf(s[n][2], cc, -m1));
        s[n][3] = ex2(fmaf(s[n][3], cc, -m1));
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
      accumulate_nn<D, kStep / 8>(acc, s, vt + j * kStep * RS, g, t);
    }
  }

  const float L0 = quad_sum(l0), L1 = quad_sum(l1);
  store_rows<D>(o + row * D, t, acc, 1.f / L0, 1.f / L1);
  if (lse != nullptr && t == 0) {
    // Rounded adds and multiplies, never contracted into an FMA with
    // log2f's last product, so that a row's L does not depend on the
    // instantiation (a vp rank's rows are the full call's).
    lse[row] = __fmul_rn(__fadd_rn(m0, log2f(L0)), kLn2);
    lse[row + 8] = __fmul_rn(__fadd_rn(m1, log2f(L1)), kLn2);
  }
}

template <int D, int NW>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int BH, int Sq, int Sk, float scale, cudaStream_t st,
           int device) {
  using L = FwdLayout<D, NW>;
  if (Sq % L::kRows != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err = allow_smem((const void*)mha_fwd_f32_kernel<D, NW>,
                                     L::kSmem, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_fwd_f32_kernel<D, NW>
      <<<dim3(Sq / L::kRows, BH), L::kThreads, L::kSmem, st>>>(
          q, k, v, o, lse, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [BH, Sq, D] and k, v: [BH, Sk, D], contiguous f32 on device
// ``device``, 16-byte aligned; lse: [BH, Sq] f32 or null (then not
// written). D must be 32 or 64; Sk a multiple of 128; scale > 0; nw (warps
// a block) 4 or 8, and Sq a multiple of 16 * nw. Launches on ``stream``;
// returns cudaGetLastError() (or the error that refused the launch).
int mha_fwd_f32(const void* q, const void* k, const void* v, void* o,
                void* lse, int BH, int Sq, int Sk, int D, float scale, int nw,
                void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 32 && D != 64) || Sk % 128 != 0 || Sq <= 0 || !(scale > 0.f) ||
      (nw != 4 && nw != 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(o);
  auto* ll = static_cast<float*>(lse);
  if (D == 32)
    return nw == 8
               ? launch<32, 8>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st,
                               device)
               : launch<32, 4>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st,
                               device);
  return nw == 8
             ? launch<64, 8>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st, device)
             : launch<64, 4>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st,
                             device);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
