// Kernel K1, Hopper's design, at head dim D = 32 or 64: the forward of
// full (unmasked) multi-head attention, bf16 in and out, and the f32
// logsumexp of each row where the caller asks for it.
//
// Replaces lgm_tpu/ops/mha.py::_fwd_kernel (via _mha_fwd / mha_kresident),
// the TPU's K-resident Pallas kernel; the function is the same, every
// rounding included: per (batch*head, query row) the exact softmax of the
// scaled logits (the row max over ALL keys before any exponential, so two
// passes over the keys and no online rescaling), P = 2^(s c - m2) rounded
// to bf16 before P.V, the f32 row sum l of the unrounded P as divisor, f32
// accumulation, the output rounded to bf16, and L = (m2 + log2 l) ln 2.
// ops/mha.py routes every call here. A row reads only its own q row and
// every key in order, whatever the block and Sq, so a vp rank's rows (Sq
// = S / vp) are bit for bit the rows of the Sq = Sk call.
//
// What bounds it on an H100 (SXM peaks at 700 W): at the diffusion
// U-Net's level 0 (D = 64, S 4096-5120) the tensor cores: Q.K^T and P.V
// are 4 BH S^2 D flops (0.068 ms at S 5120, BH 10), and the exact softmax
// forms Q.K^T once more in pass 1. At LGM's cross-view sites (D = 32, S
// 4096) the BH S^2 exps on the SFUs (0.064 ms at BH 16), the tensor work
// 0.052 ms behind them. Either way the exps have to run while the tensor
// cores work, which wgmma.mma_async, issued and waited for separately,
// can arrange.
//
// The design: a block is one producer warpgroup and NC consumer warpgroups
// (1, 2, or at D = 32 4), each consumer owning 64 query rows. One thread of
// the producer puts the block's Q boxes in shared memory once, then keeps
// TMA loads of 128-key tiles of K (pass 1) and K and V (pass 2) in flight
// through a ring of kStages swizzled stages, each completing on its "full"
// mbarrier; the consumers release a stage on its "empty" mbarrier when the
// products that read it are done. The consumers take a tile in steps of
// KS keys: a whole tile at NC 1-2, 64 keys at NC 4, whose four consumers
// share the registers a thread gets (102 at 640 threads) and keep 16 warps
// of exps in flight on an SM where two consumers keep 8. Pass 1: S =
// Q.K^T by wgmma m64nKSk16 (Q and K both K-major from shared memory) into
// two S buffers, so that the product of step u + 1 runs while the raw row
// max of step u is taken. Pass 2, per step u: Q.K^T of step u + 1 and P.V
// of step u are issued asynchronously, then the exps of step u + 1 run
// while P.V of step u is on the tensor cores; P goes from the accumulator
// registers, rounded to bf16, straight in as the register A operand of
// P.V (m64nDk16), V read MN-major from the same swizzled tile as it was
// loaded, with no transpose. The output is multiplied by 1/l once a row
// and stored from the registers.

#include "mha_wgmma.cuh"

namespace {

using namespace mha;

constexpr int kKeys = 128;                   // keys a tile
// Stages of the ring, each a K and a V tile.
constexpr int kStages = 4;

template <int D, int NC>
struct FwdLayout {
  // Keys a step of the consumers' products: a tile (128), or 64 where four
  // consumer warpgroups share the registers.
  static constexpr int kStep = NC == 4 ? 64 : 128;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBoxBytes = wg::Rows<D>::kBoxBytes;
  static constexpr int kTileBytes = kKeys * wg::Rows<D>::kBytes;  // K or V
  static constexpr int kRing = NC * kBoxBytes;  // after the Q boxes
  static constexpr int kBars = kRing + kStages * 2 * kTileBytes;
  // Q's barrier, then kStages full and kStages empty barriers.
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// ptxas gives every thread the launch bound's share of the registers
// (65,536 / (128 (NC + 1)): 168 at NC = 2, 102 at NC = 4), so the
// consumers fit in it.

// NC consumer warpgroups of 64 query rows after the producer warpgroup.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mha_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int Sq,
                     int Sk, float scale) {
  using L = FwdLayout<D, NC>;
  constexpr int kBoxBytes = L::kBoxBytes, kTileBytes = L::kTileBytes;
  constexpr int KS = L::kStep, kSteps = kKeys / KS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int nT = Sk / kKeys;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * 64 * NC;  // the block's first query row
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], NC * 4);  // one arrival a consumer warp
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (group == 0) {
    // Producer. Items 0..nT-1: K tiles of pass 1; nT..2nT-1: K and V
    // tiles of pass 2; item i in stage i % kStages.
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(q_full, NC * kBoxBytes);
      for (int c = 0; c < NC; ++c)
        wg::tma_box(smem + c * kBoxBytes, &tq, q_full,
                    bh * Sq + row0 + 64 * c);
      for (int i = 0; i < 2 * nT; ++i) {
        const int s = i % kStages;
        if (i >= kStages) wg::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        unsigned char* kt = smem + L::kRing + s * 2 * kTileBytes;
        const int key = bh * Sk + (i % nT) * kKeys;
        wg::mbar_expect_tx(&full[s], (i < nT ? 1 : 2) * kTileBytes);
        wg::tma_box(kt, &tk, &full[s], key);
        wg::tma_box(kt + kBoxBytes, &tk, &full[s], key + 64);
        if (i >= nT) {
          wg::tma_box(kt + kTileBytes, &tv, &full[s], key);
          wg::tma_box(kt + kTileBytes + kBoxBytes, &tv, &full[s],
                      key + 64);
        }
      }
    }
  } else {
    // Consumer warpgroup c: query rows row0 + 64 c .. + 63.
    const int c = group - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float cc = scale * kLog2e;
    const uint32_t q_tile = smem_u32(smem + c * kBoxBytes);
    const uint32_t ring = smem_u32(smem + L::kRing);
    wg::mbar_wait(q_full, 0);

    // Step u: keys (u % kSteps) KS .. + KS - 1 of item u / kSteps (steps
    // 0 .. U - 1 pass 1, U .. 2U - 1 pass 2); its K rows, and its V rows
    // at + kTileBytes, in that item's stage.
    const int U = nT * kSteps;
    auto k_step = [&](int u) {
      return ring + ((u / kSteps) % kStages) * 2 * kTileBytes +
             (u % kSteps) * KS * wg::Rows<D>::kBytes;
    };
    // S = Q.K^T of step u into d, issued and committed, not waited for.
    auto issue_qk = [&](float (&d)[KS / 2], int u) {
      const int i = u / kSteps;
      if (u % kSteps == 0)
        wg::mbar_wait(&full[i % kStages], (i / kStages) & 1);
      wg::own(d);
      wg::fence();
      wg::product_nt<KS, D>(d, q_tile, k_step(u));
      wg::commit();
    };
    // Step u's item's stage is free once this warp's products reading it
    // are done, after the item's last step.
    auto release = [&](int u) {
      if (u % kSteps == kSteps - 1 && lane == 0)
        wg::mbar_arrive(&empty[(u / kSteps) % kStages]);
    };

    // Pass 1: the raw row max over all keys, two S buffers so that the
    // product of step u + 1 runs while the max of step u is taken.
    float s[KS / 2], s2[KS / 2];
    float mx0 = -INFINITY, mx1 = -INFINITY;
    auto row_max = [&](int u, float (&d)[KS / 2]) {
      wg::own(d);
      release(u);
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(d[4 * j], d[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(d[4 * j + 2], d[4 * j + 3]));
      }
    };
    issue_qk(s, 0);
    for (int u = 0; u < U; u += 2) {
      if (u + 1 < U) {
        issue_qk(s2, u + 1);
        wg::wait<1>();
      } else {
        wg::wait<0>();
      }
      row_max(u, s);
      if (u + 1 < U) {
        if (u + 2 < U) {
          issue_qk(s, u + 2);
          wg::wait<1>();
        } else {
          wg::wait<0>();
        }
        row_max(u + 1, s2);
      }
    }
    // m2 = max * scale * log2e (scale > 0, so the max commutes with it).
    const float m0 = quad_max(mx0) * cc, m1 = quad_max(mx1) * cc;

    // Pass 2: P = 2^(s c - m2), f32 row sums, acc += bf16(P) . V. Per step
    // u, Q.K^T of step u + 1 and P.V of step u are issued together, then
    // the exps of step u + 1 run while P.V of step u is on the tensor
    // cores; P goes from the accumulator registers, rounded to bf16,
    // straight in as the register A operand of P.V.
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    uint32_t p[KS / 16][4];
    auto softmax = [&]() {
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], cc, -m0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], cc, -m0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], cc, -m1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], cc, -m1));
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }
    };
    issue_qk(s, U);
    wg::wait<0>();
    wg::own(s);
    softmax();
    wg::to_a<KS / 16>(p, s);
    for (int u = U; u < 2 * U; ++u) {
      const bool more = u + 1 < 2 * U;
      if (more) issue_qk(s, u + 1);
      wg::own(acc);
      wg::own(p);
      wg::fence();
      wg::accumulate_nn<KS / 16, D>(acc, p, k_step(u) + kTileBytes);
      wg::commit();
      if (more) {
        wg::wait<1>();  // Q.K^T of step u + 1; P.V of step u runs on
        wg::own(s);
        softmax();
      }
      wg::wait<0>();
      wg::own(acc);
      wg::own(p);
      release(u);
      if (more) wg::to_a<KS / 16>(p, s);
    }

    const float L0 = quad_sum(l0), L1 = quad_sum(l1);
    const int r = row0 + 64 * c + 16 * warp + g;
    wg::store_rows<D>(o + (size_t)bh * Sq * D, r, t, acc, 1.f / L0,
                      1.f / L1);
    if (lse != nullptr && t == 0) {
      // Rounded adds and multiplies, never contracted into an FMA with
      // log2f's last product: nvcc did so in some instantiations and not
      // others, which broke a vp rank's rows.
      float* lr = lse + (size_t)bh * Sq + r;
      lr[0] = __fmul_rn(__fadd_rn(m0, log2f(L0)), kLn2);
      lr[8] = __fmul_rn(__fadd_rn(m1, log2f(L1)), kLn2);
    }
  }
}

template <int D, int NC>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int BH, int Sq, int Sk, float scale, cudaStream_t st, int device) {
  using L = FwdLayout<D, NC>;
  if (Sq % (64 * NC) != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = rows_map<D>(&tq, q, (long)BH * Sq);
  if (err == cudaSuccess) err = rows_map<D>(&tk, k, (long)BH * Sk);
  if (err == cudaSuccess) err = rows_map<D>(&tv, v, (long)BH * Sk);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[64];
  err = allow_smem((const void*)mha_fwd_wgmma_kernel<D, NC>, L::kSmem,
                   device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_fwd_wgmma_kernel<D, NC>
      <<<dim3(Sq / (64 * NC), BH), L::kThreads, L::kSmem, st>>>(
          tq, tk, tv, o, lse, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [BH, Sq, D] and k, v: [BH, Sk, D], contiguous bf16 on device
// ``device``, 16-byte aligned; lse: [BH, Sq] f32 or null (then not
// written). D must be 32 or 64; Sk a multiple of 128; scale > 0; nc (consumer
// warpgroups a block) 1 or 2, and Sq a multiple of 64 * nc. Launches on
// ``stream``; returns cudaGetLastError() (or the error that refused the
// launch).
int mha_fwd_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int Sq, int Sk, int D, float scale,
                       int nc, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 32 && D != 64) || Sk % kKeys != 0 || Sq <= 0 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto* ll = static_cast<float*>(lse);
  if (D == 32 && nc == 4)
    return launch<32, 4>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st, device);
  if (nc != 1 && nc != 2) return (int)cudaErrorInvalidValue;
  if (D == 32)
    return nc == 2
               ? launch<32, 2>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st,
                               device)
               : launch<32, 1>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st,
                               device);
  return nc == 2
             ? launch<64, 2>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st, device)
             : launch<64, 1>(qq, kk, vv, oo, ll, BH, Sq, Sk, scale, st,
                             device);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
