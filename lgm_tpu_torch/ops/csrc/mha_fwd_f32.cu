// Kernel K1 on f32 inputs, Hopper's design, at head dim D = 32 or 64: the
// forward of full (unmasked) multi-head attention, f32 in and out, and the
// f32 logsumexp of each row where the caller asks for it.
//
// Replaces lgm_tpu/ops/mha.py::_fwd_kernel (via _mha_fwd / mha_kresident)
// where lgm_tpu runs it on f32 inputs (``--mixed-precision fp32``). The
// function is exact softmax attention in f32, the port's plain version at
// f32 (ops/mha.py::mha_reference): per (batch*head, query row) the row max
// of the scaled logits over ALL keys before any exponential (two passes
// over the keys, no online rescaling), P = 2^(s c - m2) in f32 (c = scale
// log2e), the f32 row sum l of P as divisor, P.V at f32 grade, and L =
// (m2 + log2 l) ln 2. Nothing is rounded below f32: lgm_tpu's kernel body
// rounds P to bf16 at any input dtype, but lgm_tpu runs f32 attention
// exactly wherever its kernel does not (README). A row reads only its own
// q row and every key in order, whatever the block and Sq, so a vp rank's
// rows (Sq = S / vp) are bit for bit the rows of the Sq = Sk call.
//
// What bounds it on an H100 (SXM peaks at 700 W): the tensor cores. The
// function's Q.K^T and P.V are 4 BH Sq Sk D flops; at f32 grade each takes
// three TF32 products (3xTF32, mha_f32.cuh), 12 BH Sq Sk D TF32 flops
// against 495 TFLOP/s: 0.21 ms at LGM big's S 4096 sites (BH 16, D 32).
// The exact softmax forms Q.K^T once more for the row max, in one TF32
// pass (it only shifts the exponentials): 14 BH Sq Sk D in all. The BH Sq
// Sk exps on the SFUs (0.06 ms there) come next.
//
// The design, the bf16 K1's (mha_fwd_wgmma.cu) on TF32 operands: the
// wrapper first runs the split pass (mha_split_tf32.cu), which writes the
// hi and lo planes of Q and K row-major and of V transposed. A block is
// one producer warpgroup and NC consumer warpgroups (1, 2, or at D = 32
// 4), each consumer owning 64 query rows. One thread of the producer puts
// the block's Q halves in shared memory once, then keeps TMA loads of
// 32-key tiles in flight through a ring of swizzled stages on full/empty
// mbarriers: K hi (pass 1), then K hi, K lo, V^T hi and V^T lo (pass 2).
// Pass 1: S = Q_hi.K_hi^T (wgmma m64n32k8, both operands K-major from
// shared memory) into two S buffers, so that the product of tile u + 1
// runs while the raw row max of tile u is taken. Pass 2, per tile u: S of
// tile u + 1 (three products) and P.V of tile u are issued together, then
// the exps of tile u + 1 run while P.V of tile u is on the tensor cores; P
// goes from the accumulator registers, split into halves, straight in as
// the register A operand of P.V (m64nDk8, k index permuted, V^T's rows
// permuted to match), summed from 0 a tile and added to the output row by
// rounded f32 adds. At four consumers (96 registers a thread) pass 2 takes
// a tile at a time instead, and the other consumers' products overlap a
// consumer's exps. The output is multiplied by 1/l once a row and stored
// from the registers.

#include "mha_f32.cuh"

namespace {

using namespace mha;
using tf32::kRows;

template <int D, int NC>
struct FwdLayout {
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kHalf = 64 * D * 4;     // a consumer's Q hi (or lo)
  static constexpr int kQ = NC * 2 * kHalf;    // every consumer's Q halves
  static constexpr int kTile = kRows * D * 4;  // a 32-key plane tile
  static constexpr int kStage = 4 * kTile;     // K hi, K lo, V^T hi, V^T lo
  static constexpr int kFit =
      (tf32::kSmemMax - tf32::kSmemSlack - kQ) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBars = kQ + kStages * kStage;
  // Q's barrier, then kStages full and kStages empty barriers.
  static constexpr int kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kStages >= 2, "at least two stages");
  // Pass 2 issues S of tile u + 1 beside P.V of tile u (1-2 consumers),
  // or takes a tile at a time (4 consumers, whose registers would not
  // hold S beside P's halves).
  static constexpr bool kOverlap = NC < 4;
};

// The planes a launch reads.
struct Maps {
  PlaneMaps q, k, vt;
};

// ptxas gives every thread the launch bound's share of the registers
// (65,536 / (128 (NC + 1)): 168 at NC = 2, 102 at NC = 4).

// NC consumer warpgroups of 64 query rows after the producer warpgroup.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
mha_fwd_f32_kernel(const __grid_constant__ Maps m, float* __restrict__ o,
                   float* __restrict__ lse, int Sq, int Sk, float scale) {
  using L = FwdLayout<D, NC>;
  constexpr int S = L::kStages, kTile = L::kTile, kHalf = L::kHalf;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;
  const int nT = Sk / kRows;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * 64 * NC;  // the block's first query row
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], NC * 4);  // one arrival a consumer warp
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (group == 0) {
    // Producer. Items 0..nT-1: K hi tiles of pass 1; nT..2nT-1: K hi, K
    // lo, V^T hi and V^T lo tiles of pass 2; item i in stage i % S.
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < NC; ++c) {
        const int row = bh * Sq + row0 + 64 * c;
        unsigned char* qc = smem + c * 2 * kHalf;
        tf32::load_rows<D>(qc, &m.q.hi, q_full, row, 64);
        tf32::load_rows<D>(qc + kHalf, &m.q.lo, q_full, row, 64);
      }
      for (int i = 0; i < 2 * nT; ++i) {
        const int s = i % S;
        if (i >= S) wg::mbar_wait(&empty[s], (i / S - 1) & 1);
        unsigned char* st = smem + L::kQ + s * L::kStage;
        const int key = (i % nT) * kRows;
        wg::mbar_expect_tx(&full[s], (i < nT ? 1 : 4) * kTile);
        tf32::load_rows<D>(st, &m.k.hi, &full[s], bh * Sk + key, kRows);
        if (i >= nT) {
          tf32::load_rows<D>(st + kTile, &m.k.lo, &full[s], bh * Sk + key,
                             kRows);
          tf32::tma(st + 2 * kTile, &m.vt.hi, &full[s], key, bh * D);
          tf32::tma(st + 3 * kTile, &m.vt.lo, &full[s], key, bh * D);
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
    const uint32_t q_hi = smem_u32(smem + c * 2 * kHalf);
    const uint32_t q_lo = q_hi + kHalf;
    const uint32_t ring = smem_u32(smem + L::kQ);
    wg::mbar_wait(q_full, 0);

    // Item u (tiles 0 .. nT - 1 pass 1, nT .. 2 nT - 1 pass 2) in its
    // stage: K hi, K lo, V^T hi, V^T lo.
    const int U = nT;
    auto stage = [&](int u) { return ring + (u % S) * L::kStage; };
    // S of item u into d (three products in pass 2, hi.hi in pass 1),
    // issued and committed, not waited for.
    auto issue_qk = [&](float (&d)[16], int u) {
      wg::mbar_wait(&full[u % S], (u / S) & 1);
      const uint32_t kt = stage(u);
      wg::own(d);
      wg::fence();
      if (u < U)
        tf32::product_nt<D, false>(d, q_hi, q_lo, 64 * 128, kt, kt + kTile);
      else
        tf32::product_nt<D, true>(d, q_hi, q_lo, 64 * 128, kt, kt + kTile);
      wg::commit();
    };
    // Item u's stage is free once this warp's products reading it are
    // done.
    auto release = [&](int u) {
      if (lane == 0) wg::mbar_arrive(&empty[u % S]);
    };

    // Pass 1: the raw row max over all keys (one TF32 pass: the max only
    // shifts the exponentials, and P = 2^(s c - m2) / l does not depend on
    // it beyond rounding).
    float s[16], s2[16];
    float mx0 = -INFINITY, mx1 = -INFINITY;
    auto row_max = [&](int u, float (&d)[16]) {
      wg::own(d);
      release(u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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

    // Pass 2: P = 2^(s c - m2), f32 row sums, acc += P.V at f32 grade.
    float acc[D / 2], part[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    uint32_t ph[4][4], pl[4][4];
    auto softmax = [&]() {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], cc, -m0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], cc, -m0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], cc, -m1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], cc, -m1));
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }
    };
    if constexpr (!L::kOverlap) {
      // Four consumers share an SM's registers (96 a thread): the exps of
      // one warpgroup overlap the others' products, and S is not kept
      // beside P's halves.
      for (int u = U; u < 2 * U; ++u) {
        issue_qk(s, u);
        wg::wait<0>();
        wg::own(s);
        softmax();
        tf32::to_a(ph, pl, s);
        wg::own(part);
        wg::own(ph);
        wg::own(pl);
        wg::fence();
        tf32::product_nn<D>(part, ph, pl, stage(u) + 2 * kTile,
                            stage(u) + 3 * kTile);
        wg::commit();
        wg::wait<0>();
        wg::own(part);
        wg::own(ph);
        wg::own(pl);
        release(u);
        tf32::add_rn(acc, part);
      }
    } else {
      issue_qk(s, U);
      wg::wait<0>();
      wg::own(s);
      softmax();
      tf32::to_a(ph, pl, s);
      for (int u = U; u < 2 * U; ++u) {
        const bool more = u + 1 < 2 * U;
        if (more) issue_qk(s, u + 1);
        wg::own(part);
        wg::own(ph);
        wg::own(pl);
        wg::fence();
        tf32::product_nn<D>(part, ph, pl, stage(u) + 2 * kTile,
                            stage(u) + 3 * kTile);
        wg::commit();
        if (more) {
          wg::wait<1>();  // S of tile u + 1; P.V of tile u runs on
          wg::own(s);
          softmax();
        }
        wg::wait<0>();
        wg::own(part);
        wg::own(ph);
        wg::own(pl);
        release(u);
        tf32::add_rn(acc, part);
        if (more) tf32::to_a(ph, pl, s);
      }
    }

    const float L0 = quad_sum(l0), L1 = quad_sum(l1);
    const int r = row0 + 64 * c + 16 * warp + g;
    wg::store_rows<D>(o + (size_t)bh * Sq * D, r, t, acc, 1.f / L0,
                      1.f / L1);
    if (lse != nullptr && t == 0) {
      // Rounded adds and multiplies, never contracted into an FMA with
      // log2f's last product, so that a row's L does not depend on the
      // instantiation (a vp rank's rows are the full call's).
      float* lr = lse + (size_t)bh * Sq + r;
      lr[0] = __fmul_rn(__fadd_rn(m0, log2f(L0)), kLn2);
      lr[8] = __fmul_rn(__fadd_rn(m1, log2f(L1)), kLn2);
    }
  }
}

template <int D, int NC>
int launch(const Maps& m, float* o, float* lse, int BH, int Sq, int Sk,
           float scale, cudaStream_t st, int device) {
  using L = FwdLayout<D, NC>;
  if (Sq % (64 * NC) != 0) return (int)cudaErrorInvalidValue;
  static bool smem_set[64];
  const cudaError_t err = allow_smem((const void*)mha_fwd_f32_kernel<D, NC>,
                                     L::kSmem, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  mha_fwd_f32_kernel<D, NC>
      <<<dim3(Sq / (64 * NC), BH), L::kThreads, L::kSmem, st>>>(
          m, o, lse, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// planes: the split pass's six planes (mha_split_tf32.cu), Q hi, Q lo
// ([BH, Sq, D]), K hi, K lo ([BH, Sk, D]), V^T hi, V^T lo ([BH, D, Sk],
// rows permuted); o: [BH, Sq, D]; lse: [BH, Sq] or null (then not
// written); all contiguous f32 on device ``device``, 16-byte aligned. D
// must be 32 or 64; Sk a multiple of 128; scale > 0; nc (consumer
// warpgroups a block) 1 or 2, or 4 at D = 32, and Sq a multiple of 64 nc.
// Launches on ``stream``; returns cudaGetLastError() (or the error that
// refused the launch).
int mha_fwd_f32(void* const* planes, void* o, void* lse, int BH, int Sq,
                int Sk, int D, float scale, int nc, void* stream,
                int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 32 && D != 64) || Sk % 128 != 0 || Sq <= 0 || !(scale > 0.f) ||
      !(nc == 1 || nc == 2 || (nc == 4 && D == 32)))
    return (int)cudaErrorInvalidValue;
  Maps m;
  err = rows_maps(&m.q, planes[0], planes[1], BH, Sq, D);
  if (err == cudaSuccess) err = rows_maps(&m.k, planes[2], planes[3], BH, Sk,
                                          D);
  if (err == cudaSuccess) err = cols_maps(&m.vt, planes[4], planes[5], BH,
                                          Sk, D);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* oo = static_cast<float*>(o);
  auto* ll = static_cast<float*>(lse);
  if (D == 32) {
    if (nc == 4) return launch<32, 4>(m, oo, ll, BH, Sq, Sk, scale, st, device);
    if (nc == 2) return launch<32, 2>(m, oo, ll, BH, Sq, Sk, scale, st, device);
    return launch<32, 1>(m, oo, ll, BH, Sq, Sk, scale, st, device);
  }
  if (nc == 2) return launch<64, 2>(m, oo, ll, BH, Sq, Sk, scale, st, device);
  return launch<64, 1>(m, oo, ll, BH, Sq, Sk, scale, st, device);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
