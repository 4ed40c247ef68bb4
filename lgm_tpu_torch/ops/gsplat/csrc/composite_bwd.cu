// Kernel K2 backward (K2ᵇ): the VJP of the flatsort composite, one block
// per (image tile, 128-slot chunk).
//
// Replaces lgm_tpu/ops/gsplat/flatsort.py::_bwd_kernel / _bwd_tile (via
// _run_bwd, the VJP of _composite_flat). The function is the same: from
// the forward's inputs (slot rows, counts), its output fo [T, 8, P] and the
// cotangent go [T, 8, P], each pixel replays the composite front to back
// with the forward's chunking and its tile-wide early-out, keeping the
// exclusive transmittance T_i and the running prefix of u_j = s_j w_j,
// where s_j = sum_c go_c col_c(j) over r, g, b, alpha (col 1) and depth.
// With
//   U_eff  = sum_c go_c fo_c (rows r, g, b, alpha, depth) + gT T_final
//   dalpha = s_i T_i - (U_eff - prefix_i) / max(1 - alpha_i, 0.01)  (alpha > 0)
//   dpower = dalpha * alpha                    (only where op e^power < 0.99)
// the slot's gradient is, summed over the tile's pixels,
//   d x̄ = dpower (A dx + B dy),  d ȳ = dpower (C dy + B dx),
//   d A = -dpower dx^2 / 2,  d B = -dpower dx dy,  d C = -dpower dy^2 / 2,
//   d op = (sum dpower) / max(op, 1e-12),  d col_c = go_c w
// with dx, dy tile-local. This is lgm_tpu's chain through the quadratic's
// coefficients written directly in (x̄, ȳ, A, B, C): the same numbers,
// in plain f32 (the TPU kernel's bf16 hi/lo split products emulated f32 on
// its matrix unit). Dead slots and chunks past the early-out get zeros.
//
// Layout: params and dparams [T, MPT, R] f32 slot-major (rows x̄, ȳ, A, B,
// C, op, r, g, b[, z]); fo, go [T, 8, P] (rows r, g, b, alpha, T, depth);
// state [T, MPT / 128, 6, P], K2's pixel state at each chunk boundary (T,
// then the accumulators r, g, b, alpha, depth; composite_fwd.cu).
//
// When asked (work != nullptr: a profiled run), each block adds, once at
// its end, the work the data gave it: to work[0] its visited slots times P
// (the (pixel, slot) pairs its replay visits), to work[1] the bytes it
// reads that the shapes do not fix: the state's T row where the chunk
// starts below the tile's count, and where the chunk is live the rest of
// its state, its slot rows and, in the tile's first chunk, fo's and go's
// rows 0-5.
//
// What bounds it on an H100: like K2, the (pixel, slot) pairs the replay
// visits, each one exp on the SFU and ~45 f32 operations where it
// accumulates; plus, per slot, a sum over the tile's pixels of R values.
// Bytes are small (slot rows in, gradient rows out, fo/go and the state
// once a live chunk).
//
// The design:
// - The gradient is summed over pixels as the moments of dpower about the
//   splat's centre (sum dpower dx, dy, dx^2, dx dy, dy^2, 1), then A, B,
//   C applied per slot: the same numbers as the per-pixel chain, without
//   a pixel-frame moment's cancellation; and the division in dalpha is
//   __fdividef (2 ulp; its divisor is in [0.01, 1]).
// - A pair's alpha and the transmittance behind it are composite_common.cuh's
//   pair_of and attenuate, which K2 calls too, on slots staged in K2's form
//   (tile-local centre, pre-scaled conic): the replay takes K2's alpha
//   decisions from the same bits. The write-out reads the slot's A, B, C
//   and op from params.
// - The replay does not branch on a pixel's alpha test: the four pixels'
//   chains interleave, and an unused pair adds zeros. About half the
//   bench view's visited pairs are used; there this measured 14-16% faster
//   than a branch per pixel (NVIDIA H100 80GB HBM3, 700 W). K3ᵇ, where
//   about a quarter of the pairs are used, keeps its branch.
// - One block per (tile, chunk), so that no SM waits on a heavy tile (on
//   the bench scene a tile visits 280 slots on average and up to 1,024).
//   A block starts from the state K2 stored at its chunk's first slot: T,
//   and prefix = sum_c go_c acc_c. It votes on that T, the forward's own
//   bits, so it stops where the forward stopped; a chunk past the tile's
//   count or its early-out writes zero rows and ends.
// - Each thread owns PPT pixels (4 at 32 x 32 tiles: 256 threads) and adds
//   their terms of a slot in registers, so each slot read from shared
//   memory (three 16-byte loads) serves PPT pixels.
// - The sums over pixels are composite_reduce.cuh's: a transposing warp
//   butterfly over batches of 8 slots (~11 shuffles a slot), the warps'
//   sums for the whole chunk in shared memory, then one barrier and a
//   fixed-order sum over the warps. Deterministic, no atomics.

#include "composite_common.cuh"
#include "composite_reduce.cuh"

namespace {

using namespace composite;
using namespace composite_reduce;

constexpr int kMaxPix = 1024;

template <int PPT>
__global__ void __launch_bounds__(kMaxPix / PPT, PPT == 4 ? 2 : 1)
    composite_bwd_kernel(const float* __restrict__ params,
                         const int* __restrict__ counts,
                         const float* __restrict__ fo,
                         const float* __restrict__ go,
                         const float* __restrict__ state,
                         float* __restrict__ dparams,
                         unsigned long long* __restrict__ work, int mpt, int R,
                         int tile_h, int tile_w, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem;                       // [kChunk][kSlotStride]
  float* red = smem + kChunk * kSlotStride;  // [warp][kChunk][kVals]
  const int nc = mpt / kChunk;
  const int tile = blockIdx.x / nc;
  const int c0 = (blockIdx.x % nc) * kChunk;
  const int P = tile_h * tile_w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int count = counts[tile];
  float* dblk = dparams + ((size_t)tile * mpt + c0) * R;

  // A chunk past the tile's count, or past the forward's early-out (its
  // vote at this boundary, taken on the same bits of T), gets zero rows.
  const float* st = state + ((size_t)tile * nc + c0 / kChunk) * 6 * P;
  float T[PPT];
  bool open = false;
  if (c0 < count) {
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      T[p] = st[tid + p * blockDim.x];
      open |= T[p] > kTEps;
    }
  }
  if (c0 >= count || !__syncthreads_or(open)) {
    for (int i = tid; i < kChunk * R; i += blockDim.x) dblk[i] = 0.f;
    if (work && tid == 0 && c0 < count)
      atomicAdd(work + 1, (unsigned long long)P * 4);
    return;
  }
  // This thread's pixels: tid, tid + blockDim.x, ...
  float lx[PPT], ly[PPT], pref[PPT], u_eff[PPT];
  float g0[PPT], g1[PPT], g2[PPT], g3[PPT], g5[PPT];
  const float* f = fo + (size_t)tile * 8 * P;
  const float* g = go + (size_t)tile * 8 * P;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pix = tid + p * blockDim.x;
    lx[p] = (float)(pix % tile_w);
    ly[p] = (float)(pix / tile_w);
    g0[p] = g[pix];
    g1[p] = g[P + pix];
    g2[p] = g[2 * P + pix];
    g3[p] = g[3 * P + pix];
    g5[p] = g[5 * P + pix];
    u_eff[p] = g0[p] * f[pix] + g1[p] * f[P + pix] + g2[p] * f[2 * P + pix] +
               g3[p] * f[3 * P + pix] + g5[p] * f[5 * P + pix] +
               g[4 * P + pix] * f[4 * P + pix];
    pref[p] = g0[p] * st[P + pix] + g1[p] * st[2 * P + pix] +
              g2[p] * st[3 * P + pix] + g3[p] * st[4 * P + pix] +
              g5[p] * st[5 * P + pix];
  }
  const int n = min(kChunk, count - c0);
  const int n_batched = (n + kBatch - 1) / kBatch * kBatch;
  // Stage the batches' slots as K2 does (composite_common.cuh: the
  // tile-local centre, the pre-scaled conic; rows past the count are the
  // dead slots' zero rows).
  const float* blk = params + ((size_t)tile * mpt + c0) * R;
  const float tox = (float)((tile % tiles_x) * tile_w);
  const float toy = (float)((tile / tiles_x) * tile_h);
  float4* s4 = reinterpret_cast<float4*>(slots);
  for (int j = tid; j < n_batched; j += blockDim.x)
    stage_slot(blk + j * R, R, tox, toy, s4 + 3 * j);
  __syncthreads();

  // This thread's terms of slot j, summed over its pixels, in the order of
  // K2's arithmetic. The staged depth is 0 where R = 9, so sv and v[9] drop
  // it.
  auto slot_terms = [&](int j, float (&v)[kVals]) {
    const float4 a = s4[j * 3], b = s4[j * 3 + 1], c = s4[j * 3 + 2];
    // a = (cx, cy, nA, nB), b = (nC, op, r, g), c = (b, z, 0, 0)
#pragma unroll
    for (int k = 0; k < kVals; ++k) v[k] = 0.f;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const float dx = lx[p] - a.x;
      const float dy = ly[p] - a.y;
      // K2's alpha, from the same bits (composite_common.cuh). No branch
      // on the alpha test: an unused pair has alpha = 0, so it adds exact
      // zeros and leaves T and the prefix as they are.
      const Pair q = pair_of(dx, dy, a.z, a.w, b.x, b.y);
      const float alpha = q.alpha, araw = q.araw;
      float sv = g0[p] * b.z + g1[p] * b.w + g2[p] * c.x + g3[p];
      sv += g5[p] * c.y;
      const float w = alpha * T[p];
      pref[p] += sv * w;
      const float dalpha = sv * T[p] - __fdividef(u_eff[p] - pref[p],
                                                  fmaxf(1.f - alpha, 1.f - kAlphaMax));
      // The quadratic's moments; the slot's A, B, C and constant factors
      // are applied to their sums (write-out below).
      const float dp = araw < kAlphaMax ? dalpha * alpha : 0.f;
      const float pdx = dp * dx, pdy = dp * dy;
      v[0] += pdx;
      v[1] += pdy;
      v[2] += pdx * dx;
      v[3] += pdx * dy;
      v[4] += pdy * dy;
      v[5] += dp;
      v[6] += g0[p] * w;
      v[7] += g1[p] * w;
      v[8] += g2[p] * w;
      v[9] += g5[p] * w;
      T[p] = attenuate(T[p], alpha);
    }
  };
  float* red_warp = red + warp * kChunk * kVals;
  for (int j0 = 0; j0 < n; j0 += kBatch) {
    float v[kVals];
    warp_batch(slot_terms, j0, lane, v);
    store_batch(red_warp, j0, lane, v);
  }
  __syncthreads();
  // The warps' sums, then each slot's gradient row: d x̄ = A M_x + B M_y,
  // d ȳ = C M_y + B M_x, d A = -M_xx / 2, d B = -M_xy, d C = -M_yy / 2,
  // d op = M_1 / max(op, 1e-12) from the moments M of dpower, and the
  // colour rows as summed.
  for (int i = tid; i < kChunk * R; i += blockDim.x) {
    const int j = i / R, k = i % R;
    float acc = 0.f;
    if (j < n) {
      const float* s = blk + j * R;  // the slot's x̄, ȳ, A, B, C, op
      const int row = j * kVals;
      if (k < 2) {
        const float mx = warps_sum(red, nwarps, kChunk * kVals, row);
        const float my = warps_sum(red, nwarps, kChunk * kVals, row + 1);
        acc = k == 0 ? s[2] * mx + s[3] * my : s[4] * my + s[3] * mx;
      } else {
        acc = warps_sum(red, nwarps, kChunk * kVals, row + k);
        if (k == 2 || k == 4) acc *= -0.5f;
        if (k == 3) acc = -acc;
        if (k == 5) acc /= fmaxf(s[5], 1e-12f);
      }
    }
    dblk[i] = acc;
  }
  if (work && tid == 0) {
    atomicAdd(work, (unsigned long long)n * P);
    atomicAdd(work + 1,
              4ull * ((unsigned long long)n * R + (c0 == 0 ? 18 : 6) * P));
  }
}

template <int PPT>
int launch(const float* params, const int* counts, const float* fo,
           const float* go, const float* state, float* dparams,
           unsigned long long* work, int T, int mpt, int R, int tile_h,
           int tile_w, int tiles_x, cudaStream_t stream) {
  const int threads = tile_h * tile_w / PPT;
  const size_t smem =
      (kChunk * kSlotStride + (threads / 32) * kChunk * kVals) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<PPT><<<T * (mpt / kChunk), threads, smem, stream>>>(
      params, counts, fo, go, state, dparams, work, mpt, R, tile_h, tile_w,
      tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// params, dparams [T, mpt, R] f32; counts [T] i32; fo, go [T, 8, tile_h *
// tile_w] f32; state [T, mpt / 128, 6, tile_h * tile_w] f32 from
// composite_fwd_f32; work null or int64 [2] (pairs, bytes added to); all
// contiguous on device ``device``. R in {9, 10}; mpt a multiple of 128;
// tile_h * tile_w a multiple of 32, at most 1024 (4 pixels a thread where it
// is a multiple of 128, else 2 or 1). Launches on ``stream``; returns
// cudaGetLastError().
int composite_bwd_f32(const void* params, const void* counts, const void* fo,
                      const void* go, const void* state, void* dparams,
                      void* work, int T, int mpt, int R, int tile_h, int tile_w,
                      int tiles_x, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int P = tile_h * tile_w;
  if (P > kMaxPix || P % 32 != 0 || mpt % kChunk != 0 || (R != 9 && R != 10))
    return (int)cudaErrorInvalidValue;
  auto* p = static_cast<const float*>(params);
  auto* c = static_cast<const int*>(counts);
  auto* f = static_cast<const float*>(fo);
  auto* g = static_cast<const float*>(go);
  auto* s = static_cast<const float*>(state);
  auto* d = static_cast<float*>(dparams);
  auto* w = static_cast<unsigned long long*>(work);
  auto* st = static_cast<cudaStream_t>(stream);
  if (P % 128 == 0)
    return launch<4>(p, c, f, g, s, d, w, T, mpt, R, tile_h, tile_w, tiles_x,
                     st);
  if (P % 64 == 0)
    return launch<2>(p, c, f, g, s, d, w, T, mpt, R, tile_h, tile_w, tiles_x,
                     st);
  return launch<1>(p, c, f, g, s, d, w, T, mpt, R, tile_h, tile_w, tiles_x,
                   st);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
