// Kernel K3 backward (K3ᵇ): the VJP of the v1 tiled composite, one block
// per (image tile, 128-slot chunk).
//
// Replaces lgm_tpu/ops/gsplat/tiled.py::_bwd_kernel (via _run_bwd, the VJP
// of tile_composite). The function is the same: from the forward's inputs
// (params_tiles [T, 16, K], counts, pf [P, 8]), its output fo [T, P, 8] and
// the cotangent go [T, P, 8], each pixel replays the composite front to
// back with the forward's chunking and its tile-wide early-out (the same
// block vote at each 128-slot boundary, from the same bits: the pair's
// alpha and the transmittance update are tiled_common.cuh's, shared with
// tiled_fwd.cu), keeping the exclusive transmittance T_i and the running
// prefix of u_j = s_j w_j, where s_j = gC . rgb_j + gA. With
//   U_total = sum_{c<4} go_c fo_c
//   dalpha  = s_i T_i - (U_total - prefix_i) / om - gT T_final / om,
//             om = max(1 - alpha_i, 0.01)                    (alpha_i > 0)
//   dpower  = dalpha alpha                 (only where op e^power < 0.99)
// the slot's gradient is, summed over the tile's pixels,
//   rows 0-5: pf[p, k] dpower     row 6: dalpha e^power (where unclamped)
//   rows 8-10: go_c w
// and zero in rows 7 and 11-15. Chunks the forward skipped stay zero: the
// caller hands in dparams zeroed, and the kernel writes rows 0-6 and 8-10
// of the slots it replays, up to counts[t]: the slots past it are the
// binning's zero rows, whose gradient is zero, and stay as handed in.
// state [T, K / 128, 5, P] is K3's pixel state at each chunk boundary (T,
// then the sums r, g, b, sum w; tiled_fwd.cu).
//
// What bounds it on an H100: like K3, the (pixel, slot) pairs of the live
// chunks, each one exp on the SFU and ~12 f32 operations, ~40 more where
// the pair was used (the replay, ten gradient terms and their sums over
// the tile's pixels). Bytes: ten rows of each live chunk, fo, go and the
// state in, dparams out.
//
// The design:
// - One block per (tile, chunk), as lgm_tpu's v1 backward grid: the
//   training step's views are not balanced at tile grain (a whole-tile
//   schedule ends up to 1.8x after an even share, 1.15x at chunk grain).
//   A block starts from the state K3 stored at its chunk's first slot: T,
//   and prefix = sum_{c<4} go_c acc_c. It votes on that T, the forward's
//   own bits, so it stops where the forward stopped.
// - Each thread owns PPT pixels (4 at 32 x 32 tiles: 256 threads) and adds
//   their terms of a slot in registers; a chunk's slots are staged
//   slot-major (tiled_common.cuh's stage_slots), so a thread reads a slot
//   as three 16-byte loads for PPT pixels. One division a used pair,
//   __fdividef (its divisor is in [0.01, 1]). A pixel branches on its
//   alpha test: about a quarter of the bench view's pairs are used, and
//   the replay without the branch (K2ᵇ's form) measured 5-7% slower here
//   (NVIDIA H100 80GB HBM3, 700 W).
// - The sums over pixels are composite_reduce.cuh's: a transposing warp
//   butterfly over batches of 8 slots (~11 shuffles a slot), the warps'
//   sums for the chunk in shared memory, one barrier, a fixed-order sum
//   over the warps. Deterministic, no atomics.

#include "composite_reduce.cuh"
#include "tiled_common.cuh"

namespace {

using namespace tiled;
using namespace composite_reduce;

constexpr int kMaxPix = 1024;
constexpr float kOmMin = 0.01f;  // floor of 1 - alpha in the division

template <int PPT>
__global__ void __launch_bounds__(kMaxPix / PPT, PPT == 4 ? 2 : 1)
    tiled_bwd_kernel(const float* __restrict__ params,
                     const int* __restrict__ counts,
                     const float* __restrict__ pf,
                     const float* __restrict__ fo,
                     const float* __restrict__ go,
                     const float* __restrict__ state,
                     float* __restrict__ dparams, int K) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem;                       // [kChunk][kSlotStride]
  float* red = smem + kChunk * kSlotStride;  // [warp][kChunk][kVals]
  const int nc = K / kChunk;
  const int tile = blockIdx.x / nc;
  const int c0 = (blockIdx.x % nc) * kChunk;
  const int tid = threadIdx.x;
  const int P = blockDim.x * PPT;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int count = min(counts[tile], K);
  // A chunk past the tile's count, or past the forward's early-out (its
  // vote at this boundary, on the same bits of T), keeps its zeros.
  if (c0 >= count) return;
  const float* st = state + ((size_t)tile * nc + c0 / kChunk) * kStateRows * P;
  float T[PPT];
  bool open = false;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    T[p] = st[tid + p * blockDim.x];
    open |= T[p] > kTEps;
  }
  if (!__syncthreads_or(open)) return;

  // This thread's pixels: tid, tid + blockDim.x, ...
  float f[PPT][kFeat], pref[PPT], u_tail[PPT];
  float4 gc[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pix = tid + p * blockDim.x;
#pragma unroll
    for (int k = 0; k < kFeat; ++k) f[p][k] = pf[pix * 8 + k];
    const float4* fp = reinterpret_cast<const float4*>(fo + ((size_t)tile * P + pix) * 8);
    const float4* gp = reinterpret_cast<const float4*>(go + ((size_t)tile * P + pix) * 8);
    const float4 f0 = fp[0];
    gc[p] = gp[0];
    // U_total + gT T_final: the suffix the division takes, before prefix.
    u_tail[p] = gc[p].x * f0.x + gc[p].y * f0.y + gc[p].z * f0.z + gc[p].w * f0.w +
                gp[1].x * fp[1].x;
    pref[p] = gc[p].x * st[P + pix] + gc[p].y * st[2 * P + pix] +
              gc[p].z * st[3 * P + pix] + gc[p].w * st[4 * P + pix];
  }
  const int n = min(kChunk, count - c0);
  const float* blk = params + (size_t)tile * kRows * K;
  stage_slots(blk, K, c0, (n + kBatch - 1) / kBatch * kBatch, slots);
  __syncthreads();

  const float4* s4 = reinterpret_cast<const float4*>(slots);
  // This thread's terms of slot j, summed over its pixels.
  auto slot_terms = [&](int j, float (&v)[kVals]) {
    const float4 a = s4[j * 3], b = s4[j * 3 + 1], d = s4[j * 3 + 2];
    // a, b.xy: coefficients 0-5; b.z: opacity; b.w, d.xy: r, g, b
    const float c[kFeat] = {a.x, a.y, a.z, a.w, b.x, b.y};
#pragma unroll
    for (int k = 0; k < kVals; ++k) v[k] = 0.f;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const Pair q = pair_of(f[p], c, b.z);
      if (q.use) {
        const float s = gc[p].x * b.w + gc[p].y * d.x + gc[p].z * d.y + gc[p].w;
        const float w = q.alpha * T[p];
        pref[p] += s * w;
        const float dalpha =
            s * T[p] - __fdividef(u_tail[p] - pref[p], fmaxf(1.f - q.alpha, kOmMin));
        if (q.araw < kAlphaMax) {
          const float dpower = dalpha * q.alpha;
#pragma unroll
          for (int k = 0; k < kFeat; ++k) v[k] += f[p][k] * dpower;
          v[6] += dalpha * q.e;
        }
        v[7] += gc[p].x * w;
        v[8] += gc[p].y * w;
        v[9] += gc[p].z * w;
        T[p] = attenuate(T[p], q.alpha);
      }
    }
  };

  float* red_warp = red + warp * kChunk * kVals;
  for (int j0 = 0; j0 < n; j0 += kBatch) {
    float v[kVals];
    warp_batch(slot_terms, j0, lane, v);
    store_batch(red_warp, j0, lane, v);
  }
  __syncthreads();
  float* dblk = dparams + (size_t)tile * kRows * K + c0;
  for (int i = tid; i < kStaged * n; i += blockDim.x) {
    const int k = i / n, j = i % n;
    dblk[(size_t)(k < 7 ? k : k + 1) * K + j] =
        warps_sum(red, nwarps, kChunk * kVals, j * kVals + k);
  }
}

template <int PPT>
int launch(const float* params, const int* counts, const float* pf,
           const float* fo, const float* go, const float* state, float* dparams,
           int T, int K, int P, cudaStream_t stream) {
  const int threads = P / PPT;
  const size_t smem =
      (kChunk * kSlotStride + (threads / 32) * kChunk * kVals) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_bwd_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tiled_bwd_kernel<PPT><<<T * (K / kChunk), threads, smem, stream>>>(
      params, counts, pf, fo, go, state, dparams, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// params, dparams [T, 16, K] f32 (dparams zeroed by the caller); counts [T]
// i32; pf [P, 8] f32; fo, go [T, P, 8] f32; state [T, K / 128, 5, P] f32
// from tiled_fwd_f32; all contiguous on device ``device``. K a multiple of
// 128; P a multiple of 32, at most 1024 (4 pixels a thread where it is a
// multiple of 128, else 2 or 1). Launches on ``stream``; returns
// cudaGetLastError().
int tiled_bwd_f32(const void* params, const void* counts, const void* pf,
                  const void* fo, const void* go, const void* state,
                  void* dparams, int T, int K, int P, void* stream,
                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P > kMaxPix || P % 32 != 0 || K % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  auto* p = static_cast<const float*>(params);
  auto* c = static_cast<const int*>(counts);
  auto* x = static_cast<const float*>(pf);
  auto* f = static_cast<const float*>(fo);
  auto* g = static_cast<const float*>(go);
  auto* s = static_cast<const float*>(state);
  auto* d = static_cast<float*>(dparams);
  auto st = static_cast<cudaStream_t>(stream);
  if (P % 128 == 0) return launch<4>(p, c, x, f, g, s, d, T, K, P, st);
  if (P % 64 == 0) return launch<2>(p, c, x, f, g, s, d, T, K, P, st);
  return launch<1>(p, c, x, f, g, s, d, T, K, P, st);
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
