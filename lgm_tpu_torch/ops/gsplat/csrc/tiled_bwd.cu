// Kernel K3 backward (K3ᵇ): the VJP of the v1 tiled composite, one image
// tile per block.
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
// of every chunk it replays (all 128 slots; zero rows past counts[t] get
// zero gradients).
//
// What bounds it on an H100: like K3, the (pixel, slot) pairs of the live
// chunks, each one exp on the SFU and ~12 f32 operations, ~40 more where
// the pair was used (the replay, ten gradient terms and their sums over
// the tile's pixels). Bytes: ten rows of each live chunk and fo, go in,
// dparams out.
//
// The simple design, K2ᵇ's: one thread per pixel (P <= 1024, a multiple
// of 32), one block per tile, one view per launch. Per slot, each warp sums
// its 32 pixels' ten terms with shuffles (skipped, and zeros taken, when no
// pixel of the warp used the slot); every 32 slots the warps' partial sums
// in shared memory ([32 warps][32 slots][10] f32, 40 KB) are added in a
// fixed order, so the result is deterministic, and written out coalesced
// along the slot axis.

#include "tiled_common.cuh"

namespace {

using namespace tiled;

constexpr int kSub = 32;       // slots per cross-warp reduction round
constexpr int kWarpsMax = 32;
constexpr float kOmMin = 0.01f;  // floor of 1 - alpha in the divisions

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__global__ void tiled_bwd_kernel(const float* __restrict__ params,
                                 const int* __restrict__ counts,
                                 const float* __restrict__ pf,
                                 const float* __restrict__ fo,
                                 const float* __restrict__ go,
                                 float* __restrict__ dparams, int K) {
  extern __shared__ float smem[];
  float* rows = smem;                       // [kStaged][kChunk]
  float* red = smem + kStaged * kChunk;     // [warp][kSub][kStaged]
  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int P = blockDim.x;
  const int warp = pix >> 5;
  const int lane = pix & 31;
  const int nwarps = P >> 5;
  float f[kFeat];
#pragma unroll
  for (int k = 0; k < kFeat; ++k) f[k] = pf[pix * 8 + k];
  const int count = min(counts[tile], K);
  const float* blk = params + (size_t)tile * kRows * K;
  float* dblk = dparams + (size_t)tile * kRows * K;

  const float4* fp = reinterpret_cast<const float4*>(fo + ((size_t)tile * P + pix) * 8);
  const float4* gp = reinterpret_cast<const float4*>(go + ((size_t)tile * P + pix) * 8);
  const float4 f0 = fp[0], g0 = gp[0];
  const float u_total = g0.x * f0.x + g0.y * f0.y + g0.z * f0.z + g0.w * f0.w;
  const float tail = gp[1].x * fp[1].x;  // gT T_final

  float T = 1.f, pref = 0.f;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    // The forward's vote; also the barrier before the staging buffer is
    // overwritten.
    if (!__syncthreads_or(T > kTEps)) break;
    stage_chunk(blk, K, c0, rows);
    __syncthreads();
    for (int j0 = 0; j0 < kChunk; j0 += kSub) {
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        const Pair a = pair_alpha(f, rows, j);
        float v[kStaged];
        if (__any_sync(0xffffffffu, a.use)) {
          float w = 0.f, dpower = 0.f, dop = 0.f;
          if (a.use) {
            const float s = g0.x * rows[7 * kChunk + j] + g0.y * rows[8 * kChunk + j] +
                            g0.z * rows[9 * kChunk + j] + g0.w;
            w = a.alpha * T;
            pref += s * w;
            const float om = fmaxf(1.f - a.alpha, kOmMin);
            const float dalpha = s * T - (u_total - pref) / om - tail / om;
            if (a.araw < kAlphaMax) {
              dpower = dalpha * a.alpha;
              dop = dalpha * a.e;
            }
            T = attenuate(T, a.alpha);
          }
#pragma unroll
          for (int k = 0; k < kFeat; ++k) v[k] = f[k] * dpower;
          v[6] = dop;
          v[7] = g0.x * w;
          v[8] = g0.y * w;
          v[9] = g0.z * w;
#pragma unroll
          for (int k = 0; k < kStaged; ++k) v[k] = warp_sum(v[k]);
        } else {
#pragma unroll
          for (int k = 0; k < kStaged; ++k) v[k] = 0.f;
        }
        if (lane == 0) {
          float* r = red + (warp * kSub + jj) * kStaged;
#pragma unroll
          for (int k = 0; k < kStaged; ++k) r[k] = v[k];
        }
      }
      __syncthreads();
      for (int i = pix; i < kSub * kStaged; i += P) {
        const int k = i / kSub, jj = i % kSub;
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += red[(w * kSub + jj) * kStaged + k];
        dblk[(size_t)(k < 7 ? k : k + 1) * K + c0 + j0 + jj] = acc;
      }
      __syncthreads();  // red is rewritten by the next round
    }
  }
}

}  // namespace

extern "C" {

// params, dparams [T, 16, K] f32 (dparams zeroed by the caller); counts [T]
// i32; pf [P, 8] f32; fo, go [T, P, 8] f32; all contiguous on device
// ``device``. K a multiple of 128; P a multiple of 32, at most 1024.
// Launches on ``stream``; returns cudaGetLastError().
int tiled_bwd_f32(const void* params, const void* counts, const void* pf,
                  const void* fo, const void* go, void* dparams, int T, int K,
                  int P, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P > kWarpsMax * 32 || P % 32 != 0 || K % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (kStaged * kChunk + kWarpsMax * kSub * kStaged) * sizeof(float);
  tiled_bwd_kernel<<<T, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(counts),
      static_cast<const float*>(pf), static_cast<const float*>(fo),
      static_cast<const float*>(go), static_cast<float*>(dparams), K);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
