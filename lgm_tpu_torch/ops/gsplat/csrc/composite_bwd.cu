// Kernel K2 backward (K2ᵇ): the VJP of the flatsort composite, one image
// tile per block.
//
// Replaces lgm_tpu/ops/gsplat/flatsort.py::_bwd_kernel / _bwd_tile (via
// _run_bwd, the VJP of _composite_flat). The function is the same: from
// the forward's inputs (slot rows, counts), its output fo [T, 8, P] and the
// cotangent go [T, 8, P], each pixel replays the composite front to back
// with the forward's chunking and its tile-wide early-out (a block vote at
// each 128-slot boundary, __syncthreads_or(T > 1e-4), exactly as
// composite_fwd.cu decides it), keeping the exclusive transmittance T_i and
// the running prefix of u_j = s_j w_j, where s_j = sum_c go_c col_c(j) over
// r, g, b, alpha (col 1) and depth. With
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
// C, op, r, g, b[, z]); fo, go [T, 8, P] (rows r, g, b, alpha, T, depth).
//
// What bounds it on an H100: like K2, the (pixel, slot) pairs the replay
// visits, each one exp on the SFU and ~45 f32 operations where it
// accumulates; plus, per slot, a sum over the tile's pixels of R values.
// Bytes are small (slot rows in, gradient rows out, fo/go once).
//
// The simple design: one thread per pixel (P <= 1024, a multiple of 32),
// one block per tile, one view per launch. Each 128-slot chunk is staged
// in shared memory as in K2. Per slot, each warp sums its 32 pixels' R
// terms with shuffles (skipped, and zeros written, when no pixel of the
// warp is touched); every 32 slots the warps' partial sums in shared
// memory ([32 warps][32 slots][10] f32, 40 KB) are added in a fixed order
// by R * 32 threads, so the result is deterministic, and written out.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;  // slots per chunk (G_CHUNK)
constexpr int kSub = 32;     // slots per cross-warp reduction round
constexpr int kRMax = 10;
constexpr int kWarpsMax = 32;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__global__ void composite_bwd_kernel(const float* __restrict__ params,
                                     const int* __restrict__ counts,
                                     const float* __restrict__ fo,
                                     const float* __restrict__ go,
                                     float* __restrict__ dparams, int mpt,
                                     int R, int tile_h, int tile_w,
                                     int tiles_x) {
  extern __shared__ float smem[];
  float* slots = smem;                        // kChunk * R
  float* red = smem + kChunk * kRMax;         // [warp][kSub][kRMax]
  const int tile = blockIdx.x;
  const int P = tile_h * tile_w;
  const int pix = threadIdx.x;
  const int warp = pix >> 5;
  const int lane = pix & 31;
  const int nwarps = P >> 5;
  const float lx = (float)(pix % tile_w);
  const float ly = (float)(pix / tile_w);
  const float tox = (float)((tile % tiles_x) * tile_w);
  const float toy = (float)((tile / tiles_x) * tile_h);
  const int count = counts[tile];
  const bool with_depth = R > 9;
  const float* blk = params + (size_t)tile * mpt * R;
  float* dblk = dparams + (size_t)tile * mpt * R;

  const float* f = fo + (size_t)tile * 8 * P + pix;
  const float* g = go + (size_t)tile * 8 * P + pix;
  const float g0 = g[0], g1 = g[P], g2 = g[2 * P], g3 = g[3 * P];
  const float g5 = g[5 * P];
  const float u_eff = g0 * f[0] + g1 * f[P] + g2 * f[2 * P] + g3 * f[3 * P] +
                      g5 * f[5 * P] + g[4 * P] * f[4 * P];

  float T = 1.f, pref = 0.f;
  int done = 0;  // slots whose gradient rows are written
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    // The forward's early-out vote; also the barrier before the staging
    // buffer is overwritten.
    if (!__syncthreads_or(T > kTEps)) break;
    const int n = min(kChunk, count - c0);
    for (int i = pix; i < n * R; i += blockDim.x) slots[i] = blk[(size_t)c0 * R + i];
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kSub) {
      const int m = min(kSub, n - j0);
      for (int jj = 0; jj < m; ++jj) {
        const float* s = slots + (j0 + jj) * R;
        const float dx = lx - (s[0] - tox);
        const float dy = ly - (s[1] - toy);
        const float power = -0.5f * (s[2] * dx * dx + s[4] * dy * dy) - s[3] * dx * dy;
        const float araw = s[5] * expf(power);
        const bool use = power <= 0.f && araw >= kAlphaMin;
        const float alpha = use ? fminf(araw, kAlphaMax) : 0.f;
        float v[kRMax];
        if (__any_sync(0xffffffffu, use)) {
          float sv = g0 * s[6] + g1 * s[7] + g2 * s[8] + g3;
          if (with_depth) sv += g5 * s[9];
          const float w = alpha * T;
          pref += sv * w;
          float dpower = 0.f;
          if (use) {
            const float dalpha =
                sv * T - (u_eff - pref) / fmaxf(1.f - alpha, 1.f - kAlphaMax);
            if (araw < kAlphaMax) dpower = dalpha * alpha;
          }
          v[0] = dpower * (s[2] * dx + s[3] * dy);
          v[1] = dpower * (s[4] * dy + s[3] * dx);
          v[2] = -0.5f * dpower * dx * dx;
          v[3] = -dpower * dx * dy;
          v[4] = -0.5f * dpower * dy * dy;
          v[5] = dpower;
          v[6] = g0 * w;
          v[7] = g1 * w;
          v[8] = g2 * w;
          v[9] = g5 * w;
#pragma unroll
          for (int k = 0; k < kRMax; ++k) v[k] = warp_sum(v[k]);
          T *= 1.f - alpha;
        } else {
#pragma unroll
          for (int k = 0; k < kRMax; ++k) v[k] = 0.f;
        }
        if (lane == 0) {
          float* r = red + (warp * kSub + jj) * kRMax;
#pragma unroll
          for (int k = 0; k < kRMax; ++k) r[k] = v[k];
        }
      }
      __syncthreads();
      for (int i = pix; i < m * R; i += blockDim.x) {
        const int jj = i / R, k = i % R;
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += red[(w * kSub + jj) * kRMax + k];
        if (k == 5) acc /= fmaxf(slots[(j0 + jj) * R + 5], 1e-12f);
        dblk[(size_t)(c0 + j0 + jj) * R + k] = acc;
      }
      __syncthreads();  // red is rewritten by the next round
    }
    done = c0 + n;
  }
  for (int i = done * R + pix; i < mpt * R; i += blockDim.x) dblk[i] = 0.f;
}

}  // namespace

extern "C" {

// params, dparams [T, mpt, R] f32; counts [T] i32; fo, go [T, 8, tile_h *
// tile_w] f32; all contiguous on device ``device``. R in {9, 10}; tile_h *
// tile_w a multiple of 32, at most 1024. Launches on ``stream``; returns
// cudaGetLastError().
int composite_bwd_f32(const void* params, const void* counts, const void* fo,
                      const void* go, void* dparams, int T, int mpt, int R,
                      int tile_h, int tile_w, int tiles_x, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int P = tile_h * tile_w;
  if (P > kWarpsMax * 32 || P % 32 != 0 || (R != 9 && R != 10))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (kChunk * kRMax + kWarpsMax * kSub * kRMax) * sizeof(float);
  composite_bwd_kernel<<<T, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(counts),
      static_cast<const float*>(fo), static_cast<const float*>(go),
      static_cast<float*>(dparams), mpt, R, tile_h, tile_w, tiles_x);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
