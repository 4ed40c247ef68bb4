// Shared by tiled_fwd.cu (K3) and tiled_bwd.cu (K3ᵇ): the constants, the
// staging of one 128-slot chunk slot-major (with plain loads for K3ᵇ, with
// cp.async for K3), and the alpha of one (pixel, slot) pair.
//
// K3ᵇ replays K3, so both must take the same decisions (alpha test, 0.99
// clamp, the tile's early-out vote) from the same bits. The power is
// therefore one fixed sequence of f32 roundings, written with intrinsics
// that the compiler may not contract into fused multiply-adds:
//   ((((f0 c0 + f1 c1) + f2 c2) + f3 c3) + f4 c4) + f5 c5
// with every product and every sum rounded on its own. The plain PyTorch
// versions (ops/gsplat/tiled.py::_chunk_alpha) take the same sequence. The
// expanded quadratic cancels large terms and the function jumps where
// power crosses 0 and where op e^power crosses 1/255, so a different
// rounding would land isolated pixels on the other side of a jump.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tile_cluster.cuh"

namespace tiled {

constexpr int kChunk = 128;  // slots per chunk (G_CHUNK)
constexpr int kRows = 16;    // rows of params_tiles [T, 16, K]
constexpr int kStaged = 10;  // rows read: 0-5 coefficients, 6 opacity, 8-10 rgb
constexpr int kFeat = 6;     // pixel features read: x², y², xy, x, y, 1
constexpr int kSlotStride = 12;  // floats per slot staged slot-major
constexpr int kStateRows = 5;    // chunk-boundary state: T, r, g, b, sum w
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Copies rows 0-6 and 8-10 of slots c0 .. c0 + n - 1 of one tile's [16, K]
// block into slots[n][kSlotStride], slot-major (row 8 lands at 7, and so
// on; 10 and 11 are zero), so that a thread reads a slot as three 16-byte
// loads. Coalesced along the slots; the caller synchronizes.
__device__ __forceinline__ void stage_slots(const float* __restrict__ blk,
                                            int K, int c0, int n, float* slots) {
  for (int i = threadIdx.x; i < kSlotStride * n; i += blockDim.x) {
    const int r = i / n, j = i % n;
    slots[j * kSlotStride + r] =
        r < kStaged ? blk[(size_t)(r < 7 ? r : r + 1) * K + c0 + j] : 0.f;
  }
}

// stage_slots by cp.async, 4 bytes a value, for rows 0-6 and 8-10 only
// (floats 10 and 11 of a slot are left as they are). The caller commits,
// waits and synchronizes.
__device__ __forceinline__ void stage_slots_async(const float* __restrict__ blk,
                                                  int K, int c0, int n,
                                                  float* slots) {
  for (int i = threadIdx.x; i < kStaged * n; i += blockDim.x) {
    const int r = i / n, j = i % n;
    tile_cluster::cp_async4(slots + j * kSlotStride + r,
                            blk + (size_t)(r < 7 ? r : r + 1) * K + c0 + j);
  }
}

struct Pair {
  float alpha;  // min(op e^power, 0.99) where used, else 0
  float araw;   // op e^power
  float e;      // e^power
  bool use;     // power <= 0 and op e^power >= 1/255
};

// The alpha of a slot with coefficients c[0..5] and opacity op at the pixel
// whose features are f[0..5]. Slots past the tile's count are zero rows:
// power 0, op 0, not used.
__device__ __forceinline__ Pair pair_of(const float (&f)[kFeat],
                                        const float (&c)[kFeat], float op) {
  float power = __fmul_rn(f[0], c[0]);
#pragma unroll
  for (int k = 1; k < kFeat; ++k) power = __fadd_rn(power, __fmul_rn(f[k], c[k]));
  Pair p;
  p.e = expf(power);
  p.araw = __fmul_rn(op, p.e);
  p.use = power <= 0.f && p.araw >= kAlphaMin;
  p.alpha = p.use ? fminf(p.araw, kAlphaMax) : 0.f;
  return p;
}

// pair_of's two halves, for K3, which tests the power against a slot's
// cull bound before the exp: the same operations in the same order, so the
// same bits. (pair_of is not written as their composition: that compiled
// K3ᵇ's chunk loop 38 instructions longer, and 2-4% slower.)
__device__ __forceinline__ float power_of(const float (&f)[kFeat],
                                          const float (&c)[kFeat]) {
  float power = __fmul_rn(f[0], c[0]);
#pragma unroll
  for (int k = 1; k < kFeat; ++k) power = __fadd_rn(power, __fmul_rn(f[k], c[k]));
  return power;
}

__device__ __forceinline__ Pair alpha_of(float power, float op) {
  Pair p;
  p.e = expf(power);
  p.araw = __fmul_rn(op, p.e);
  p.use = power <= 0.f && p.araw >= kAlphaMin;
  p.alpha = p.use ? fminf(p.araw, kAlphaMax) : 0.f;
  return p;
}

// The power below which a slot of opacity op cannot pass the alpha test
// (op e^power >= 1/255): a pair with power < cull_bound(op) has alpha 0 and
// leaves the pixel as it is, so a warp whose every pixel is below it may
// skip the slot with the same bits (K3). The 1e-3 margin covers the
// roundings of logf, expf and the product by far. Dead slots (op = 0)
// give +inf (always below); op < 0 or NaN give NaN (never below).
__device__ __forceinline__ float cull_bound(float op) {
  return logf(kAlphaMin / op) - 1e-3f;
}

// The transmittance behind a used pair.
__device__ __forceinline__ float attenuate(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

}  // namespace tiled
