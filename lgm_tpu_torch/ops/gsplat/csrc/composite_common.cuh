// Shared by composite_fwd.cu (K2) and composite_bwd.cu (K2ᵇ): the
// constants, the staged form of a slot, and the alpha of one (pixel, slot)
// pair.
//
// K2ᵇ replays K2's compositing from the state K2 stores, so both must take
// the same decisions (alpha test, 0.99 clamp, the tile's early-out vote)
// from the same bits. The power is therefore one fixed sequence of f32
// roundings, written with intrinsics that the compiler may not contract
// into fused multiply-adds:
//   ((nA dx) dx + (nC dy) dy) + (nB dx) dy,   nA = -A/2, nB = -B, nC = -C/2
// with every product and sum rounded on its own. Halving and negating are
// exact in f32, so this is the number the plain PyTorch versions take op
// by op as -0.5 (A dx dx + C dy dy) - B dx dy (ops/gsplat/flatsort.py::
// _slot_power). The function jumps where power crosses 0 and where
// op e^power crosses 1/255, so a different rounding would land isolated
// pixels on the other side of a jump.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace composite {

constexpr int kChunk = 128;      // slots per chunk (G_CHUNK)
constexpr int kMaxRows = 10;     // R: x̄, ȳ, A, B, C, op, r, g, b[, z]
constexpr int kSlotStride = 12;  // floats per staged slot (three float4)
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Stages the slot row ``row`` (R values) of a tile whose origin is (tox,
// toy) as three float4, read by a thread as three 16-byte broadcasts:
//   (cx, cy, nA, nB), (nC, op, r, g), (b, z, 0, 0)
// with (cx, cy) = (x̄ - tox, ȳ - toy) the tile-local centre and z = 0
// where R = 9.
__device__ __forceinline__ void stage_slot(const float* row, int R, float tox,
                                           float toy, float4* dst) {
  dst[0] = make_float4(row[0] - tox, row[1] - toy, -0.5f * row[2], -row[3]);
  dst[1] = make_float4(-0.5f * row[4], row[5], row[6], row[7]);
  dst[2] = make_float4(row[8], R > 9 ? row[9] : 0.f, 0.f, 0.f);
}

struct Pair {
  float alpha;  // min(op e^power, 0.99) where used, else 0
  float araw;   // op e^power
};

// The alpha of a staged slot (conic nA, nB, nC; opacity op) at the pixel
// (dx, dy) = (pixel - centre) from it, tile-local. Used where power <= 0
// and op e^power >= 1/255.
__device__ __forceinline__ Pair pair_of(float dx, float dy, float nA, float nB,
                                        float nC, float op) {
  const float power =
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(nA, dx), dx),
                          __fmul_rn(__fmul_rn(nC, dy), dy)),
                __fmul_rn(__fmul_rn(nB, dx), dy));
  Pair p;
  p.araw = __fmul_rn(op, expf(power));
  p.alpha = power <= 0.f && p.araw >= kAlphaMin ? fminf(p.araw, kAlphaMax) : 0.f;
  return p;
}

// The transmittance behind a pair (unchanged where alpha = 0).
__device__ __forceinline__ float attenuate(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

}  // namespace composite
