// Shared by composite_bwd.cu (K2ᵇ) and tiled_bwd.cu (K3ᵇ): the sum over a
// tile's pixels of each slot's gradient terms.
//
// Both backward kernels give every slot of a chunk ten gradient terms per
// pixel and need, per slot, their sums over the tile's pixels. The TPU
// kernels form those sums as matrix products. Here they are taken in three
// fixed-order stages, with no atomics, so two runs give the same bits:
//
// 1. In registers: each thread owns PPT pixels of the tile and adds its
//    pixels' terms for a slot before any exchange (reduce_slots' SlotFn).
// 2. Across the warp's 32 lanes, a batch of kBatch = 8 slots at a time by a
//    transposing butterfly: at each of three steps a lane keeps half of its
//    slots and receives its partner's share of that half (one shuffle per
//    value), so after the steps at lane offsets 16, 8 and 4 each lane holds
//    one slot of the batch summed over 8 lanes; two plain xor steps (2, 1)
//    finish the sum. That is 7 + 2 = 9 shuffles per value for 8 slots, ~11
//    per slot for the ten values, where one 5-step butterfly per value
//    costs 50; and every lane ends with finished sums, which the 4 lanes
//    holding one slot share out to write (store_batch).
// 3. Across the block's warps: each warp's sums go to shared memory
//    ([warp][slot][kVals]) and one thread per (slot, value) adds the warps'
//    in warp order (warps_sum), after one barrier per chunk.

#pragma once

#include <cuda_runtime.h>

namespace composite_reduce {

constexpr int kVals = 10;                 // gradient terms per slot
constexpr int kLevels = 3;                // transposing steps per batch
constexpr int kBatch = 1 << kLevels;      // slots per warp exchange (8)
constexpr int kDup = 32 >> kLevels;       // lanes that end with one slot (4)
constexpr unsigned kFull = 0xffffffffu;

// One transposing step at lane offset kOff: lanes whose kOff bit is clear
// keep the first batch half (a), the others the second (b); each adds the
// partner lane's share of the half it keeps. Own value first, then the
// partner's: a fixed order.
template <int kOff>
__device__ __forceinline__ void merge(float (&a)[kVals], const float (&b)[kVals],
                                      int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int k = 0; k < kVals; ++k) {
    const float keep = upper ? b[k] : a[k];
    const float send = upper ? a[k] : b[k];
    a[k] = keep + __shfl_xor_sync(kFull, send, kOff);
  }
}

// The 2^kLevel slots from j0 on, in order (the replay's order): slot_fn(j,
// v) writes this thread's terms of slot j, summed over its pixels, into v.
// Level L merges at lane offset 32 >> L, so lane bit 5 - L selects bit L - 1
// of the slot a lane keeps.
template <int kLevel, class SlotFn>
__device__ __forceinline__ void reduce_slots(SlotFn& slot_fn, int j0, int lane,
                                             float (&v)[kVals]) {
  if constexpr (kLevel == 0) {
    slot_fn(j0, v);
  } else {
    reduce_slots<kLevel - 1>(slot_fn, j0, lane, v);
    float w[kVals];
    reduce_slots<kLevel - 1>(slot_fn, j0 + (1 << (kLevel - 1)), lane, w);
    merge<(32 >> kLevel)>(v, w, lane);
  }
}

// The slot of the batch whose warp sums a lane holds after warp_batch.
__device__ __forceinline__ int batch_slot(int lane) {
  int j = 0;
#pragma unroll
  for (int L = 1; L <= kLevels; ++L) j |= ((lane >> (5 - L)) & 1) << (L - 1);
  return j;
}

// Slots j0 .. j0 + kBatch - 1 summed over the warp's lanes (and over each
// lane's pixels): every lane returns the kVals sums of slot j0 +
// batch_slot(lane).
template <class SlotFn>
__device__ __forceinline__ void warp_batch(SlotFn& slot_fn, int j0, int lane,
                                           float (&v)[kVals]) {
  reduce_slots<kLevels>(slot_fn, j0, lane, v);
#pragma unroll
  for (int off = kDup / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kVals; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
}

// Writes a warp's sums of the batch at j0 into red_warp [slot][kVals]: the
// kDup lanes holding one slot write every kDup-th value each.
__device__ __forceinline__ void store_batch(float* red_warp, int j0, int lane,
                                            const float (&v)[kVals]) {
  float* r = red_warp + (j0 + batch_slot(lane)) * kVals;
  const int sub = lane & (kDup - 1);
#pragma unroll
  for (int k = 0; k < kVals; ++k)
    if (k % kDup == sub) r[k] = v[k];
}

// Sum over the block's warps, in warp order, of value idx (slot * kVals +
// k) of red [warp][slots][kVals], each warp's part ``stride`` floats long.
__device__ __forceinline__ float warps_sum(const float* red, int nwarps,
                                           int stride, int idx) {
  float acc = 0.f;
  for (int w = 0; w < nwarps; ++w) acc += red[w * stride + idx];
  return acc;
}

}  // namespace composite_reduce
