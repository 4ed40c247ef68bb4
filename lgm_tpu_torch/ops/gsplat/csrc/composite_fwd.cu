// Kernel K2: flatsort composite forward, one image tile per block.
//
// Replaces lgm_tpu/ops/gsplat/flatsort.py::_fwd_kernel (via _run_fwd /
// _composite_flat), the TPU's per-tile Pallas compositor. The function is
// the same: per tile, front-to-back alpha compositing of up to MPT
// depth-ordered slots, 128 slots per chunk, with
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy   (tile-local dx, dy)
//   alpha = min(op * exp(power), 0.99), kept only where power <= 0 and
//           op * exp(power) >= 1/255,
// exclusive transmittance, and the TPU's tile-wide early-out: before each
// chunk the tile stops if no pixel's transmittance is above 1e-4, and it
// stops at counts[t]. The early-out is a block-wide vote
// (__syncthreads_or), not a per-pixel exit: a per-pixel exit would be a
// different function, by up to 1e-4 per pixel.
//
// Slot layout (the port's choice): params [T, MPT, R] f32, slot-major, the
// slot-gather output itself, so a chunk's 128 x R floats are contiguous and
// stage with coalesced loads. Rows of a slot: x̄, ȳ (global px), A, B, C
// (conic), op, r, g, b[, z]. Dead slots are zero rows (op = 0: no
// contribution). Output [T, 8, P] f32: rows r, g, b, sum w, T_final,
// depth (sum w z), 0, 0.
//
// What bounds it on an H100: the work depends on the data. Each live
// (pixel, slot) pair the chunk loop visits costs one exp on the SFU (16
// per clock per SM) and ~25 f32 operations (67 TFLOP/s outside the tensor
// cores); bytes are small (each slot row is read once per tile and is
// L2-resident). The SFU exp rate is the bound.
//
// The simple design: one thread per pixel (tile_h * tile_w <= 1024), one
// block per tile, one view per launch (grid = tiles, as lax.map runs one
// view per step). Each chunk's live slots are staged cooperatively into
// shared memory (128 x R floats = 5 KB at R = 10); every thread then walks
// them in order, reading each slot as a broadcast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;           // slots per chunk (G_CHUNK)
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void composite_fwd_kernel(const float* __restrict__ params,
                                     const int* __restrict__ counts,
                                     float* __restrict__ out, int mpt, int R,
                                     int tile_h, int tile_w, int tiles_x) {
  extern __shared__ float slots[];  // kChunk * R
  const int tile = blockIdx.x;
  const int P = tile_h * tile_w;
  const int pix = threadIdx.x;
  const float lx = (float)(pix % tile_w);
  const float ly = (float)(pix / tile_w);
  const float tox = (float)((tile % tiles_x) * tile_w);
  const float toy = (float)((tile / tiles_x) * tile_h);
  const int count = counts[tile];
  const float* blk = params + (size_t)tile * mpt * R;
  const bool with_depth = R > 9;

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, ca = 0.f, cd = 0.f;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    // Block-wide vote; also the barrier before the staging buffer is
    // overwritten.
    if (!__syncthreads_or(T > kTEps)) break;
    const int n = min(kChunk, count - c0);
    for (int i = pix; i < n * R; i += blockDim.x) slots[i] = blk[(size_t)c0 * R + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* s = slots + j * R;
      const float dx = lx - (s[0] - tox);
      const float dy = ly - (s[1] - toy);
      const float power = -0.5f * (s[2] * dx * dx + s[4] * dy * dy) - s[3] * dx * dy;
      const float araw = s[5] * expf(power);
      if (power <= 0.f && araw >= kAlphaMin) {
        const float alpha = fminf(araw, kAlphaMax);
        const float w = alpha * T;
        cr += w * s[6];
        cg += w * s[7];
        cb += w * s[8];
        ca += w;
        if (with_depth) cd += w * s[9];
        T *= 1.f - alpha;
      }
    }
  }
  float* o = out + (size_t)tile * 8 * P + pix;
  o[0 * P] = cr;
  o[1 * P] = cg;
  o[2 * P] = cb;
  o[3 * P] = ca;
  o[4 * P] = T;
  o[5 * P] = cd;
  o[6 * P] = 0.f;
  o[7 * P] = 0.f;
}

}  // namespace

extern "C" {

// params [T, mpt, R] f32, counts [T] i32, out [T, 8, tile_h * tile_w] f32,
// all contiguous on device ``device``; R in {9, 10}; tile_h * tile_w <= 1024.
// Launches on ``stream``; returns cudaGetLastError().
int composite_fwd_f32(const void* params, const void* counts, void* out, int T,
                      int mpt, int R, int tile_h, int tile_w, int tiles_x,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int P = tile_h * tile_w;
  if (P > 1024 || (R != 9 && R != 10)) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<<<T, P, kChunk * R * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(counts),
      static_cast<float*>(out), mpt, R, tile_h, tile_w, tiles_x);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
