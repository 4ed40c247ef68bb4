// Kernel K3: the v1 tiled rasterizer's composite forward, one image tile per
// block.
//
// Replaces lgm_tpu/ops/gsplat/tiled.py::_fwd_kernel (via _run_fwd /
// tile_composite), the TPU's per-tile Pallas compositor of the
// "pallas_v1" backend. The function is the same: per tile, front-to-back
// alpha compositing of K depth-ordered slots in chunks of 128, from the
// packed coefficient matrix params_tiles [T, 16, K] and the tile-local
// pixel features pf [P, 8]:
//   power = sum_{k<6} pf[p, k] * row_k       (the expanded quadratic)
//   alpha = min(row_6 * exp(power), 0.99), kept only where power <= 0 and
//           row_6 * exp(power) >= 1/255,
// exclusive transmittance, sums of alpha T rgb (rows 8-10) and of alpha T.
// A chunk is composited when it starts inside counts[t] and some pixel of
// the tile still has transmittance above 1e-4. That is decided at the chunk
// boundary for the whole tile, by a block-wide vote (__syncthreads_or):
// inside a live chunk every slot is composited for every pixel, whatever
// that pixel's own transmittance, and slots past counts[t] are zero rows
// (alpha = 0), not skipped by index. A per-pixel exit would be another
// function, and K3ᵇ could not replay it. Rows 7 and 11-15 and features 6-7
// are the layout's constants (0, 1, 0, ...) and are not read.
// Output [T, P, 8] f32: columns r, g, b, sum w, T_final, 0, 0, 0.
//
// When asked (state != nullptr), it also writes the pixel state at every
// 128-slot chunk boundary, [T, K / 128, 5, P] f32: before chunk c, each
// pixel's T and its sums r, g, b, sum w, as the chunk loop holds them
// there; boundaries past the tile's last composited chunk get its final
// values. K3ᵇ (tiled_bwd.cu) starts each (tile, chunk) block from them.
//
// The TPU kernel forms power as a matrix product and the transmittance as a
// 7-step shift network over its 128 lanes, having no cheap sequential
// loop. Here each thread owns one pixel and walks the chunk in order with
// its own T, reading each slot's ten values from shared memory as
// broadcasts.
//
// What bounds it on an H100: the work depends on the data. Each (pixel,
// slot) pair of a live chunk costs one exp on the SFU (16 per clock per SM)
// and ~12 f32 operations, ~11 more where it accumulates; bytes are small
// (ten rows of each live chunk in, [T, P, 8] out). Operations bound it.
//
// The simple design: one thread per pixel (P <= 1024, a multiple of 32),
// one block per tile, one view per launch; a chunk's 10 x 128 floats (5 KB)
// are staged cooperatively with coalesced loads.

#include "tiled_common.cuh"

namespace {

using namespace tiled;

__global__ void tiled_fwd_kernel(const float* __restrict__ params,
                                 const int* __restrict__ counts,
                                 const float* __restrict__ pf,
                                 float* __restrict__ out,
                                 float* __restrict__ state, int K) {
  __shared__ float rows[kStaged * kChunk];
  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int P = blockDim.x;
  float f[kFeat];
#pragma unroll
  for (int k = 0; k < kFeat; ++k) f[k] = pf[pix * 8 + k];
  const int count = min(counts[tile], K);
  const float* blk = params + (size_t)tile * kRows * K;

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, ca = 0.f;
  const int nc = K / kChunk;
  float* st = state ? state + (size_t)tile * nc * kStateRows * P + pix : nullptr;
  int c = 0;  // boundaries written
  auto keep_state = [&]() {
    float* s = st + (size_t)c++ * kStateRows * P;
    s[0 * P] = T;
    s[1 * P] = cr;
    s[2 * P] = cg;
    s[3 * P] = cb;
    s[4 * P] = ca;
  };
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    if (st) keep_state();
    // The tile's vote; also the barrier before the staging buffer is
    // overwritten.
    if (!__syncthreads_or(T > kTEps)) break;
    stage_chunk(blk, K, c0, rows);
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      const Pair a = pair_alpha(f, rows, j);
      if (a.use) {
        const float w = a.alpha * T;
        cr += w * rows[7 * kChunk + j];
        cg += w * rows[8 * kChunk + j];
        cb += w * rows[9 * kChunk + j];
        ca += w;
        T = attenuate(T, a.alpha);
      }
    }
  }
  if (st)
    while (c < nc) keep_state();
  float4* o = reinterpret_cast<float4*>(out + ((size_t)tile * P + pix) * 8);
  o[0] = make_float4(cr, cg, cb, ca);
  o[1] = make_float4(T, 0.f, 0.f, 0.f);
}

}  // namespace

extern "C" {

// params [T, 16, K] f32, counts [T] i32, pf [P, 8] f32, out [T, P, 8] f32,
// state null or [T, K / 128, 5, P] f32, all contiguous on device
// ``device``; K a multiple of 128; P a multiple of 32, at most 1024.
// Launches on ``stream``; returns cudaGetLastError().
int tiled_fwd_f32(const void* params, const void* counts, const void* pf,
                  void* out, void* state, int T, int K, int P, void* stream,
                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P > 1024 || P % 32 != 0 || K % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  tiled_fwd_kernel<<<T, P, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(counts),
      static_cast<const float*>(pf), static_cast<float*>(out),
      static_cast<float*>(state), K);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
