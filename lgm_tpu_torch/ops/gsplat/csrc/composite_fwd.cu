// Kernel K2: flatsort composite forward, one image tile per thread-block
// cluster.
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
// stops at counts[t]. The early-out is a vote over all the tile's pixels,
// not a per-pixel exit: a per-pixel exit would be a different function,
// by up to 1e-4 per pixel.
//
// Slot layout (the port's choice): params [T, MPT, R] f32, slot-major, the
// slot-gather output itself, so a chunk's 128 x R floats are contiguous.
// Rows of a slot: x̄, ȳ (global px), A, B, C (conic), op, r, g, b[, z].
// Dead slots are zero rows (op = 0: no contribution). Output [T, 8, P]
// f32: rows r, g, b, sum w, T_final, depth (sum w z), 0, 0.
//
// When asked (state != nullptr), it also writes the pixel state at every
// 128-slot chunk boundary, [T, MPT / 128, 6, P] f32: before chunk c, each
// pixel's T and its accumulators r, g, b, sum w, depth, as the chunk loop
// holds them there; boundaries past the tile's last composited chunk get
// its final values. K2ᵇ (composite_bwd.cu) starts each (tile, chunk) block
// from them: the T it votes on is the one the forward voted on, bit for bit.
//
// When asked (work != nullptr: a profiled run), it also counts its own
// work, which the data decides: the cluster's first block adds, once at
// its end, the tile's visited slots times P to work[0] (the (pixel, slot)
// pairs the chunk loop visits) and times R * 4 to work[1] (the slot rows'
// bytes). The chunk loop itself is the same with and without.
//
// What bounds it on an H100: the work depends on the data. Each (pixel,
// slot) pair the chunk loop visits costs one exp on the SFU (16 per clock
// per SM) and ~25 f32 operations (67 TFLOP/s outside the tensor cores);
// bytes are small (each slot row is read once per tile block and is
// L2-resident). In practice the issue rate bounds it: ~30 instructions a
// pair, and the tiles are unequal (on the bench view a tile visits 280
// slots on average and up to 1,024).
//
// The design:
// - One tile over a cluster of CS blocks (tile_cluster.cuh): each block
//   owns P / CS of the tile's pixels, so the heaviest tile's pairs spread
//   over CS SMs. The early-out vote stays tile-wide: each block's
//   __syncthreads_or, ORed over the cluster through distributed shared
//   memory at each boundary.
// - PPT pixels a thread, the pixels tid + p * blockDim.x of the block's
//   share: each slot read from shared memory serves PPT pixels.
// - Slots staged slot-major and pre-digested (composite_common.cuh): the
//   tile-local centre, the conic pre-scaled for the power, op, rgb, z; a
//   thread reads a slot as three 16-byte broadcasts. Per pair what is left
//   is the quadratic, one exp, the test and the accumulation (~31
//   instructions in the SASS), no branch (an unused pair adds exact
//   zeros). K3's warp cull (tiled_fwd.cu) does not pay here: the binning
//   keeps only slots whose ellipse meets the tile, and about half of the
//   bench view's visited pairs are used, so few warps could skip a slot;
//   with it K2 measured 6-10% slower (NVIDIA H100 80GB HBM3, 700 W).
// - The next chunk's raw rows are copied with cp.async into the other half
//   of a double buffer while the current chunk composites; at the boundary
//   they are digested into the staged slots.
// - The alpha (pair_of) and the transmittance update (attenuate) are
//   composite_common.cuh's, shared with K2ᵇ; the sums are pinned
//   (__fmaf_rn, __fadd_rn), so every (CS, PPT) gives the same bits.

#include "composite_common.cuh"
#include "tile_cluster.cuh"

namespace {

using namespace composite;
using tile_cluster::TileVote;

constexpr int kMaxPix = 1024;

template <int CS, int PPT>
__global__ void __launch_bounds__(kMaxPix / (CS * PPT))
    composite_fwd_kernel(const float* __restrict__ params,
                         const int* __restrict__ counts,
                         float* __restrict__ out, float* __restrict__ state,
                         unsigned long long* __restrict__ work, int mpt, int R,
                         int tile_h, int tile_w, int tiles_x) {
  __shared__ __align__(16) float raw[2][kChunk * kMaxRows];
  __shared__ float4 slots[kChunk * 3];
  __shared__ int flags[2];
  const TileVote<CS> vote{flags};
  const int tile = tile_cluster::tile_index<CS>();
  const int P = tile_h * tile_w;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int base = tile_cluster::block_rank<CS>() * (P / CS);
  const float tox = (float)((tile % tiles_x) * tile_w);
  const float toy = (float)((tile / tiles_x) * tile_h);
  const int count = min(counts[tile], mpt);
  const float* blk = params + (size_t)tile * mpt * R;

  float lx[PPT], ly[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT], ca[PPT], cd[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pix = base + tid + p * nthr;
    lx[p] = (float)(pix % tile_w);
    ly[p] = (float)(pix / tile_w);
    T[p] = 1.f;
    cr[p] = cg[p] = cb[p] = ca[p] = cd[p] = 0.f;
  }
  const int nc = mpt / kChunk;
  float* st = state ? state + (size_t)tile * nc * 6 * P + base + tid : nullptr;
  int written = 0;  // boundaries of the state written
  int visited = 0;  // slots composited
  auto keep_state = [&]() {
    float* s = st + (size_t)written++ * 6 * P;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int o = p * nthr;
      s[0 * P + o] = T[p];
      s[1 * P + o] = cr[p];
      s[2 * P + o] = cg[p];
      s[3 * P + o] = cb[p];
      s[4 * P + o] = ca[p];
      s[5 * P + o] = cd[p];
    }
  };
  // A chunk's raw rows, 128 R floats (16-byte aligned: the wrapper checks
  // params, and 128 R floats are whole 16-byte units), into raw[buf].
  auto fetch = [&](int c0, int buf) {
    const float4* src = reinterpret_cast<const float4*>(blk + (size_t)c0 * R);
    float4* dst = reinterpret_cast<float4*>(raw[buf]);
    for (int i = tid; i < kChunk * R / 4; i += nthr)
      tile_cluster::cp_async16(dst + i, src + i);
    tile_cluster::cp_async_commit();
  };

  if (count > 0) fetch(0, 0);
  for (int c = 0, c0 = 0; c0 < count; ++c, c0 += kChunk) {
    if (st) keep_state();
    bool open = false;
#pragma unroll
    for (int p = 0; p < PPT; ++p) open |= T[p] > kTEps;
    // The block's vote; also the barrier before the staged slots and the
    // other raw buffer are overwritten.
    const int mine = __syncthreads_or(open);
    vote.publish(c, mine);
    if (c0 + kChunk < count) {
      fetch(c0 + kChunk, (c + 1) & 1);
      tile_cluster::cp_async_wait<1>();
    } else {
      tile_cluster::cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's raw rows, from every thread's copies
    const int n = min(kChunk, count - c0);
    for (int j = tid; j < n; j += nthr)
      stage_slot(raw[c & 1] + j * R, R, tox, toy, slots + 3 * j);
    if (!vote.combine(c, mine)) break;
    visited += n;
    __syncthreads();  // the staged slots
    // Four slots an iteration: ~5% faster than the compiler's own unroll
    // (NVIDIA H100 80GB HBM3, 700 W).
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 a = slots[3 * j], b = slots[3 * j + 1], d = slots[3 * j + 2];
      // a = (cx, cy, nA, nB), b = (nC, op, r, g), d = (b, z, 0, 0)
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const Pair q = pair_of(lx[p] - a.x, ly[p] - a.y, a.z, a.w, b.x, b.y);
        const float w = __fmul_rn(q.alpha, T[p]);
        cr[p] = __fmaf_rn(w, b.z, cr[p]);
        cg[p] = __fmaf_rn(w, b.w, cg[p]);
        cb[p] = __fmaf_rn(w, d.x, cb[p]);
        ca[p] = __fadd_rn(ca[p], w);
        cd[p] = __fmaf_rn(w, d.y, cd[p]);
        T[p] = attenuate(T[p], q.alpha);
      }
    }
  }
  tile_cluster::cp_async_wait<0>();
  vote.finish();
  if (st)
    while (written < nc) keep_state();
  if (work && tid == 0 && tile_cluster::block_rank<CS>() == 0) {
    atomicAdd(work, (unsigned long long)visited * P);
    atomicAdd(work + 1, (unsigned long long)visited * R * 4);
  }
  float* o = out + (size_t)tile * 8 * P + base + tid;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = p * nthr;
    o[0 * P + i] = cr[p];
    o[1 * P + i] = cg[p];
    o[2 * P + i] = cb[p];
    o[3 * P + i] = ca[p];
    o[4 * P + i] = T[p];
    o[5 * P + i] = cd[p];
    o[6 * P + i] = 0.f;
    o[7 * P + i] = 0.f;
  }
}

template <int CS, int PPT>
int launch(const float* params, const int* counts, float* out, float* state,
           unsigned long long* work, int T, int mpt, int R, int tile_h,
           int tile_w, int tiles_x, cudaStream_t stream) {
  return tile_cluster::launch_tiles<CS>(
      composite_fwd_kernel<CS, PPT>, T, tile_h * tile_w / (CS * PPT), stream,
      params, counts, out, state, work, mpt, R, tile_h, tile_w, tiles_x);
}

}  // namespace

extern "C" {

// params [T, mpt, R] f32 (16-byte aligned), counts [T] i32, out [T, 8,
// tile_h * tile_w] f32, state null or [T, mpt / 128, 6, tile_h * tile_w]
// f32, work null or int64 [2] (pairs, bytes added to), all contiguous on
// device ``device``; R in {9, 10}; mpt a multiple of 128; tile_h * tile_w at
// most 1024. ``cluster`` (1, 2, 4) blocks a tile and
// ``ppt`` (1, 2, 4) pixels a thread, with tile_h * tile_w a multiple of
// 32 cluster ppt (whole warps). Launches on ``stream``; returns the launch's
// error.
int composite_fwd_f32(const void* params, const void* counts, void* out,
                      void* state, void* work, int T, int mpt, int R, int tile_h,
                      int tile_w, int tiles_x, int cluster, int ppt,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int P = tile_h * tile_w;
  if (P > kMaxPix || (R != 9 && R != 10) || mpt % kChunk != 0 || cluster < 1 ||
      ppt < 1 || P % (32 * cluster * ppt) != 0)
    return (int)cudaErrorInvalidValue;
  auto* p = static_cast<const float*>(params);
  auto* c = static_cast<const int*>(counts);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<float*>(state);
  auto* w = static_cast<unsigned long long*>(work);
  auto st = static_cast<cudaStream_t>(stream);
#define K2_LAUNCH(CS, PPT)                                                  \
  if (cluster == CS && ppt == PPT)                                          \
    return launch<CS, PPT>(p, c, o, s, w, T, mpt, R, tile_h, tile_w, tiles_x, \
                           st);
  K2_LAUNCH(1, 1) K2_LAUNCH(1, 2) K2_LAUNCH(1, 4)
  K2_LAUNCH(2, 1) K2_LAUNCH(2, 2) K2_LAUNCH(2, 4)
  K2_LAUNCH(4, 1) K2_LAUNCH(4, 2) K2_LAUNCH(4, 4)
#undef K2_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
