// Kernel K3: the v1 tiled rasterizer's composite forward, one image tile per
// thread-block cluster.
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
// boundary for the whole tile, by a vote over all its pixels: inside a live
// chunk every slot is composited for every pixel, whatever that pixel's own
// transmittance, and slots past counts[t] are zero rows (alpha = 0), not
// skipped by index. A per-pixel exit would be another function, and K3ᵇ
// could not replay it. Rows 7 and 11-15 and features 6-7 are the layout's
// constants (0, 1, 0, ...) and are not read.
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
// loop. Here each pixel walks the chunk in order with its own T.
//
// What bounds it on an H100: the work depends on the data. Each (pixel,
// slot) pair of a live chunk costs one exp on the SFU (16 per clock per SM)
// and ~12 f32 operations, ~11 more where it accumulates; bytes are small
// (ten rows of each live chunk in, [T, P, 8] out). Operations bound it; in
// practice the issue rate does (~30 instructions a pair).
//
// The design is K2's (composite_fwd.cu):
// - One tile over a cluster of CS blocks (tile_cluster.cuh), each owning
//   P / CS of its pixels, with the early-out vote ORed over the cluster
//   through distributed shared memory at each boundary.
// - PPT pixels a thread (tid + p * blockDim.x of the block's share), their
//   six features in registers.
// - The chunk staged slot-major (tiled_common.cuh's stage_slots_async), three
//   16-byte broadcasts a slot, into a double buffer by cp.async: the next
//   chunk's rows are in flight while the current one composites. At the
//   boundary each slot gets its cull bound (the pad float 10).
// - A warp skips a slot when every pixel it holds has a power below the
//   slot's cull bound (tiled_common.cuh's cull_bound): those pairs have
//   alpha 0, so the skip leaves the same bits. The scalar-radius binning
//   keeps many slots that meet a tile's box but not most of its pixels
//   (about a quarter of the bench view's pairs are used); a culled (warp,
//   slot) costs the expanded quadratic, a compare and a vote. This
//   measured 0.243-0.245 -> 0.173-0.178 ms on the bench view (NVIDIA H100
//   80GB HBM3, 700 W; K2, where half the pairs are used, is slower with
//   it).
// - The power, test and clamp are tiled_common.cuh's power_of and alpha_of
//   (the two halves of pair_of, which K3ᵇ replays): its fixed rounding
//   sequence; an unused pair adds exact zeros (no
//   branch), and the sums are pinned (__fmaf_rn, __fadd_rn), so every
//   (CS, PPT) gives the same bits.

#include "tiled_common.cuh"

namespace {

using namespace tiled;
using tile_cluster::TileVote;

constexpr int kMaxPix = 1024;

template <int CS, int PPT>
__global__ void __launch_bounds__(kMaxPix / (CS * PPT))
    tiled_fwd_kernel(const float* __restrict__ params,
                     const int* __restrict__ counts,
                     const float* __restrict__ pf, float* __restrict__ out,
                     float* __restrict__ state, int K, int P) {
  __shared__ __align__(16) float slots[2][kChunk * kSlotStride];
  __shared__ int flags[2];
  const TileVote<CS> vote{flags};
  const int tile = tile_cluster::tile_index<CS>();
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int base = tile_cluster::block_rank<CS>() * (P / CS);
  const int count = min(counts[tile], K);
  const float* blk = params + (size_t)tile * kRows * K;

  float f[PPT][kFeat], T[PPT], cr[PPT], cg[PPT], cb[PPT], ca[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pix = base + tid + p * nthr;
#pragma unroll
    for (int k = 0; k < kFeat; ++k) f[p][k] = pf[pix * 8 + k];
    T[p] = 1.f;
    cr[p] = cg[p] = cb[p] = ca[p] = 0.f;
  }
  // Floats 10 (the cull bound, set at each boundary) and 11 of a slot are
  // never copied in.
  for (int j = tid; j < 2 * kChunk; j += nthr) {
    slots[j / kChunk][(j % kChunk) * kSlotStride + 10] = 0.f;
    slots[j / kChunk][(j % kChunk) * kSlotStride + 11] = 0.f;
  }
  const int nc = K / kChunk;
  float* st = state ? state + (size_t)tile * nc * kStateRows * P + base + tid
                    : nullptr;
  int written = 0;  // boundaries of the state written
  auto keep_state = [&]() {
    float* s = st + (size_t)written++ * kStateRows * P;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int o = p * nthr;
      s[0 * P + o] = T[p];
      s[1 * P + o] = cr[p];
      s[2 * P + o] = cg[p];
      s[3 * P + o] = cb[p];
      s[4 * P + o] = ca[p];
    }
  };
  auto fetch = [&](int c0, int buf) {
    stage_slots_async(blk, K, c0, kChunk, slots[buf]);
    tile_cluster::cp_async_commit();
  };

  if (count > 0) fetch(0, 0);
  for (int c = 0, c0 = 0; c0 < count; ++c, c0 += kChunk) {
    if (st) keep_state();
    bool open = false;
#pragma unroll
    for (int p = 0; p < PPT; ++p) open |= T[p] > kTEps;
    // The block's vote; also the barrier before the other buffer is
    // overwritten.
    const int mine = __syncthreads_or(open);
    vote.publish(c, mine);
    if (c0 + kChunk < count) {
      fetch(c0 + kChunk, (c + 1) & 1);
      tile_cluster::cp_async_wait<1>();
    } else {
      tile_cluster::cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's slots, from every thread's copies
    float* sl = slots[c & 1];
    for (int j = tid; j < kChunk; j += nthr)
      sl[j * kSlotStride + 10] = cull_bound(sl[j * kSlotStride + 6]);
    if (!vote.combine(c, mine)) break;
    __syncthreads();  // the cull bounds
    const float4* s4 = reinterpret_cast<const float4*>(sl);
    // Four slots an iteration: 1-3% faster than the compiler's own unroll
    // (K2: ~5%; NVIDIA H100 80GB HBM3, 700 W).
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float4 a = s4[3 * j], b = s4[3 * j + 1], d = s4[3 * j + 2];
      // a, b.xy: coefficients 0-5; b.z: opacity; b.w, d.xy: r, g, b; d.z:
      // the cull bound
      const float cf[kFeat] = {a.x, a.y, a.z, a.w, b.x, b.y};
      float power[PPT];
      bool near = false;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        power[p] = power_of(f[p], cf);
        near |= !(power[p] < d.z);
      }
      // The slot is culled for the warp where no pixel of it can use it.
      if (!__any_sync(0xffffffffu, near)) continue;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const Pair q = alpha_of(power[p], b.z);
        const float w = __fmul_rn(q.alpha, T[p]);
        cr[p] = __fmaf_rn(w, b.w, cr[p]);
        cg[p] = __fmaf_rn(w, d.x, cg[p]);
        cb[p] = __fmaf_rn(w, d.y, cb[p]);
        ca[p] = __fadd_rn(ca[p], w);
        T[p] = attenuate(T[p], q.alpha);
      }
    }
  }
  tile_cluster::cp_async_wait<0>();
  vote.finish();
  if (st)
    while (written < nc) keep_state();
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pix = base + tid + p * nthr;
    float4* o = reinterpret_cast<float4*>(out + ((size_t)tile * P + pix) * 8);
    o[0] = make_float4(cr[p], cg[p], cb[p], ca[p]);
    o[1] = make_float4(T[p], 0.f, 0.f, 0.f);
  }
}

template <int CS, int PPT>
int launch(const float* params, const int* counts, const float* pf,
           float* out, float* state, int T, int K, int P, cudaStream_t stream) {
  return tile_cluster::launch_tiles<CS>(tiled_fwd_kernel<CS, PPT>, T,
                                        P / (CS * PPT), stream, params, counts,
                                        pf, out, state, K, P);
}

}  // namespace

extern "C" {

// params [T, 16, K] f32, counts [T] i32, pf [P, 8] f32, out [T, P, 8] f32,
// state null or [T, K / 128, 5, P] f32, all contiguous on device
// ``device``; K a multiple of 128; P at most 1024. ``cluster`` (1, 2, 4)
// blocks a tile and ``ppt`` (1, 2, 4) pixels a thread, with P a multiple of
// 32 cluster ppt (whole warps). Launches on ``stream``; returns the
// launch's error.
int tiled_fwd_f32(const void* params, const void* counts, const void* pf,
                  void* out, void* state, int T, int K, int P, int cluster,
                  int ppt, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P > kMaxPix || K % kChunk != 0 || cluster < 1 || ppt < 1 ||
      P % (32 * cluster * ppt) != 0)
    return (int)cudaErrorInvalidValue;
  auto* p = static_cast<const float*>(params);
  auto* c = static_cast<const int*>(counts);
  auto* x = static_cast<const float*>(pf);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<float*>(state);
  auto st = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(CS, PPT) \
  if (cluster == CS && ppt == PPT) return launch<CS, PPT>(p, c, x, o, s, T, K, P, st);
  K3_LAUNCH(1, 1) K3_LAUNCH(1, 2) K3_LAUNCH(1, 4)
  K3_LAUNCH(2, 1) K3_LAUNCH(2, 2) K3_LAUNCH(2, 4)
  K3_LAUNCH(4, 1) K3_LAUNCH(4, 2) K3_LAUNCH(4, 4)
#undef K3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
