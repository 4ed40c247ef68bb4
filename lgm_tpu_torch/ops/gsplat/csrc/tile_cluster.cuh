// Shared by composite_fwd.cu (K2) and tiled_fwd.cu (K3): one image tile
// composited by a thread-block cluster, and the asynchronous copies that
// stage the next chunk while the current one composites.
//
// A tile's pixels are split over the CS blocks of a cluster (CS = 1, 2 or
// 4; the grid holds T * CS blocks), so that a heavy tile's (pixel, slot)
// pairs spread over CS SMs. The compositors' early-out stays tile-wide: at
// each 128-slot boundary every block takes its own vote
// (__syncthreads_or), publishes it in its shared memory, and, after a
// cluster barrier, ORs the CS published votes through distributed shared
// memory. Every block reads the same bits, so every block of the tile
// takes the same decision, and the function is the one a single block
// voting over all the tile's pixels computes. The flags are double-buffered
// by chunk parity: a block writes the flag of chunk c + 1 only after the
// barrier of chunk c, which every block reaches after reading the flags of
// chunk c - 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_cluster {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile this block composites and its rank in the tile's cluster.
template <int CS>
__device__ __forceinline__ int tile_index() {
  if constexpr (CS == 1) {
    return blockIdx.x;
  } else {
    uint32_t id;
    asm("mov.u32 %0, %%clusterid.x;" : "=r"(id));
    return (int)id;
  }
}

template <int CS>
__device__ __forceinline__ int block_rank() {
  if constexpr (CS == 1) {
    return 0;
  } else {
    uint32_t r;
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return (int)r;
  }
}

// The tile-wide vote at chunk boundary c, in two halves so that the
// cluster barrier's latency overlaps the staging of the chunk:
//   publish(c, v)  after the block's __syncthreads_or gave v;
//   combine(c, v)  later, returns the OR over the cluster's blocks;
//   finish()       before the block exits, so that no block leaves while
//                  another may still read its flags.
// All threads of every block call each step the same number of times.
template <int CS>
struct TileVote {
  int* flags;  // __shared__ int[2]

  __device__ __forceinline__ void publish(int c, int v) const {
    if constexpr (CS > 1) {
      if (threadIdx.x == 0) flags[c & 1] = v;
      asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ bool combine(int c, int v) const {
    if constexpr (CS == 1) {
      return v != 0;
    } else {
      asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
      const uint32_t local = smem_u32(flags + (c & 1));
      int any = 0;
#pragma unroll
      for (uint32_t r = 0; r < CS; ++r) {
        uint32_t remote;
        int f;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote)
                     : "r"(local), "r"(r));
        asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
                     : "=r"(f)
                     : "r"(remote)
                     : "memory");
        any |= f;
      }
      return any != 0;
    }
  }

  __device__ __forceinline__ void finish() const {
    if constexpr (CS > 1) {
      asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    }
  }
};

// Launches kernel over T tiles, CS blocks a tile (one cluster), on stream;
// returns the launch's error, or cudaGetLastError().
template <int CS, class... Params, class... Args>
int launch_tiles(void (*kernel)(Params...), int T, int threads, cudaStream_t stream,
                 Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T * CS);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tile_cluster
