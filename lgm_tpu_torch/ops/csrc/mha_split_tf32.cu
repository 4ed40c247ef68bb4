// The operand split of K1 and K1ᵇ on f32 inputs (mha_fwd_f32.cu,
// mha_bwd_f32.cu): each f32 operand [BH, R, D] split once a call into its
// TF32 halves, hi = rna(x) and lo = rna(x - hi) (mha_f32.cuh), written as
// the planes the kernels' TMA loads read: row-major [BH, R, D] (the
// products over D) and, where asked, transposed [BH, D, R] with each 8-row
// group in the order {0, 2, 4, 6, 1, 3, 5, 7} (the products over the rows,
// whose A operand comes from accumulators with the k index permuted).
//
// Replaces no TPU kernel: lgm_tpu's kernel body (lgm_tpu/ops/mha.py:42,
// :61) multiplies bf16 on the MXU, where the port's f32 kernels need f32
// grade from TF32 tensor cores. Done inside the kernels, the split would
// be redone by every block that reads a tile; here it runs once an
// operand.
//
// What bounds it on an H100: bytes. It reads each operand once and writes
// two or four planes of the same size: at LGM big's bs2 S-4096 site (BH
// 32, D 32) the backward's four operands are 64 MB read and 224 MB
// written, ~86 us at 3.35 TB/s. A block stages 32 rows x D in shared
// memory (rows padded by one float, so the transposed reads are free of
// bank conflicts), writes the row-major halves as it reads, then the
// transposed halves, 32 consecutive rows a warp-wide store.

#include "mha_f32.cuh"

namespace {

using namespace mha;

constexpr int kOps = 4;  // operands a launch
constexpr int kThreads = 256;

struct SplitOp {
  const float* x;       // [BH, R, D]
  float *hi, *lo;       // [BH, R, D] or null
  float *hi_t, *lo_t;   // [BH, D, R] or null
  int R;
};

struct SplitArgs {
  SplitOp op[kOps];
};

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_split_tf32_kernel(const __grid_constant__ SplitArgs a) {
  const SplitOp& op = a.op[blockIdx.z];
  const int r0 = blockIdx.x * tf32::kRows;
  if (r0 >= op.R) return;
  __shared__ float tile[tf32::kRows][D + 1];
  const size_t base = ((size_t)blockIdx.y * op.R + r0) * D;
  for (int i = threadIdx.x; i < tf32::kRows * D; i += kThreads) {
    const float v = op.x[base + i];
    tile[i / D][i % D] = v;
    if (op.hi != nullptr) {
      uint32_t h, l;
      tf32::split(v, h, l);
      op.hi[base + i] = __uint_as_float(h);
      op.lo[base + i] = __uint_as_float(l);
    }
  }
  if (op.hi_t == nullptr) return;
  __syncthreads();
  const size_t tbase = (size_t)blockIdx.y * D * op.R + r0;
  for (int i = threadIdx.x; i < tf32::kRows * D; i += kThreads) {
    const int d = i / tf32::kRows, p = i % tf32::kRows;
    uint32_t h, l;
    tf32::split(tile[(p & ~7) + tf32::perm8(p & 7)][d], h, l);
    op.hi_t[tbase + (size_t)d * op.R + p] = __uint_as_float(h);
    op.lo_t[tbase + (size_t)d * op.R + p] = __uint_as_float(l);
  }
}

}  // namespace

extern "C" {

// ptrs: n operands (1 <= n <= 4) of five pointers each, (x, hi, lo, hi_t,
// lo_t), and rows: n row counts R; x [BH, R, D] contiguous f32; hi, lo
// [BH, R, D] or both null; hi_t, lo_t [BH, D, R] or both null; all on
// device ``device``. D must be 32 or 64, each R a positive multiple of 32.
// Launches one kernel on ``stream``; returns cudaGetLastError() (or the
// error that refused it).
int mha_split_tf32(void* const* ptrs, const int* rows, int n, int BH, int D,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kOps || (D != 32 && D != 64) || BH <= 0)
    return (int)cudaErrorInvalidValue;
  SplitArgs a = {};
  int max_rows = 0;
  for (int i = 0; i < n; ++i) {
    void* const* p = ptrs + 5 * i;
    if (rows[i] <= 0 || rows[i] % tf32::kRows != 0 || p[0] == nullptr ||
        (p[1] == nullptr) != (p[2] == nullptr) ||
        (p[3] == nullptr) != (p[4] == nullptr))
      return (int)cudaErrorInvalidValue;
    a.op[i] = SplitOp{static_cast<const float*>(p[0]),
                      static_cast<float*>(p[1]), static_cast<float*>(p[2]),
                      static_cast<float*>(p[3]), static_cast<float*>(p[4]),
                      rows[i]};
    max_rows = rows[i] > max_rows ? rows[i] : max_rows;
  }
  const dim3 grid(max_rows / tf32::kRows, BH, n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32)
    mha_split_tf32_kernel<32><<<grid, kThreads, 0, st>>>(a);
  else
    mha_split_tf32_kernel<64><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
