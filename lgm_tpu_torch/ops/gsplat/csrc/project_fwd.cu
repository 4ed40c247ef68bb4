// The EWA projection of one view, forward: one thread a splat.
//
// Replaces no TPU kernel: lgm_tpu runs projection.py::project_gaussians as
// a chain of elementwise ops that XLA fuses under jit. Eager PyTorch ran
// that chain as ~230 launches a view; this is one. Its plain version is
// lgm_tpu_torch/ops/gsplat/projection.py::project_gaussians, whose bits it
// gives (project_common.cuh): the binning takes ceil(sqrt(.)) of the extent
// and sorts by depth, so one ulp there would move tiles and slots.
//
// Reads the splat's row of gaussians [N, 14] and the view [4, 4] (a device
// pointer: nothing is read on the host). Writes every field of
// projection.py::Projected but color and opacity (views of the input):
// mean2d [N, 2], conic [N, 3], depth, radius, radius_x, radius_y [N] f32,
// valid [N] bool, and the slot rows attrs [R, N] (x̄, ȳ, A, B, C, op, r, g,
// b[, z]), R = 9 or 10.
//
// What bounds it on an H100: bytes, 56 read and 77 written a splat at R 10
// (~8.7 MB at N = 65,536, ~2.6 us at 3.35 TB/s); ~200 f32 operations a
// splat are ~0.2 us at 67 TFLOP/s. At that size a launch's latency is of
// the same order, so the design is the plainest: a 1-D grid, each thread
// its own splat, row-major writes that are coalesced across the warp.

#include "project_common.cuh"

namespace {

using namespace project;

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ gaussians,
                   const float* __restrict__ view, float* __restrict__ mean2d,
                   float* __restrict__ conic, float* __restrict__ depth,
                   float* __restrict__ radius, float* __restrict__ radius_x,
                   float* __restrict__ radius_y, bool* __restrict__ valid,
                   float* __restrict__ attrs, int N, int R, Scalars k) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* g = gaussians + (size_t)n * kCols;
  const Camera cam = load_camera(view);
  Splat p;
  project_splat(g, cam, k, p);

  const float op = g[3];
  const float ca = mul(p.c, p.inv_det);
  const float cb = mul(-p.b, p.inv_det);
  const float cc = mul(p.a, p.inv_det);
  // Opacity-aware extent: tau = 2 (ln max(op, 1e-12) - ln ALPHA_MIN).
  const float tau =
      mul(2.0f, sub(logf(clamp_min(op, k.op_floor)), logf(k.alpha_min)));
  const bool ok = p.front && p.det > 0.0f && tau > 0.0f;
  const float tau_s = clamp_min(tau, 0.0f);
  const float rx = ok ? ceilf(sqrtf(mul(tau_s, clamp_min(p.a, 0.0f)))) : 0.0f;
  const float ry = ok ? ceilf(sqrtf(mul(tau_s, clamp_min(p.c, 0.0f)))) : 0.0f;
  const float mx = add(mul(mul(k.focal, p.tx), p.inv_z), k.center);
  const float my = add(mul(mul(k.focal, p.ty), p.inv_z), k.center);

  mean2d[2 * (size_t)n] = mx;
  mean2d[2 * (size_t)n + 1] = my;
  conic[3 * (size_t)n] = ca;
  conic[3 * (size_t)n + 1] = cb;
  conic[3 * (size_t)n + 2] = cc;
  depth[n] = p.tz;
  radius[n] = maximum(rx, ry);
  radius_x[n] = rx;
  radius_y[n] = ry;
  valid[n] = ok;
  const float row[10] = {mx, my, ca, cb, cc, op, g[11], g[12], g[13], p.tz};
#pragma unroll
  for (int r = 0; r < 10; ++r)
    if (r < R) attrs[(size_t)r * N + n] = row[r];
}

}  // namespace

extern "C" {

// gaussians [N, 14] f32, view [4, 4] f32, mean2d [N, 2], conic [N, 3],
// depth, radius, radius_x, radius_y [N] f32, valid [N] bool, attrs [R, N]
// f32, all contiguous on device ``device``; R 9 or 10. The floats are the
// call's Python scalars (project_common.cuh: Scalars). Launches on
// ``stream``; returns the launch's error.
int project_fwd_f32(const void* gaussians, const void* view, void* mean2d,
                    void* conic, void* depth, void* radius, void* radius_x,
                    void* radius_y, void* valid, void* attrs, int N, int R,
                    float focal, float lim, float mod, float center,
                    float alpha_min, float near, float dilate, float op_floor,
                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 0 || (R != 9 && R != 10)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const Scalars k{focal, lim, mod, center, alpha_min, near, dilate, op_floor};
  project_fwd_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gaussians), static_cast<const float*>(view),
      static_cast<float*>(mean2d), static_cast<float*>(conic),
      static_cast<float*>(depth), static_cast<float*>(radius),
      static_cast<float*>(radius_x), static_cast<float*>(radius_y),
      static_cast<bool*>(valid), static_cast<float*>(attrs), N, R, k);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
