// The EWA projection of one view, backward: one thread a splat.
//
// Replaces no TPU kernel (project_fwd.cu says why). Eager autograd ran the
// plain chain's backward as ~215 nodes and ~500 launches a view, and kept
// a few dozen [N] intermediates alive from the render's forward to its
// backward; this is one launch that saves nothing but its inputs: it
// recomputes the forward's intermediates from the splat's row and the
// view (project_common.cuh, the forward's own arithmetic). Its plain
// version is projection.py::project_gaussians_bwd_reference, the closed
// form of this VJP.
//
// Takes the cotangent of the slot rows g_attrs [R, N] (any strides: the
// gather's backward hands it back transposed) or none, and that of the
// depth output g_depth [N] or none; writes the gradient [N, 14] of the
// view's Gaussians. Autograd's conventions for the plain chain: the frustum
// clamp passes the gradient inclusive at both limits; a where sends it to
// the branch taken (zs = tz only in front of the near plane, det only
// where det > 0); 1 / where(det > 0, det, 1) and the clamp are
// differentiated as written; ceil, the radii and valid carry none; the
// quaternion is used as given. Each thread writes only its own row: no
// atomics, the same bits on every run.
//
// What bounds it on an H100: bytes, 56 read, 36-40 of cotangent read and
// 56 written a splat (~9.8 MB at N = 65,536, ~2.9 us at 3.35 TB/s); ~500
// f32 operations a splat are ~0.5 us at 67 TFLOP/s. So, as the forward,
// it is one thread a splat in a 1-D grid.

#include "project_common.cuh"

namespace {

using namespace project;

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ gaussians,
                   const float* __restrict__ view,
                   const float* __restrict__ g_attrs, long long stride_r,
                   long long stride_n, const float* __restrict__ g_depth,
                   float* __restrict__ grad, int N, int R, Scalars k) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* g = gaussians + (size_t)n * kCols;
  const Camera cam = load_camera(view);
  const auto& W = cam.W;
  Splat p;
  project_splat(g, cam, k, p);

  float go[10];
#pragma unroll
  for (int r = 0; r < 10; ++r)
    go[r] = g_attrs && r < R ? g_attrs[r * stride_r + n * stride_n] : 0.0f;
  const float gmx = go[0], gmy = go[1], gca = go[2], gcb = go[3], gcc = go[4];
  const float gz = go[9] + (g_depth ? g_depth[n] : 0.0f);

  // Conic (ca, cb, cc) = (c, -b, a) / where(det > 0, det, 1).
  const float g_inv_det = gca * p.c - gcb * p.b + gcc * p.a;
  float ga = gcc * p.inv_det, gb = -gcb * p.inv_det, gc = gca * p.inv_det;
  const float g_det =
      p.det > 0.0f ? -g_inv_det * p.inv_det * p.inv_det : 0.0f;
  ga += g_det * p.c;
  gc += g_det * p.a;
  gb -= 2.0f * p.b * g_det;

  // a = j0.u + 0.3, b = j1.u, c = j1.v + 0.3 with u = C j0, v = C j1.
  float gu[3], gv[3], gj0[3], gj1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gu[i] = ga * p.j0[i] + gb * p.j1[i];
    gv[i] = gc * p.j1[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float cu = 0.0f, cv = 0.0f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      cu += p.C[i][m] * gu[m];
      cv += p.C[i][m] * gv[m];
    }
    gj0[i] = ga * p.u[i] + cu;
    gj1[i] = gb * p.u[i] + gc * p.v[i] + cv;
  }
  // C = M M^T: with G = gu j0^T + gv j1^T the gradient on C as a full
  // matrix, gM = (G + G^T) M.
  float H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int m = 0; m < 3; ++m)
      H[i][m] = gu[i] * p.j0[m] + gv[i] * p.j1[m] + gu[m] * p.j0[i] +
                gv[m] * p.j1[i];
  float gR[3][3], gs[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const float gM = H[i][0] * p.M[0][l] + H[i][1] * p.M[1][l] +
                       H[i][2] * p.M[2][l];
      gR[i][l] = gM * p.s[l];
      gs[l] += gM * p.R[i][l];
    }
  // R from the quaternion (w, x, y, z) by the unit-quaternion formula.
  const float qw = p.q[0], qx = p.q[1], qy = p.q[2], qz = p.q[3];
  const float g_qw = 2.0f * (-qz * gR[0][1] + qy * gR[0][2] + qz * gR[1][0] -
                             qx * gR[1][2] - qy * gR[2][0] + qx * gR[2][1]);
  const float g_qx =
      2.0f * (qy * gR[0][1] + qz * gR[0][2] + qy * gR[1][0] -
              2.0f * qx * gR[1][1] - qw * gR[1][2] + qz * gR[2][0] +
              qw * gR[2][1] - 2.0f * qx * gR[2][2]);
  const float g_qy =
      2.0f * (-2.0f * qy * gR[0][0] + qx * gR[0][1] + qw * gR[0][2] +
              qx * gR[1][0] + qz * gR[1][2] - qw * gR[2][0] + qz * gR[2][1] -
              2.0f * qy * gR[2][2]);
  const float g_qz =
      2.0f * (-2.0f * qz * gR[0][0] - qw * gR[0][1] + qx * gR[0][2] +
              qw * gR[1][0] - 2.0f * qz * gR[1][1] + qy * gR[1][2] +
              qx * gR[2][0] + qy * gR[2][1]);

  // j0 = g0 W0 - gx W2, j1 = g0 W1 - gy W2.
  float g_g0 = 0.0f, g_gx = 0.0f, g_gy = 0.0f;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    g_g0 += gj0[l] * W[0][l] + gj1[l] * W[1][l];
    g_gx -= gj0[l] * W[2][l];
    g_gy -= gj1[l] * W[2][l];
  }
  const float f = k.focal;
  // g0 = f inv_z; gx = (f txz) inv_z2; mx = (f tx) inv_z + center.
  const float g_inv_z2 = f * p.txz * g_gx + f * p.tyz * g_gy;
  const float g_txz = f * p.inv_z2 * g_gx;
  const float g_tyz = f * p.inv_z2 * g_gy;
  const float g_inv_z = f * g_g0 + f * p.tx * gmx + f * p.ty * gmy +
                        2.0f * p.inv_z * g_inv_z2;
  float g_zs = -g_inv_z * p.inv_z * p.inv_z;
  // txz = clamp(tx / zs) zs, the clamp's mask inclusive at both limits.
  g_zs += g_txz * p.xc + g_tyz * p.yc;
  const float g_xr =
      p.xr >= -k.lim && p.xr <= k.lim ? g_txz * p.zs : 0.0f;
  const float g_yr =
      p.yr >= -k.lim && p.yr <= k.lim ? g_tyz * p.zs : 0.0f;
  const float g_tx = f * p.inv_z * gmx + g_xr / p.zs;
  const float g_ty = f * p.inv_z * gmy + g_yr / p.zs;
  g_zs -= (g_xr * p.tx + g_yr * p.ty) / (p.zs * p.zs);
  const float g_tz = gz + (p.front ? g_zs : 0.0f);

  float* out = grad + (size_t)n * kCols;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = W[0][j] * g_tx + W[1][j] * g_ty + W[2][j] * g_tz;
  out[3] = go[5];
#pragma unroll
  for (int l = 0; l < 3; ++l) out[4 + l] = gs[l] * k.mod;
  out[7] = g_qw;
  out[8] = g_qx;
  out[9] = g_qy;
  out[10] = g_qz;
  out[11] = go[6];
  out[12] = go[7];
  out[13] = go[8];
}

}  // namespace

extern "C" {

// gaussians [N, 14] f32 and view [4, 4] f32 contiguous; g_attrs null or
// [R, N] f32 at element strides (stride_r, stride_n); g_depth null or [N]
// f32 contiguous; grad [N, 14] f32 contiguous; all on device ``device``; R
// 9 or 10. The floats are the forward's Python scalars (Scalars; the
// gradient reads focal, lim and mod). Launches on ``stream``; returns the
// launch's error.
int project_bwd_f32(const void* gaussians, const void* view,
                    const void* g_attrs, long long stride_r,
                    long long stride_n, const void* g_depth, void* grad, int N,
                    int R, float focal, float lim, float mod, float center,
                    float alpha_min, float near, float dilate, float op_floor,
                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 0 || (R != 9 && R != 10)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const Scalars k{focal, lim, mod, center, alpha_min, near, dilate, op_floor};
  project_bwd_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gaussians), static_cast<const float*>(view),
      static_cast<const float*>(g_attrs), stride_r, stride_n,
      static_cast<const float*>(g_depth), static_cast<float*>(grad), N, R, k);
  return (int)cudaGetLastError();
}

const char* kernel_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
