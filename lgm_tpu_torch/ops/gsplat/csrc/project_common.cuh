// The EWA projection of one splat, shared by project_fwd.cu and
// project_bwd.cu.
//
// It is projection.py::project_gaussians for one splat, with every
// operation of that eager chain rounded once, in the chain's order: each
// product, sum and difference through __fmul_rn / __fadd_rn / __fsub_rn,
// so that nvcc's default -fmad cannot contract two of them into one fma;
// IEEE division, sqrtf and logf as PyTorch's CUDA kernels call them (no
// fast math). PyTorch rounds a Python scalar to f32 before an f32 tensor
// operation; the wrapper passes those scalars as C floats, which rounds
// them the same way. So the forward gives the plain chain's bits on the
// card, and the backward recomputes the very intermediates the forward had.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace project {

constexpr int kCols = 14;     // x y z | op | sx sy sz | qw qx qy qz | r g b
constexpr int kThreads = 256;

// The Python scalars of one call, rounded to f32 as PyTorch rounds them.
struct Scalars {
  float focal;      // 0.5 S / tan_half_fov
  float lim;        // FRUSTUM_CLAMP * tan_half_fov
  float mod;        // scale_modifier
  float center;     // 0.5 (S - 1)
  float alpha_min;  // ALPHA_MIN
  float near;       // NEAR_CULL
  float dilate;     // COV2D_DILATE
  float op_floor;   // the opacity's clamp before its log, 1e-12
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp and torch.maximum: NaN passes through.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The camera: ``view`` is the transposed world-to-camera matrix [4, 4], so
// w2c[i][j] = view[4 j + i]; W is w2c's rotation block, t its translation.
struct Camera {
  float W[3][3];
  float t[3];
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ view) {
  Camera cam;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) cam.W[i][j] = __ldg(view + 4 * j + i);
    cam.t[i] = __ldg(view + 12 + i);
  }
  return cam;
}

// Every intermediate of the chain that the gradient reads.
struct Splat {
  float tx, ty, tz, zs;
  bool front;              // tz > NEAR_CULL
  float xr, yr, xc, yc;    // t/zs before and after the frustum clamp
  float txz, tyz;
  float q[4];              // w, x, y, z as given (not normalised)
  float s[3];              // scales times the modifier
  float R[3][3];
  float M[3][3];           // R diag(s)
  float C[3][3];           // M M^T (symmetric)
  float inv_z, inv_z2, g0, gx, gy;
  float j0[3], j1[3];      // the Jacobian's rows through W
  float u[3], v[3];        // C j0, C j1
  float a, b, c, det, inv_det;
};

// Row-dot of three products summed left to right: ((x0 y0 + x1 y1) + x2 y2).
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1,
                                      float x2, float y2) {
  return add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2));
}

__device__ __forceinline__ void project_splat(const float* __restrict__ g,
                                              const Camera& cam,
                                              const Scalars& k, Splat& p) {
  const float px = g[0], py = g[1], pz = g[2];
  const auto& W = cam.W;
  p.tx = add(dot3(W[0][0], px, W[0][1], py, W[0][2], pz), cam.t[0]);
  p.ty = add(dot3(W[1][0], px, W[1][1], py, W[1][2], pz), cam.t[1]);
  p.tz = add(dot3(W[2][0], px, W[2][1], py, W[2][2], pz), cam.t[2]);
  p.front = p.tz > k.near;
  p.zs = p.front ? p.tz : 1.0f;

  p.xr = __fdiv_rn(p.tx, p.zs);
  p.yr = __fdiv_rn(p.ty, p.zs);
  p.xc = clamp(p.xr, -k.lim, k.lim);
  p.yc = clamp(p.yr, -k.lim, k.lim);
  p.txz = mul(p.xc, p.zs);
  p.tyz = mul(p.yc, p.zs);

  const float qw = g[7], qx = g[8], qy = g[9], qz = g[10];
  p.q[0] = qw; p.q[1] = qx; p.q[2] = qy; p.q[3] = qz;
#pragma unroll
  for (int l = 0; l < 3; ++l) p.s[l] = mul(g[4 + l], k.mod);
  // 1 - 2 (..) and 2 (..), as the chain writes them.
  p.R[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  p.R[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
  p.R[0][2] = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
  p.R[1][0] = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
  p.R[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  p.R[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
  p.R[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
  p.R[2][1] = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
  p.R[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) p.M[i][l] = mul(p.R[i][l], p.s[l]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int m = i; m < 3; ++m) {
      p.C[i][m] = dot3(p.M[i][0], p.M[m][0], p.M[i][1], p.M[m][1], p.M[i][2],
                       p.M[m][2]);
      p.C[m][i] = p.C[i][m];
    }

  p.inv_z = __fdiv_rn(1.0f, p.zs);
  p.inv_z2 = mul(p.inv_z, p.inv_z);
  p.g0 = mul(k.focal, p.inv_z);
  p.gx = mul(mul(k.focal, p.txz), p.inv_z2);
  p.gy = mul(mul(k.focal, p.tyz), p.inv_z2);
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    p.j0[l] = sub(mul(p.g0, W[0][l]), mul(p.gx, W[2][l]));
    p.j1[l] = sub(mul(p.g0, W[1][l]), mul(p.gy, W[2][l]));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.u[i] = dot3(p.C[i][0], p.j0[0], p.C[i][1], p.j0[1], p.C[i][2], p.j0[2]);
    p.v[i] = dot3(p.C[i][0], p.j1[0], p.C[i][1], p.j1[1], p.C[i][2], p.j1[2]);
  }
  p.a = add(dot3(p.j0[0], p.u[0], p.j0[1], p.u[1], p.j0[2], p.u[2]), k.dilate);
  p.b = dot3(p.j1[0], p.u[0], p.j1[1], p.u[1], p.j1[2], p.u[2]);
  p.c = add(dot3(p.j1[0], p.v[0], p.j1[1], p.v[1], p.j1[2], p.v[2]), k.dilate);
  p.det = sub(mul(p.a, p.c), mul(p.b, p.b));
  p.inv_det = __fdiv_rn(1.0f, p.det > 0.0f ? p.det : 1.0f);
}

}  // namespace project
