"""EWA projection of 3D Gaussians to screen space.

``project_gaussians`` is the port of
``lgm_tpu/ops/gsplat/projection.py::project_gaussians`` in plain PyTorch,
in the same structure-of-arrays form: every quantity is an [N] vector.
Math is the standard 3DGS formulation of the CUDA rasterizer the reference
calls (ref: core/gs.py:58-85): camera-space transform -> perspective
Jacobian (frustum-clamped) -> 2D covariance with +0.3 px dilation -> conic,
the exact opacity-aware per-axis extent, and the channel-major slot rows.

``project`` is what the renderers call. On a CUDA tensor it is one launch
of ``csrc/project_fwd.cu`` a view, which gives ``project_gaussians``'s
bits, and, where autograd records it, one launch of ``csrc/project_bwd.cu``
on the way back, whose plain version is ``project_gaussians_bwd_reference``;
on a CPU tensor it is ``project_gaussians``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lgm_tpu_torch import trace
from lgm_tpu_torch.ops import _build

# Same constants as the CUDA rasterizer's behavior (and lgm_tpu's).
NEAR_CULL = 0.2          # camera-space z below which Gaussians are culled
FRUSTUM_CLAMP = 1.3      # clamp x/z, y/z to 1.3 * tan_half_fov before J
COV2D_DILATE = 0.3       # pixel-space covariance dilation (antialias lpf)
ALPHA_MIN = 1.0 / 255.0  # contribution threshold
ALPHA_MAX = 0.99         # saturation cap per splat


class Projected(NamedTuple):
    """Screen-space Gaussians, all [N, ...]."""

    mean2d: torch.Tensor    # [N, 2] pixel coords
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor     # [N] camera-space z
    radius: torch.Tensor    # [N] visibility radius in pixels (0 if culled)
    color: torch.Tensor     # [N, 3]
    opacity: torch.Tensor   # [N]
    valid: torch.Tensor     # [N] bool, survives near/degenerate culling
    radius_x: torch.Tensor  # [N] exact AABB half-width in pixels
    radius_y: torch.Tensor  # [N] exact AABB half-height in pixels
    attrs_t: torch.Tensor   # [R, N] rows (x̄, ȳ, A, B, C, op, r, g, b[, z])


def log_alpha_min(like: torch.Tensor) -> torch.Tensor:
    """ln(ALPHA_MIN) computed in f32, as ``jnp.log(ALPHA_MIN)`` is."""
    return torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32,
                                  device=like.device))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> matrix [..., 3, 3] by the
    unit-quat formula on the raw values, as ``project_gaussians`` takes it
    (``lgm_tpu/ops/gsplat/projection.py::quat_to_rotmat``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def project_gaussians(gaussians: torch.Tensor, view: torch.Tensor,
                      image_size: int, tan_half_fov: float,
                      scale_modifier: float = 1.0,
                      with_depth: bool = False) -> Projected:
    """Project packed Gaussians [N, 14] through one camera. ``view`` is
    the transposed world-to-camera matrix [4, 4] (reference layout), so
    the standard w2c is ``view.T``. ``attrs_t`` has the depth row z last
    (R = 10) with ``with_depth``, else R = 9."""
    p = _intermediates(gaussians, view, image_size, tan_half_fov,
                       scale_modifier)
    opacity = gaussians[:, 3]
    a, b, c, det, inv_det = p["a"], p["b"], p["c"], p["det"], p["inv_det"]
    depth = p["tz"]
    valid = p["front"] & (det > 0.0)
    ca, cb, cc = c * inv_det, -b * inv_det, a * inv_det
    conic = torch.stack([ca, cb, cc], dim=-1)

    # Opacity-aware exact extent: invisible outside q <= tau,
    # tau = 2 ln(op / ALPHA_MIN); per-axis AABB half-widths sqrt(tau a),
    # sqrt(tau c) of the dilated covariance.
    tau = 2.0 * (torch.log(torch.clamp(opacity, min=1e-12))
                 - log_alpha_min(opacity))
    valid = valid & (tau > 0.0)
    tau_s = torch.clamp(tau, min=0.0)
    zero = torch.zeros_like(tau)
    radius_x = torch.where(
        valid, torch.ceil(torch.sqrt(tau_s * torch.clamp(a, min=0.0))), zero)
    radius_y = torch.where(
        valid, torch.ceil(torch.sqrt(tau_s * torch.clamp(c, min=0.0))), zero)
    radius = torch.maximum(radius_x, radius_y)

    center = 0.5 * (image_size - 1)
    mx = p["focal"] * p["tx"] * p["inv_z"] + center
    my = p["focal"] * p["ty"] * p["inv_z"] + center
    attrs_t = torch.stack(
        [mx, my, ca, cb, cc, opacity,
         gaussians[:, 11], gaussians[:, 12], gaussians[:, 13]]
        + ([depth] if with_depth else []), dim=0)

    return Projected(
        mean2d=torch.stack([mx, my], dim=-1),
        conic=conic,
        depth=depth,
        radius=radius,
        color=gaussians[:, 11:14],
        opacity=opacity,
        valid=valid,
        radius_x=radius_x,
        radius_y=radius_y,
        attrs_t=attrs_t,
    )


def _dot3(x, y):
    """x0 y0 + x1 y1 + x2 y2, summed left to right."""
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def _intermediates(gaussians, view, image_size, tan_half_fov,
                   scale_modifier) -> dict:
    """The chain of ``project_gaussians`` up to the conic's 1 / det, each
    quantity an [N] vector (``R``, ``M``, ``C`` as 3 x 3 lists, ``C``
    symmetric; ``j0``, ``j1``, ``u``, ``v`` as lists of 3), one operation
    at a time in the order the projection kernels round them
    (``csrc/project_common.cuh``)."""
    w2c = view.T
    W, t = w2c[:3, :3], w2c[:3, 3]
    focal = 0.5 * image_size / tan_half_fov
    lim = FRUSTUM_CLAMP * tan_half_fov
    pos = [gaussians[:, k] for k in range(3)]
    tx, ty, tz = (_dot3(W[i], pos) + t[i] for i in range(3))
    front = tz > NEAR_CULL
    zs = torch.where(front, tz, torch.ones_like(tz))
    xr, yr = tx / zs, ty / zs
    xc, yc = torch.clamp(xr, -lim, lim), torch.clamp(yr, -lim, lim)
    txz, tyz = xc * zs, yc * zs

    # Rotation from the quaternion AS GIVEN (unit-quat formula, no
    # normalization), as the reference CUDA rasterizer consumes it; M =
    # R diag(s), cov3d C = M M^T.
    R = [list(row.unbind(-1))
         for row in quat_to_rotmat(gaussians[:, 7:11]).unbind(-2)]
    s = [gaussians[:, 4 + k] * scale_modifier for k in range(3)]
    M = [[R[i][k] * s[k] for k in range(3)] for i in range(3)]
    C = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for m in range(i, 3):
            C[i][m] = C[m][i] = _dot3(M[i], M[m])

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    g0 = focal * inv_z
    gx = focal * txz * inv_z2
    gy = focal * tyz * inv_z2
    j0 = [g0 * W[0, k] - gx * W[2, k] for k in range(3)]
    j1 = [g0 * W[1, k] - gy * W[2, k] for k in range(3)]
    u = [_dot3(C[i], j0) for i in range(3)]
    v = [_dot3(C[i], j1) for i in range(3)]
    a = _dot3(j0, u) + COV2D_DILATE
    b = _dot3(j1, u)
    c = _dot3(j1, v) + COV2D_DILATE
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    return dict(W=W, focal=focal, lim=lim, tx=tx, ty=ty, tz=tz, front=front,
                zs=zs, xr=xr, yr=yr, xc=xc, yc=yc, txz=txz, tyz=tyz, R=R,
                s=s, M=M, C=C, inv_z=inv_z, inv_z2=inv_z2, j0=j0, j1=j1, u=u,
                v=v, a=a, b=b, c=c, det=det, inv_det=inv_det)


def project_gaussians_bwd_reference(gaussians: torch.Tensor,
                                    view: torch.Tensor, image_size: int,
                                    tan_half_fov: float,
                                    scale_modifier: float = 1.0,
                                    g_attrs: torch.Tensor = None,
                                    g_depth: torch.Tensor = None
                                    ) -> torch.Tensor:
    """Plain version of the backward kernel: the VJP of
    ``project_gaussians`` at ``gaussians`` [N, 14] for the cotangents of
    the slot rows ``g_attrs`` [R, N] (R = 9, or 10 with the depth row) and
    of ``depth`` [N], either None for zero. Returns the gradient [N, 14]
    (``view`` takes none).

    Closed form, with autograd's conventions for the plain chain: the
    frustum clamp passes the gradient inclusive at both limits; a
    ``where`` sends it to the branch taken (zs = tz only in front of the
    near plane, det only where det > 0); ``1 / where(det > 0, det, 1)``
    is differentiated as written; the radii and ``valid`` carry none (so
    the opacity's only gradient is its own row's); the quaternion is used
    as given. ``mean2d`` and ``conic`` are taken as having no gradient of
    their own, as ``project`` marks them: the slot rows carry theirs."""
    N = gaussians.shape[0]
    zero = gaussians.new_zeros(N)
    go = [zero] * 10
    if g_attrs is not None:
        go[:g_attrs.shape[0]] = list(g_attrs)
    gz = go[9] if g_depth is None else go[9] + g_depth

    p = _intermediates(gaussians, view, image_size, tan_half_fov,
                       scale_modifier)
    W, f = p["W"], p["focal"]
    a, b, c, inv_det, det = p["a"], p["b"], p["c"], p["inv_det"], p["det"]
    gmx, gmy, gca, gcb, gcc = go[:5]

    g_inv_det = gca * c - gcb * b + gcc * a
    ga, gb, gc = gcc * inv_det, -gcb * inv_det, gca * inv_det
    g_det = torch.where(det > 0, -g_inv_det * inv_det * inv_det, zero)
    ga = ga + g_det * c
    gc = gc + g_det * a
    gb = gb - 2.0 * b * g_det

    j0, j1, u, v, C = p["j0"], p["j1"], p["u"], p["v"], p["C"]
    gu = [ga * j0[i] + gb * j1[i] for i in range(3)]
    gv = [gc * j1[i] for i in range(3)]
    gj0 = [ga * u[i] + sum(C[i][m] * gu[m] for m in range(3))
           for i in range(3)]
    gj1 = [gb * u[i] + gc * v[i] + sum(C[i][m] * gv[m] for m in range(3))
           for i in range(3)]
    # C = M M^T: with G = gu j0^T + gv j1^T on C as a full matrix,
    # gM = (G + G^T) M.
    H = [[gu[i] * j0[m] + gv[i] * j1[m] + gu[m] * j0[i] + gv[m] * j1[i]
          for m in range(3)] for i in range(3)]
    M, R, s = p["M"], p["R"], p["s"]
    gM = [[sum(H[i][m] * M[m][col] for m in range(3)) for col in range(3)]
          for i in range(3)]
    gR = [[gM[i][col] * s[col] for col in range(3)] for i in range(3)]
    gs = [sum(gM[i][col] * R[i][col] for i in range(3)) for col in range(3)]
    qw, qx, qy, qz = (gaussians[:, k] for k in range(7, 11))
    g_q = [
        2.0 * (-qz * gR[0][1] + qy * gR[0][2] + qz * gR[1][0]
               - qx * gR[1][2] - qy * gR[2][0] + qx * gR[2][1]),
        2.0 * (qy * gR[0][1] + qz * gR[0][2] + qy * gR[1][0]
               - 2.0 * qx * gR[1][1] - qw * gR[1][2] + qz * gR[2][0]
               + qw * gR[2][1] - 2.0 * qx * gR[2][2]),
        2.0 * (-2.0 * qy * gR[0][0] + qx * gR[0][1] + qw * gR[0][2]
               + qx * gR[1][0] + qz * gR[1][2] - qw * gR[2][0]
               + qz * gR[2][1] - 2.0 * qy * gR[2][2]),
        2.0 * (-2.0 * qz * gR[0][0] - qw * gR[0][1] + qx * gR[0][2]
               + qw * gR[1][0] - 2.0 * qz * gR[1][1] + qy * gR[1][2]
               + qx * gR[2][0] + qy * gR[2][1]),
    ]

    g_g0 = sum(gj0[k] * W[0, k] + gj1[k] * W[1, k] for k in range(3))
    g_gx = -sum(gj0[k] * W[2, k] for k in range(3))
    g_gy = -sum(gj1[k] * W[2, k] for k in range(3))
    inv_z, inv_z2, zs = p["inv_z"], p["inv_z2"], p["zs"]
    tx, ty = p["tx"], p["ty"]
    g_inv_z2 = f * p["txz"] * g_gx + f * p["tyz"] * g_gy
    g_txz = f * inv_z2 * g_gx
    g_tyz = f * inv_z2 * g_gy
    g_inv_z = (f * g_g0 + f * tx * gmx + f * ty * gmy
               + 2.0 * inv_z * g_inv_z2)
    g_zs = -g_inv_z * inv_z * inv_z
    g_zs = g_zs + g_txz * p["xc"] + g_tyz * p["yc"]
    lim = p["lim"]
    g_xr = torch.where((p["xr"] >= -lim) & (p["xr"] <= lim), g_txz * zs, zero)
    g_yr = torch.where((p["yr"] >= -lim) & (p["yr"] <= lim), g_tyz * zs, zero)
    g_tx = f * inv_z * gmx + g_xr / zs
    g_ty = f * inv_z * gmy + g_yr / zs
    g_zs = g_zs - (g_xr * tx + g_yr * ty) / (zs * zs)
    g_tz = gz + torch.where(p["front"], g_zs, zero)

    g_pos = [W[0, j] * g_tx + W[1, j] * g_ty + W[2, j] * g_tz
             for j in range(3)]
    return torch.stack(
        g_pos + [go[5]] + [gs[col] * scale_modifier for col in range(3)]
        + g_q + go[6:9], dim=1)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_FWD_SIGNATURES = {
    "project_fwd_f32": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float] * 8
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}

_BWD_SIGNATURES = {
    "project_bwd_f32": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] * 8
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}


def _scalars(image_size: int, tan_half_fov: float,
             scale_modifier: float) -> tuple:
    """The chain's Python scalars, in the kernels' order (``Scalars`` in
    ``csrc/project_common.cuh``). ctypes rounds each to a C float as
    PyTorch rounds a Python scalar for an f32 tensor operation."""
    return (0.5 * image_size / tan_half_fov, FRUSTUM_CLAMP * tan_half_fov,
            scale_modifier, 0.5 * (image_size - 1), ALPHA_MIN, NEAR_CULL,
            COV2D_DILATE, 1e-12)


def _check_kernel_inputs(what: str, gaussians: torch.Tensor,
                         view: torch.Tensor) -> None:
    if (gaussians.dtype != torch.float32 or gaussians.dim() != 2
            or gaussians.shape[1] != 14 or not gaussians.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous f32 gaussians "
                         f"[N, 14]; got {gaussians.dtype} "
                         f"{tuple(gaussians.shape)}")
    if (view.dtype != torch.float32 or view.shape != (4, 4)
            or view.device != gaussians.device or not view.is_contiguous()):
        raise ValueError(f"{what} kernel takes a contiguous f32 view [4, 4] "
                         f"on {gaussians.device}; got {view.dtype} "
                         f"{tuple(view.shape)} on {view.device}")
    if torch.is_grad_enabled() and view.requires_grad:
        raise NotImplementedError(
            f"{what}: the projection kernels give no gradient to the camera")


def project_fwd(gaussians: torch.Tensor, view: torch.Tensor,
                image_size: int, tan_half_fov: float,
                scale_modifier: float = 1.0,
                with_depth: bool = False) -> Projected:
    """The forward kernel on CUDA tensors: ``project_gaussians``'s fields,
    bit for bit, with ``color`` and ``opacity`` views of ``gaussians``. It
    has no gradient of its own (``project`` gives it one)."""
    if gaussians.device.type != "cuda":
        raise ValueError(f"project_fwd: unsupported device "
                         f"{gaussians.device}")
    _check_kernel_inputs("project_fwd", gaussians, view)
    N, R = gaussians.shape[0], 10 if with_depth else 9
    vec = [torch.empty(N, dtype=torch.float32, device=gaussians.device)
           for _ in range(4)]
    mean2d = gaussians.new_empty(N, 2)
    conic = gaussians.new_empty(N, 3)
    valid = torch.empty(N, dtype=torch.bool, device=gaussians.device)
    attrs_t = gaussians.new_empty(R, N)
    depth, radius, radius_x, radius_y = vec
    lib = _build.load("project_fwd", _FWD_SIGNATURES)
    err = lib.project_fwd_f32(
        gaussians.data_ptr(), view.data_ptr(), mean2d.data_ptr(),
        conic.data_ptr(), depth.data_ptr(), radius.data_ptr(),
        radius_x.data_ptr(), radius_y.data_ptr(), valid.data_ptr(),
        attrs_t.data_ptr(), N, R,
        *_scalars(image_size, tan_half_fov, scale_modifier),
        torch.cuda.current_stream(gaussians.device).cuda_stream,
        gaussians.device.index)
    _build.check(lib, err, "project_fwd")
    project_fwd.launches += 1
    trace.add("project_fwd.launches", 1)
    return Projected(mean2d=mean2d, conic=conic, depth=depth, radius=radius,
                     color=gaussians[:, 11:14], opacity=gaussians[:, 3],
                     valid=valid, radius_x=radius_x, radius_y=radius_y,
                     attrs_t=attrs_t)


project_fwd.launches = 0


def project_bwd(gaussians: torch.Tensor, view: torch.Tensor,
                image_size: int, tan_half_fov: float,
                scale_modifier: float = 1.0, g_attrs: torch.Tensor = None,
                g_depth: torch.Tensor = None) -> torch.Tensor:
    """The backward kernel on CUDA tensors: the gradient [N, 14] for the
    cotangents ``g_attrs`` [R, N] (any strides) and ``g_depth`` [N], either
    None for zero; ``project_gaussians_bwd_reference`` is its plain
    version."""
    if gaussians.device.type != "cuda":
        raise ValueError(f"project_bwd: unsupported device "
                         f"{gaussians.device}")
    _check_kernel_inputs("project_bwd", gaussians, view)
    N = gaussians.shape[0]
    R = 9
    if g_attrs is not None:
        R = g_attrs.shape[0]
        if (g_attrs.dtype != torch.float32 or g_attrs.shape not in
                ((9, N), (10, N)) or g_attrs.device != gaussians.device):
            raise ValueError(f"project_bwd: g_attrs must be an f32 [9 or 10, "
                             f"{N}] tensor on {gaussians.device}; got "
                             f"{g_attrs.dtype} {tuple(g_attrs.shape)}")
    if g_depth is not None and (
            g_depth.dtype != torch.float32 or g_depth.shape != (N,)
            or g_depth.device != gaussians.device
            or not g_depth.is_contiguous()):
        raise ValueError(f"project_bwd: g_depth must be a contiguous f32 "
                         f"[{N}] tensor on {gaussians.device}")
    grad = torch.empty_like(gaussians)
    lib = _build.load("project_bwd", _BWD_SIGNATURES)
    err = lib.project_bwd_f32(
        gaussians.data_ptr(), view.data_ptr(),
        g_attrs.data_ptr() if g_attrs is not None else None,
        *(g_attrs.stride() if g_attrs is not None else (0, 0)),
        g_depth.data_ptr() if g_depth is not None else None,
        grad.data_ptr(), N, R,
        *_scalars(image_size, tan_half_fov, scale_modifier),
        torch.cuda.current_stream(gaussians.device).cuda_stream,
        gaussians.device.index)
    _build.check(lib, err, "project_bwd")
    project_bwd.launches += 1
    trace.add("project_bwd.launches", 1)
    return grad


project_bwd.launches = 0


class _Project(torch.autograd.Function):
    """The forward kernel, and the backward kernel on the way back, which
    recomputes what it needs: the residuals are the inputs. ``mean2d``,
    ``conic``, the radii and ``valid`` have no gradient (the renderers
    read them without one); ``depth`` and the slot rows have."""

    @staticmethod
    def forward(ctx, gaussians, view, image_size, tan_half_fov,
                scale_modifier, with_depth):
        p = project_fwd(gaussians, view, image_size, tan_half_fov,
                        scale_modifier, with_depth)
        ctx.save_for_backward(gaussians, view)
        ctx.args = (image_size, tan_half_fov, scale_modifier)
        ctx.mark_non_differentiable(p.mean2d, p.conic, p.radius, p.valid,
                                    p.radius_x, p.radius_y)
        ctx.set_materialize_grads(False)
        return (p.mean2d, p.conic, p.depth, p.radius, p.valid, p.radius_x,
                p.radius_y, p.attrs_t)

    @staticmethod
    def backward(ctx, _m, _c, g_depth, _r, _v, _rx, _ry, g_attrs):
        gaussians, view = ctx.saved_tensors
        grad = None
        if g_attrs is not None or g_depth is not None:
            grad = project_bwd(
                gaussians, view, *ctx.args, g_attrs=g_attrs,
                g_depth=None if g_depth is None else g_depth.contiguous())
        return grad, None, None, None, None, None


def project(gaussians: torch.Tensor, view: torch.Tensor, image_size: int,
            tan_half_fov: float, scale_modifier: float = 1.0,
            with_depth: bool = False) -> Projected:
    """``project_gaussians`` as the renderers call it: on a CPU tensor that
    function itself; on a CUDA tensor the forward kernel (``project_fwd``)
    and, where autograd records the call, the backward kernel
    (``project_bwd``) on the way back. The kernels take f32 only, and raise
    on anything else."""
    if gaussians.device.type == "cpu":
        return project_gaussians(gaussians, view, image_size, tan_half_fov,
                                 scale_modifier, with_depth)
    gaussians, view = gaussians.contiguous(), view.contiguous()
    if torch.is_grad_enabled() and view.requires_grad:
        raise NotImplementedError(
            "project: the projection kernels give no gradient to the camera")
    if not (torch.is_grad_enabled() and gaussians.requires_grad):
        return project_fwd(gaussians, view, image_size, tan_half_fov,
                           scale_modifier, with_depth)
    mean2d, conic, depth, radius, valid, radius_x, radius_y, attrs_t = (
        _Project.apply(gaussians, view, image_size, tan_half_fov,
                       scale_modifier, with_depth))
    return Projected(mean2d=mean2d, conic=conic, depth=depth, radius=radius,
                     color=gaussians[:, 11:14], opacity=gaussians[:, 3],
                     valid=valid, radius_x=radius_x, radius_y=radius_y,
                     attrs_t=attrs_t)
