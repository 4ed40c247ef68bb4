"""EWA projection of 3D Gaussians to screen space (plain PyTorch).

Port of ``lgm_tpu/ops/gsplat/projection.py::project_gaussians``, in the
same structure-of-arrays form: every quantity is an [N] vector. Math is
the standard 3DGS formulation of the CUDA rasterizer the reference calls
(ref: core/gs.py:58-85): camera-space transform -> perspective Jacobian
(frustum-clamped) -> 2D covariance with +0.3 px dilation -> conic, the
exact opacity-aware per-axis extent, and the channel-major slot rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    attrs_t: torch.Tensor   # [9, N] rows (x̄, ȳ, A, B, C, op, r, g, b)


def log_alpha_min(like: torch.Tensor) -> torch.Tensor:
    """ln(ALPHA_MIN) computed in f32, as ``jnp.log(ALPHA_MIN)`` is."""
    return torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32,
                                  device=like.device))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> matrix [..., 3, 3] by the
    unit-quat formula on the raw values, as ``project_gaussians`` computes
    R inline (``lgm_tpu/ops/gsplat/projection.py::quat_to_rotmat``)."""
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
                      scale_modifier: float = 1.0) -> Projected:
    """Project packed Gaussians [N, 14] through one camera. ``view`` is
    the transposed world-to-camera matrix [4, 4] (reference layout), so
    the standard w2c is ``view.T``."""
    w2c = view.T
    S = image_size
    focal = 0.5 * S / tan_half_fov

    opacity = gaussians[:, 3]
    px, py, pz = gaussians[:, 0], gaussians[:, 1], gaussians[:, 2]
    sx = gaussians[:, 4] * scale_modifier
    sy = gaussians[:, 5] * scale_modifier
    sz = gaussians[:, 6] * scale_modifier
    qw, qx, qy, qz = (gaussians[:, 7], gaussians[:, 8],
                      gaussians[:, 9], gaussians[:, 10])

    W = w2c[:3, :3]
    tx = W[0, 0] * px + W[0, 1] * py + W[0, 2] * pz + w2c[0, 3]
    ty = W[1, 0] * px + W[1, 1] * py + W[1, 2] * pz + w2c[1, 3]
    tz = W[2, 0] * px + W[2, 1] * py + W[2, 2] * pz + w2c[2, 3]
    depth = tz
    valid = depth > NEAR_CULL
    zs = torch.where(valid, depth, torch.ones_like(depth))

    lim = FRUSTUM_CLAMP * tan_half_fov
    txz = torch.clamp(tx / zs, -lim, lim) * zs
    tyz = torch.clamp(ty / zs, -lim, lim) * zs

    # Rotation from the quaternion AS GIVEN (unit-quat formula, no
    # normalization), as the reference CUDA rasterizer consumes it.
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    # M = R diag(s); cov3d = M M^T.
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    g0 = focal * inv_z
    gx = focal * txz * inv_z2
    gy = focal * tyz * inv_z2
    j00 = g0 * W[0, 0] - gx * W[2, 0]
    j01 = g0 * W[0, 1] - gx * W[2, 1]
    j02 = g0 * W[0, 2] - gx * W[2, 2]
    j10 = g0 * W[1, 0] - gy * W[2, 0]
    j11 = g0 * W[1, 1] - gy * W[2, 1]
    j12 = g0 * W[1, 2] - gy * W[2, 2]

    u0 = c00 * j00 + c01 * j01 + c02 * j02
    u1 = c01 * j00 + c11 * j01 + c12 * j02
    u2 = c02 * j00 + c12 * j01 + c22 * j02
    v0 = c00 * j10 + c01 * j11 + c02 * j12
    v1 = c01 * j10 + c11 * j11 + c12 * j12
    v2 = c02 * j10 + c12 * j11 + c22 * j12
    a = j00 * u0 + j01 * u1 + j02 * u2 + COV2D_DILATE
    b = j10 * u0 + j11 * u1 + j12 * u2
    c = j10 * v0 + j11 * v1 + j12 * v2 + COV2D_DILATE

    det = a * c - b * b
    valid = valid & (det > 0.0)
    inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
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

    center = 0.5 * (S - 1)
    mx = focal * tx * inv_z + center
    my = focal * ty * inv_z + center
    attrs_t = torch.stack(
        [mx, my, ca, cb, cc, opacity,
         gaussians[:, 11], gaussians[:, 12], gaussians[:, 13]], dim=0)

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
