"""Camera math: orbit poses, ray generation, projection, convention changes.

The package's own numpy copy of ``lgm_tpu/utils/camera.py`` (the inference
and synthetic-training subset). Conventions (ref: core/utils.py:10-43,
core/provider_objaverse.py:94-170, core/gs.py:23-29):

- World: y-up. Object fits in [-1, 1]^3; orbit cameras at ``cam_radius``.
- OpenGL camera (c2w "pose"): x right, y up, camera looks along -z.
- COLMAP/OpenCV camera: x right, y down, z forward. Conversion from OpenGL
  negates pose columns 1 and 2.
- Pixels are indexed 0..S-1; the continuous center of pixel i is i + 0.5.
  The projection used by the rasterizer maps camera-space (x, y, z) to
  u = f * x/z + (S-1)/2 with f = S / (2 tan(fovy/2)).
"""

from __future__ import annotations

import functools

import numpy as np

_NP_F32 = np.float32


def look_at(campos, target, opengl: bool = True):
    """Rotation matrix for a camera at ``campos`` looking at ``target``.

    OpenGL mode: camera z-axis points from target toward the camera
    (forward = campos - target), so the view direction is -z.
    """
    campos = np.asarray(campos, dtype=_NP_F32)
    target = np.asarray(target, dtype=_NP_F32)
    forward = campos - target if opengl else target - campos
    forward = forward / np.maximum(np.linalg.norm(forward), 1e-8)
    up = np.asarray([0.0, 1.0, 0.0], dtype=_NP_F32)
    right = np.cross(up, forward) if opengl else np.cross(forward, up)
    right = right / np.maximum(np.linalg.norm(right), 1e-8)
    up = np.cross(forward, right) if opengl else np.cross(right, forward)
    up = up / np.maximum(np.linalg.norm(up), 1e-8)
    return np.stack([right, up, forward], axis=-1)


def orbit_camera(elevation: float, azimuth: float, radius: float = 1.0,
                 is_degree: bool = True, target=None, opengl: bool = True):
    """OpenGL c2w pose for an orbit camera (kiui.cam.orbit_camera
    convention, ref: core/models.py:61-70): elevation > 0 puts the camera
    *below* the equator (y = -r sin(el)), azimuth 0 on +z, 90 on +x."""
    if is_degree:
        elevation = np.deg2rad(elevation)
        azimuth = np.deg2rad(azimuth)
    x = radius * np.cos(elevation) * np.sin(azimuth)
    y = -radius * np.sin(elevation)
    z = radius * np.cos(elevation) * np.cos(azimuth)
    if target is None:
        target = np.zeros(3, dtype=_NP_F32)
    campos = np.array([x, y, z], dtype=_NP_F32) + np.asarray(target, _NP_F32)
    T = np.eye(4, dtype=_NP_F32)
    T[:3, :3] = look_at(campos, np.asarray(target, _NP_F32), opengl)
    T[:3, 3] = campos
    return T


def focal_from_fovy(fovy_deg: float, size: int) -> float:
    return 0.5 * size / np.tan(0.5 * np.deg2rad(fovy_deg))


@functools.lru_cache(maxsize=8)
def _pixel_dirs_cached(h: int, w: int, focal: float, sign: float):
    ii, jj = np.meshgrid(
        np.arange(w, dtype=_NP_F32), np.arange(h, dtype=_NP_F32),
        indexing="xy",
    )
    dirs = np.stack(
        [
            (ii - w * 0.5 + 0.5) / focal,
            (jj - h * 0.5 + 0.5) / focal * sign,
            np.full_like(ii, sign),
        ],
        axis=-1,
    )
    dirs.setflags(write=False)  # shared across callers
    return dirs


def get_rays(pose, h: int, w: int, fovy_deg: float, opengl: bool = True):
    """Per-pixel ray origins and unit directions in world space, each
    [h, w, 3], for a c2w ``pose`` [4, 4] (ref: core/utils.py:10-43)."""
    pose = np.asarray(pose, dtype=_NP_F32)
    focal = focal_from_fovy(fovy_deg, h)
    sign = -1.0 if opengl else 1.0
    dirs = _pixel_dirs_cached(h, w, float(focal), sign)
    rays_d = dirs @ pose[:3, :3].T
    rays_d = rays_d / np.maximum(
        np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-8
    )
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o, rays_d


def plucker_rays(pose, h: int, w: int, fovy_deg: float):
    """6-channel Plücker ray embedding [h, w, 6]: (o x d, d)
    (ref: core/models.py:74-75)."""
    rays_o, rays_d = get_rays(pose, h, w, fovy_deg)
    return np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)


def perspective_matrix(fovy_deg: float, znear: float, zfar: float):
    """Row-vector-convention perspective matrix in the reference's layout
    (ref: core/gs.py:23-29)."""
    t = np.tan(0.5 * np.deg2rad(fovy_deg))
    P = np.zeros((4, 4), dtype=_NP_F32)
    P[0, 0] = 1.0 / t
    P[1, 1] = 1.0 / t
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[3, 2] = -(zfar * znear) / (zfar - znear)
    P[2, 3] = 1.0
    return P


def opengl_to_colmap(poses):
    """Negate up/forward columns: OpenGL c2w -> COLMAP/OpenCV c2w."""
    poses = np.asarray(poses, dtype=_NP_F32)
    flip = np.asarray([1.0, -1.0, -1.0, 1.0], dtype=_NP_F32)
    return poses * flip[None, :]


def invert_pose(poses):
    """Fast rigid-transform inverse for c2w [..., 4, 4] -> w2c."""
    poses = np.asarray(poses, dtype=_NP_F32)
    R = poses[..., :3, :3]
    t = poses[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    top = np.concatenate([Rt, -Rt @ t], axis=-1)
    bottom = np.broadcast_to(
        np.asarray([0.0, 0.0, 0.0, 1.0], dtype=_NP_F32),
        top.shape[:-2] + (1, 4),
    )
    return np.concatenate([top, bottom], axis=-2)


def canonicalize_poses(poses, cam_radius: float):
    """Rigidly transform all poses so pose[0] sits at the canonical front
    position (identity rotation, translation (0, 0, cam_radius))
    (ref: core/provider_objaverse.py:127-128)."""
    poses = np.asarray(poses, dtype=_NP_F32)
    target = np.eye(4, dtype=_NP_F32)
    target[2, 3] = cam_radius
    transform = target @ invert_pose(poses[0])
    return transform[None] @ poses


def build_camera_inputs(poses_opengl, fovy_deg: float, znear: float,
                        zfar: float):
    """From OpenGL c2w poses [..., 4, 4] build the rasterizer camera dict
    in the reference's transposed layout
    (ref: core/provider_objaverse.py:160-170):

    - ``cam_view``      [..., 4, 4] = (w2c of the COLMAP pose)^T
    - ``cam_view_proj`` [..., 4, 4] = cam_view @ P
    - ``cam_pos``       [..., 3]     camera world position
    """
    w2c = invert_pose(opengl_to_colmap(poses_opengl))
    cam_view = np.swapaxes(w2c, -1, -2)
    cam_view_proj = cam_view @ perspective_matrix(fovy_deg, znear, zfar)
    cam_pos = np.asarray(poses_opengl, dtype=_NP_F32)[..., :3, 3]
    return {
        "cam_view": cam_view,
        "cam_view_proj": cam_view_proj,
        "cam_pos": cam_pos,
    }


def default_plucker_embedding(opt, elevation: float = 0.0,
                              num_views: int = 4):
    """Plücker embeddings for the canonical orbit views (az 0/90/180/270)
    used at inference (ref: core/models.py:61-85). Returns
    ([V, H, W, 6] NHWC, poses [V, 4, 4])."""
    poses = np.stack(
        [
            orbit_camera(elevation, az, radius=opt.cam_radius)
            for az in np.arange(num_views) * (360.0 / num_views)
        ],
        axis=0,
    )
    emb = np.stack(
        [
            plucker_rays(p, opt.input_size, opt.input_size, opt.fovy)
            for p in poses
        ],
        axis=0,
    ).astype(_NP_F32)
    return emb, poses
