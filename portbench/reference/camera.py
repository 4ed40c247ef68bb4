"""Camera math of the benchmark's own: orbit poses, Plücker rays and the
rasterizer's camera layout, in numpy.

A frozen copy of the conventions LGM uses (kiui's ``orbit_camera``, OpenGL
c2w poses, COLMAP w2c handed to the rasterizer transposed; LGM
core/utils.py, core/provider_objaverse.py, core/gs.py). It imports nothing
of the program, so the inputs the benchmark makes do not move when the
program's copy changes.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def look_at(campos, target):
    """OpenGL rotation of a camera at ``campos`` looking at ``target``."""
    forward = np.asarray(campos, F32) - np.asarray(target, F32)
    forward = forward / np.maximum(np.linalg.norm(forward), 1e-8)
    up = np.asarray([0.0, 1.0, 0.0], F32)
    right = np.cross(up, forward)
    right = right / np.maximum(np.linalg.norm(right), 1e-8)
    up = np.cross(forward, right)
    up = up / np.maximum(np.linalg.norm(up), 1e-8)
    return np.stack([right, up, forward], axis=-1)


def orbit_camera(elevation: float, azimuth: float, radius: float):
    """OpenGL c2w pose in degrees: elevation > 0 puts the camera below the
    equator (y = -r sin(el)), azimuth 0 on +z, 90 on +x."""
    el, az = np.deg2rad(elevation), np.deg2rad(azimuth)
    campos = np.array([radius * np.cos(el) * np.sin(az),
                       -radius * np.sin(el),
                       radius * np.cos(el) * np.cos(az)], F32)
    pose = np.eye(4, dtype=F32)
    pose[:3, :3] = look_at(campos, np.zeros(3, F32))
    pose[:3, 3] = campos
    return pose


def plucker_rays(pose, size: int, fovy: float):
    """[size, size, 6] Plücker embedding (o x d, d) of a c2w pose."""
    pose = np.asarray(pose, F32)
    focal = 0.5 * size / np.tan(0.5 * np.deg2rad(fovy))
    ii, jj = np.meshgrid(np.arange(size, dtype=F32),
                         np.arange(size, dtype=F32), indexing="xy")
    dirs = np.stack([(ii - size * 0.5 + 0.5) / focal,
                     -(jj - size * 0.5 + 0.5) / focal,
                     np.full_like(ii, -1.0)], axis=-1)
    rays_d = dirs @ pose[:3, :3].T
    rays_d = rays_d / np.maximum(
        np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-8)
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    return np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)


def invert_pose(poses):
    poses = np.asarray(poses, F32)
    rt = np.swapaxes(poses[..., :3, :3], -1, -2)
    top = np.concatenate([rt, -rt @ poses[..., :3, 3:]], axis=-1)
    bottom = np.broadcast_to(np.asarray([0, 0, 0, 1], F32),
                             top.shape[:-2] + (1, 4))
    return np.concatenate([top, bottom], axis=-2)


def canonicalize_poses(poses, radius: float):
    """Move every pose rigidly so pose 0 sits at (0, 0, radius), unrotated."""
    target = np.eye(4, dtype=F32)
    target[2, 3] = radius
    return (target @ invert_pose(poses[0]))[None] @ np.asarray(poses, F32)


def cam_view(poses_opengl):
    """The rasterizer's camera: the transposed w2c of the COLMAP pose."""
    colmap = np.asarray(poses_opengl, F32) * np.asarray([1, -1, -1, 1], F32)
    return np.swapaxes(invert_pose(colmap), -1, -2)


def orbit_views(n: int, radius: float, elevation: float = 0.0):
    """``n`` c2w poses evenly round the orbit from azimuth 0."""
    return np.stack([orbit_camera(elevation, az, radius)
                     for az in np.linspace(0, 360, n, endpoint=False)])
