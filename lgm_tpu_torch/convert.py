"""Gaussians -> NeRF -> textured mesh conversion (reference convert.py).

Port of ``lgm_tpu/convert.py``: the same three-stage distillation, stage
names and host draws (one ``np.random.default_rng(seed)`` consumed in
lgm_tpu's order), in plain PyTorch on the card:

1. ``fit_nerf``: a hash-grid NeRF (``ops/hashgrid.py`` + two linear
   heads) fitted to random orbit renders of the Gaussians (the teacher:
   ``render_views`` with dup 32, kernel K2 on the card) through the
   occupancy-grid ray marcher (``ops/raymarch.py``), plus direct 3D
   supervision from the Gaussian mixture (``mixture_field``).
2. ``extract_mesh`` + ``fit_mesh``: marching tetrahedra on a density grid,
   clean and decimation (``native.py``, host C++), then per-vertex offsets
   fitted to Gaussian renders through the triangle rasterizer
   (``ops/trirast.py``) with Laplacian and offset terms.
3. ``unwrap_uv`` + ``fit_texture``: the chart-based UV unwrap (host C++),
   a bake of the field's colours, then the texture fitted to front-biased
   Gaussian renders.

Export: binary glTF (.glb) with an embedded PNG texture, or .obj.

Differences from lgm_tpu: ``unwrap_uv`` calls the native chart unwrap and
does not fall back to the box projection (the library is built from the
repository's sources and a failed build raises); ``_unwrap_uv_box`` is
kept and runs only when called. Adam is ``torch.optim.Adam`` with optax's
defaults (f32 moments, b1 0.9, b2 0.999, eps 1e-8). Matmuls run in full
f32.

Run: python -m lgm_tpu_torch.convert big --test-path model.ply
         [--out model.glb] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lgm_tpu_torch import native
from lgm_tpu_torch.config import CONFIGS, Options
from lgm_tpu_torch.infer import resolve_device
from lgm_tpu_torch.models.unet import use_full_float32
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.ops.gsplat.projection import quat_to_rotmat
from lgm_tpu_torch.ops.hashgrid import HashGridEncoder
from lgm_tpu_torch.ops.raymarch import OccupancyGrid, render_rays
from lgm_tpu_torch.ops.trirast import render_mesh, texture as tex_sample
from lgm_tpu_torch.utils import camera

# Rays a fit_nerf iteration trains on, and samples a ray.
N_RAYS, N_SAMPLES = 4096, 128


def mixture_field(gaussians: torch.Tensor, pts: torch.Tensor,
                  density_scale: float = 30.0):
    """Analytic density/colour of the 3D Gaussian mixture at points
    (``lgm_tpu/convert.py:40-73``): pts [M, 3] -> (sigma [M], rgb [M, 3],
    weight-sum [M]), without gradient. The quaternions are normalised
    here, so the density matches the rendered covariance for quats of any
    norm. Works on [M, N] weights at once (N Gaussians)."""
    with torch.no_grad():
        pos = gaussians[:, 0:3]
        op = gaussians[:, 3]
        scl = torch.clamp_min(gaussians[:, 4:7], 1e-4)
        quat = gaussians[:, 7:11]
        col = gaussians[:, 11:14]
        quat = quat / torch.clamp_min(
            torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
        R = quat_to_rotmat(quat)                        # [N, 3, 3]
        d = pts[:, None, :] - pos[None, :, :]           # [M, N, 3]
        local = torch.einsum("mnj,njk->mnk", d, R)      # into gaussian frame
        q = torch.sum((local / scl[None]) ** 2, dim=-1)  # [M, N]
        w = op[None] * torch.exp(-0.5 * q)              # [M, N]
        wsum = torch.sum(w, dim=1)
        rgb = (w @ col) / torch.clamp_min(wsum[:, None], 1e-6)
        return density_scale * wsum, rgb, wsum


def _orbit_pose(rng, radius, front_bias=False):
    if front_bias and rng.random() < 0.5:
        el = rng.uniform(-30, 30)
        az = rng.uniform(-60, 60)
    else:
        el = rng.uniform(-60, 60)
        az = rng.uniform(0, 360)
    return camera.orbit_camera(el, az, radius)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """Flax's Dense default: truncated normal (±2 std) of variance
    1/fan_in."""
    std = (1.0 / weight.shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class NerfField(nn.Module):
    """The converter's radiance field (``lgm_tpu/convert.py:138-160``):
    pts in [-1, 1] -> hash grid (12 levels x 2 features, 2^17 entries,
    resolutions 16-512) -> Linear(24, 64) -> ReLU -> Linear(64, 4);
    sigma = exp(clip(h0, -10, 10)), rgb = sigmoid(h1:4). ``dirs`` is
    unused, as in lgm_tpu. Initialised as Flax initialises it."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid = HashGridEncoder(num_levels=12, features=2,
                                    log2_table_size=17, base_resolution=16,
                                    max_resolution=512, generator=generator)
        self.mlp1 = nn.utils.skip_init(nn.Linear, 24, 64)
        self.mlp2 = nn.utils.skip_init(nn.Linear, 64, 4)
        with torch.no_grad():
            for lin in (self.mlp1, self.mlp2):
                _lecun_normal_(lin.weight, generator)
                lin.bias.zero_()

    def forward(self, pts: torch.Tensor, dirs=None):
        x = (pts + 1.0) * 0.5
        h = self.mlp2(torch.relu(self.mlp1(self.grid(x))))
        sigma = torch.exp(torch.clamp(h[:, 0], -10, 10))
        rgb = torch.sigmoid(h[:, 1:4])
        return sigma, rgb


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: f32 moments, b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class Converter:
    """Gaussians [N, 14] -> textured mesh, on ``device`` (``cuda`` unless
    the caller asks for the CPU). ``losses`` holds each stage's loss at
    every iteration once the stage has run."""

    def __init__(self, opt: Options, gaussians: np.ndarray, seed: int = 0,
                 device: str = "cuda"):
        self.dev = resolve_device(device)
        use_full_float32()
        self.opt = opt
        self.gaussians = np.asarray(gaussians, np.float32)
        self.rng = np.random.default_rng(seed)
        self.tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
        self.seed = seed
        self.jitter_gen = torch.Generator(self.dev).manual_seed(seed)
        self._gaussians = torch.as_tensor(self.gaussians, device=self.dev)

        self.field: Optional[NerfField] = None
        self.grid: Optional[OccupancyGrid] = None
        self.verts = None
        self.faces = None
        self.uv = None
        self.texture = None
        self.n_charts = None
        self.losses: Dict[str, list] = {}

    # ------------------------------------------------------------------
    # Teacher: Gaussian renders
    # ------------------------------------------------------------------

    def render_gs(self, pose: np.ndarray, size: int):
        """One teacher view (``lgm_tpu/convert.py:108-132``): rgb [S, S, 3]
        on white, alpha [S, S] (tensors on the device) and the camera's
        view-projection [4, 4] (numpy). flatsort with dup 32: K2 on the
        card."""
        cams = camera.build_camera_inputs(pose[None], self.opt.fovy,
                                          self.opt.znear, self.opt.zfar)
        with torch.inference_mode():
            out = render_views(
                self._gaussians[None],
                torch.as_tensor(cams["cam_view"], device=self.dev)[None],
                size, self.tan, dup=32)
        # Outside inference mode: autograd may save what is made from them.
        return (out["image"][0, 0].clone(), out["alpha"][0, 0, :, :, 0].clone(),
                cams["cam_view_proj"][0])

    # ------------------------------------------------------------------
    # Stage 1: NeRF distillation
    # ------------------------------------------------------------------

    def new_field(self) -> NerfField:
        """The field as ``fit_nerf`` starts it, drawn from ``seed``."""
        gen = torch.Generator().manual_seed(self.seed)
        return NerfField(gen).to(self.dev)

    def sample_points(self, n: int = 2048) -> np.ndarray:
        """Half near Gaussian centres, half uniform in the AABB
        (``lgm_tpu/convert.py:206-216``, the same draws)."""
        k = n // 2
        sel = self.rng.integers(0, len(self.gaussians), k)
        near = (self.gaussians[sel, 0:3]
                + self.rng.normal(0, 1, (k, 3))
                * self.gaussians[sel, 4:7] * 2.0)
        uni = self.rng.uniform(-1, 1, (n - k, 3))
        return np.clip(np.concatenate([near, uni]), -1, 1).astype(np.float32)

    def nerf_batch(self, resolution: int):
        """One iteration's host draws and teacher view, in lgm_tpu's order
        (pose, the view, ``sel``, then ``sample_points``): returns
        (pose, rays_o, rays_d [R, 3] numpy, gt_rgb [R, 3], gt_alpha [R] on
        the device, pts3d [2048, 3] numpy), R = ``N_RAYS``."""
        pose = _orbit_pose(self.rng, self.opt.cam_radius)
        rgb, alpha, _ = self.render_gs(pose, resolution)
        rays_o, rays_d = camera.get_rays(pose, resolution, resolution,
                                         self.opt.fovy)
        sel = self.rng.integers(0, resolution * resolution, N_RAYS)
        rays_o = np.ascontiguousarray(rays_o.reshape(-1, 3)[sel])
        rays_d = np.ascontiguousarray(rays_d.reshape(-1, 3)[sel])
        idx = torch.as_tensor(sel, device=self.dev)
        gt_rgb = rgb.reshape(-1, 3)[idx]
        gt_a = alpha.reshape(-1)[idx]
        return pose, rays_o, rays_d, gt_rgb, gt_a, self.sample_points()

    def jitter(self) -> torch.Tensor:
        """The stratified jitter of one iteration, [N_RAYS, N_SAMPLES]
        uniform in [0, 1), from the device generator."""
        return torch.rand((N_RAYS, N_SAMPLES), generator=self.jitter_gen,
                          device=self.dev)

    def nerf_step(self, field: NerfField, optim, grid: OccupancyGrid,
                  rays_o, rays_d, gt_rgb, gt_a, pts3d,
                  jitter) -> torch.Tensor:
        """One Adam step of the NeRF fit (``lgm_tpu/convert.py:179-204``):
        the photometric terms on the rays, the log-density and colour terms
        against ``mixture_field`` at ``pts3d``. Returns the loss."""
        dev = self.dev
        rays_o, rays_d, pts3d = (torch.as_tensor(a, device=dev)
                                 for a in (rays_o, rays_d, pts3d))
        sig_gt, rgb_gt, wsum = mixture_field(self._gaussians, pts3d)
        out = render_rays(rays_o, rays_d, field, grid,
                          num_samples=N_SAMPLES, jitter=jitter)
        rgb = out["rgb"] + (1.0 - out["alpha"][:, None])  # white bg
        l_photo = (torch.mean((rgb - gt_rgb) ** 2)
                   + torch.mean((out["alpha"] - gt_a) ** 2))
        sig_p, rgb_p = field(pts3d)
        l_sigma = torch.mean((torch.log1p(sig_p) - torch.log1p(sig_gt)) ** 2)
        cw = torch.clamp_max(wsum, 1.0)[:, None]
        l_col = torch.mean(cw * (rgb_p - rgb_gt) ** 2)
        loss = l_photo + l_sigma + l_col
        optim.zero_grad(set_to_none=True)
        loss.backward()
        optim.step()
        return loss.detach()

    def fit_nerf(self, iters: int = 512, resolution: int = 128,
                 lr: float = 1e-2, log_every: int = 128):
        """(ref: convert.py:186-224) From ``new_field()``. The occupancy
        grid (64³) is updated every 32 iterations at density 1.0."""
        field = self.new_field()
        grid = OccupancyGrid.dense(64, aabb=1.0, device=self.dev)
        optim = adam(field.parameters(), lr)
        losses = []
        for it in range(iters):
            _, rays_o, rays_d, gt_rgb, gt_a, pts3d = self.nerf_batch(
                resolution)
            losses.append(self.nerf_step(field, optim, grid, rays_o, rays_d,
                                         gt_rgb, gt_a, pts3d, self.jitter()))
            if (it + 1) % 32 == 0:  # periodic occupancy update
                grid = grid.update(lambda pts: field(pts)[0], threshold=1.0)
            if (it + 1) % log_every == 0:
                print(f"[fit_nerf] iter {it + 1}/{iters} loss "
                      f"{float(losses[-1]):.5f}")
        self.losses["nerf"] = torch.stack(losses).tolist() if losses else []
        self.nerf_optim = optim
        self.field = field.requires_grad_(False).eval()
        self.grid = grid
        return self

    def query_field(self, pts: np.ndarray):
        with torch.no_grad():
            sigma, rgb = self.field(torch.as_tensor(
                np.asarray(pts, np.float32), device=self.dev))
        return sigma.cpu().numpy(), rgb.cpu().numpy()

    # ------------------------------------------------------------------
    # Stage 2: mesh extraction + geometry fit
    # ------------------------------------------------------------------

    def density_grid(self, grid_resolution: int = 192) -> np.ndarray:
        """The field's density at the [n, n, n] grid over [-1, 1]^3,
        queried in 64 chunks."""
        n = grid_resolution
        xs = np.linspace(-1, 1, n, dtype=np.float32)
        X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
        pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
        sig = np.concatenate(
            [self.query_field(c)[0] for c in np.array_split(pts, 64)])
        return sig.reshape(n, n, n)

    def extract_mesh(self, grid_resolution: int = 192,
                     density_thresh: float = 10.0,
                     target_faces: int = 50_000):
        """(ref: convert.py:268-296; 5e4 face target)"""
        n = grid_resolution
        verts, faces = native.marching_cubes(self.density_grid(n),
                                             density_thresh)
        if len(faces) == 0:
            raise RuntimeError(
                f"the field has no surface at density {density_thresh}: "
                "fit_nerf has not run long enough")
        verts = verts / (n - 1) * 2.0 - 1.0  # grid -> world [-1, 1]
        verts, faces = native.clean(verts, faces, eps=1e-4)
        verts, faces = native.decimate_to_target(verts, faces, target_faces)
        self.verts, self.faces = verts, faces
        print(f"[extract_mesh] {len(verts)} verts, {len(faces)} faces")
        return self

    def laplacian_edges(self):
        """Both directions of every face edge as (neighbour, vertex) index
        tensors, and each vertex's degree clamped at 1."""
        e = np.concatenate([self.faces[:, [0, 1]], self.faces[:, [1, 2]],
                            self.faces[:, [2, 0]]])
        e = np.concatenate([e, e[:, ::-1]])
        nbr_idx = torch.as_tensor(e[:, 1], dtype=torch.int64, device=self.dev)
        nbr_seg = torch.as_tensor(e[:, 0], dtype=torch.int64, device=self.dev)
        deg = torch.zeros(len(self.verts), device=self.dev).index_add_(
            0, nbr_seg, torch.ones(len(e), device=self.dev))
        return nbr_idx, nbr_seg, torch.clamp_min(deg, 1.0)

    def mesh_step(self, offsets, optim, verts0, faces, edges, vp, gt_rgb,
                  gt_a, resolution, lap_weight, off_weight) -> torch.Tensor:
        """One Adam step of the vertex offsets
        (``lgm_tpu/convert.py:331-358``). The Laplacian's neighbour sums are
        ``index_add_``, whose atomics on CUDA change the last bits from run
        to run."""
        nbr_idx, nbr_seg, deg = edges
        v = verts0 + offsets
        _, rgb = self.field(v)
        out, mask = render_mesh(v, faces, rgb,
                                torch.as_tensor(vp, device=self.dev),
                                resolution)
        maskf = mask.to(torch.float32)
        img = out + (1.0 - maskf[..., None])  # white bg
        l_img = torch.mean((img - gt_rgb) ** 2)
        l_mask = torch.mean((maskf - gt_a) ** 2)
        nbr_mean = torch.zeros_like(v).index_add_(0, nbr_seg,
                                                  v[nbr_idx]) / deg[:, None]
        l_lap = torch.mean(torch.sum((v - nbr_mean) ** 2, -1))
        l_off = torch.mean(torch.sum(offsets ** 2, -1))
        loss = l_img + l_mask + lap_weight * l_lap + off_weight * l_off
        optim.zero_grad(set_to_none=True)
        loss.backward()
        optim.step()
        return loss.detach()

    def fit_mesh(self, iters: int = 256, resolution: int = 256,
                 lr: float = 1e-3, lap_weight: float = 0.1,
                 off_weight: float = 0.1, log_every: int = 64):
        """Optimize vertex offsets against GS renders
        (ref: convert.py:302-349)."""
        verts0 = torch.as_tensor(self.verts, device=self.dev)
        faces = torch.as_tensor(self.faces, dtype=torch.int64,
                                device=self.dev)
        edges = self.laplacian_edges()
        offsets = torch.zeros_like(verts0, requires_grad=True)
        optim = adam([offsets], lr)
        losses = []
        for it in range(iters):
            pose = _orbit_pose(self.rng, self.opt.cam_radius)
            rgb, alpha, vp = self.render_gs(pose, resolution)
            losses.append(self.mesh_step(offsets, optim, verts0, faces,
                                         edges, vp, rgb, alpha, resolution,
                                         lap_weight, off_weight))
            if (it + 1) % log_every == 0:
                print(f"[fit_mesh] iter {it + 1}/{iters} loss "
                      f"{float(losses[-1]):.5f}")
        self.losses["mesh"] = torch.stack(losses).tolist() if losses else []
        self.mesh_optim = optim
        self.verts = (verts0 + offsets).detach().cpu().numpy()
        return self

    # ------------------------------------------------------------------
    # Stage 3: UV atlas + texture
    # ------------------------------------------------------------------

    def unwrap_uv(self):
        """UV atlas (xatlas replacement, ref: convert.py:370-372): the
        native chart unwrap (normal-coherent chart growing, per-chart plane
        projection, shelf packing). No fallback: a failed build raises."""
        verts, uv, faces, n_charts = native.chart_unwrap(self.verts,
                                                         self.faces)
        self.verts, self.faces, self.uv = verts, faces, uv
        self.n_charts = n_charts
        return self

    def _unwrap_uv_box(self):
        """Box-projection atlas: faces grouped by dominant normal axis
        into 6 charts packed 3x2. Vertices used by multiple charts are
        duplicated so UVs are per-corner consistent."""
        v, f = self.verts, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        axis = np.abs(fn).argmax(1)
        sign = np.take_along_axis(np.sign(fn), axis[:, None], 1)[:, 0]
        chart = axis * 2 + (sign > 0)  # 0..5

        new_index: Dict[Tuple[int, int], int] = {}
        new_verts, new_uv, new_faces = [], [], []
        proj_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
        for fi in range(len(f)):
            c = int(chart[fi])
            a0, a1 = proj_axes[c // 2]
            tri = []
            for vi in f[fi]:
                key = (int(vi), c)
                if key not in new_index:
                    new_index[key] = len(new_verts)
                    new_verts.append(v[vi])
                    new_uv.append([v[vi][a0], v[vi][a1], c])
                tri.append(new_index[key])
            new_faces.append(tri)

        verts = np.asarray(new_verts, np.float32)
        uv_raw = np.asarray(new_uv, np.float32)
        faces = np.asarray(new_faces, np.int32)

        # Normalize each chart to its cell in a 3x2 atlas with margins.
        uv = np.zeros((len(verts), 2), np.float32)
        for c in range(6):
            m = uv_raw[:, 2] == c
            if not m.any():
                continue
            p = uv_raw[m, :2]
            lo, hi = p.min(0), p.max(0)
            p = (p - lo) / np.maximum(hi - lo, 1e-6)
            cell_x, cell_y = c % 3, c // 3
            uv[m, 0] = (cell_x + 0.05 + 0.9 * p[:, 0]) / 3.0
            uv[m, 1] = (cell_y + 0.05 + 0.9 * p[:, 1]) / 2.0

        self.verts, self.faces, self.uv = verts, faces, uv
        return self

    def bake_texture(self, tex_size: int) -> np.ndarray:
        """The initial texture: 0.5 grey with each vertex's field colour
        written at ``uv * tex_size`` (truncated, clamped)."""
        _, vcol = self.query_field(self.verts)
        tex = np.full((tex_size, tex_size, 3), 0.5, np.float32)
        ti = np.clip((self.uv * tex_size).astype(np.int64), 0, tex_size - 1)
        tex[ti[:, 1], ti[:, 0]] = vcol
        return tex

    def texture_step(self, tex, optim, verts, faces, uv, vp, gt_rgb,
                     resolution) -> torch.Tensor:
        """One Adam step of the texture (``lgm_tpu/convert.py:472-483``)."""
        uv_img, mask = render_mesh(verts, faces, uv,
                                   torch.as_tensor(vp, device=self.dev),
                                   resolution)
        rgb = tex_sample(tex, uv_img)
        img = torch.where(mask[..., None], rgb, 1.0)
        loss = torch.mean((img - gt_rgb) ** 2)
        optim.zero_grad(set_to_none=True)
        loss.backward()
        optim.step()
        return loss.detach()

    def fit_texture(self, iters: int = 128, tex_size: int = 1024,
                    resolution: int = 256, lr: float = 1e-2,
                    log_every: int = 64):
        """Bake albedo from the NeRF color field, then optimize against
        front-biased GS renders (ref: convert.py:364-442)."""
        if self.uv is None:
            self.unwrap_uv()
        verts = torch.as_tensor(self.verts, device=self.dev)
        faces = torch.as_tensor(self.faces, dtype=torch.int64,
                                device=self.dev)
        uv = torch.as_tensor(self.uv, device=self.dev)
        tex = torch.tensor(self.bake_texture(tex_size), device=self.dev,
                           requires_grad=True)
        optim = adam([tex], lr)
        losses = []
        for it in range(iters):
            pose = _orbit_pose(self.rng, self.opt.cam_radius,
                               front_bias=True)
            rgb, _, vp = self.render_gs(pose, resolution)
            losses.append(self.texture_step(tex, optim, verts, faces, uv, vp,
                                            rgb, resolution))
            if (it + 1) % log_every == 0:
                print(f"[fit_texture] iter {it + 1}/{iters} loss "
                      f"{float(losses[-1]):.5f}")
        self.losses["texture"] = (torch.stack(losses).tolist() if losses
                                  else [])
        self.texture_optim = optim
        self.texture = np.clip(tex.detach().cpu().numpy(), 0, 1)
        return self

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def export(self, path: str):
        from lgm_tpu_torch.io.mesh import export_glb, export_obj

        assert self.verts is not None and self.faces is not None
        if path.endswith(".glb"):
            export_glb(path, self.verts, self.faces, self.uv, self.texture)
        else:
            export_obj(path, self.verts, self.faces, self.uv, self.texture)
        print(f"[export] wrote {path}")
        return self

    def run(self, out_path: str, nerf_iters: int = 512,
            mesh_iters: int = 256, tex_iters: int = 128,
            grid_resolution: int = 192, target_faces: int = 50_000):
        """Full pipeline (ref: convert.py:458-462)."""
        self.fit_nerf(iters=nerf_iters)
        self.extract_mesh(grid_resolution=grid_resolution,
                          target_faces=target_faces)
        self.fit_mesh(iters=mesh_iters)
        self.unwrap_uv()
        self.fit_texture(iters=tex_iters)
        self.export(out_path)
        return self


def main(argv=None):
    from lgm_tpu_torch.io.ply import load_ply

    parser = argparse.ArgumentParser(description="gaussians -> glb mesh")
    parser.add_argument("config", nargs="?", default="big",
                        choices=sorted(CONFIGS))
    parser.add_argument("--test-path", required=True,
                        help="input .ply of packed gaussians")
    parser.add_argument("--out", default=None)
    parser.add_argument("--nerf-iters", type=int, default=512)
    parser.add_argument("--mesh-iters", type=int, default=256)
    parser.add_argument("--tex-iters", type=int, default=128)
    parser.add_argument("--grid-resolution", type=int, default=192)
    parser.add_argument("--device", type=str, default="cuda")
    ns = parser.parse_args(argv)
    opt = CONFIGS[ns.config]
    g = load_ply(ns.test_path)
    out = ns.out or os.path.splitext(ns.test_path)[0] + ".glb"
    Converter(opt, g, device=ns.device).run(
        out, nerf_iters=ns.nerf_iters, mesh_iters=ns.mesh_iters,
        tex_iters=ns.tex_iters, grid_resolution=ns.grid_resolution,
    )


if __name__ == "__main__":
    main()
