"""Mesh-converter quality on a known shape, through the PyTorch port.

The port's counterpart of ``scripts/eval_convert_quality.py``: a torus (or
a cross of three capsules) of Gaussians with an analytic surface goes
through ``lgm_tpu_torch.convert.Converter`` (hash-grid NeRF distillation
-> marching cubes -> clean/decimate -> vertex fit -> chart UV unwrap ->
texture bake and fit), and the script reports:

  - chamfer distance between the mesh surface and the analytic surface,
    in scene units (the object spans about [-0.55, 0.55]);
  - PSNR of the textured mesh's render against the Gaussian render at
    held-out poses.

It prints one JSON row with the keys of ``benchmarks/
convert_quality_torus.jsonl`` plus ``device`` and ``card`` (the card's
name and power limit as ``nvidia-smi`` gives them; null on the CPU), and
appends it to ``--out`` when given. The shape builders, surface samplers
and budgets are this script's own copy; it imports only
``lgm_tpu_torch``, numpy and scipy.

Run: python scripts/eval_convert_quality_torch.py --shape torus
         --budget reference [--device cuda] [--out rows.jsonl]
     (small CPU runs: --device cpu --n-gaussians 1000 --nerf-iters 16
      --mesh-iters 2 --tex-iters 2 --grid 40 --n-rays 256 --size 64
      --tex-size 128)
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

R_MAJ, R_MIN = 0.4, 0.16
# Concave test shape: the union of three orthogonal capsules (creases
# where they meet are concave, unlike the smooth torus).
CAP_L, CAP_R = 0.35, 0.13


def torus_gaussians(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    r = R_MIN * np.sqrt(rng.uniform(0, 1, n))  # volume fill
    cx = (R_MAJ + r * np.cos(v)) * np.cos(u)
    cy = r * np.sin(v)
    cz = (R_MAJ + r * np.cos(v)) * np.sin(u)
    g = np.zeros((n, 14), np.float32)
    g[:, 0] = cx
    g[:, 1] = cy
    g[:, 2] = cz
    g[:, 3] = 0.95
    g[:, 4:7] = 0.035
    g[:, 7] = 1.0
    # Angular colour stripes: texture signal for the bake stage.
    g[:, 11] = 0.5 + 0.45 * np.sin(3 * u)
    g[:, 12] = 0.5 + 0.45 * np.cos(2 * u + v)
    g[:, 13] = 0.5 + 0.45 * np.sin(2 * v)
    return g


def torus_sdf(p):
    q = np.stack([np.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2) - R_MAJ, p[:, 1]], 1)
    return np.linalg.norm(q, axis=1) - R_MIN


def _capsule_sdf(p, axis):
    ax = np.clip(p[:, axis], -CAP_L, CAP_L)
    q = p.copy()
    q[:, axis] -= ax
    return np.linalg.norm(q, axis=1) - CAP_R


def cross_sdf(p):
    return np.minimum(
        np.minimum(_capsule_sdf(p, 0), _capsule_sdf(p, 1)),
        _capsule_sdf(p, 2))


def cross_gaussians(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 14), np.float32)
    axis = rng.integers(0, 3, n)
    t = rng.uniform(-CAP_L, CAP_L, n)
    r = CAP_R * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    for a in range(3):
        m = axis == a
        o1, o2 = (a + 1) % 3, (a + 2) % 3
        g[m, a] = t[m]
        g[m, o1] = r[m] * np.cos(th[m])
        g[m, o2] = r[m] * np.sin(th[m])
    g[:, 3] = 0.95
    g[:, 4:7] = 0.035
    g[:, 7] = 1.0
    g[:, 11] = 0.5 + 0.45 * np.sin(6 * g[:, 0])
    g[:, 12] = 0.5 + 0.45 * np.cos(6 * g[:, 1])
    g[:, 13] = 0.5 + 0.45 * np.sin(6 * g[:, 2])
    return g


def cross_surface_points(n=20000, seed=1):
    """Rejection-sample the union's surface: points on one capsule's
    surface that lie inside another capsule are interior, not surface."""
    rng = np.random.default_rng(seed)
    pts = []
    while sum(len(x) for x in pts) < n:
        m = 4 * n
        axis = rng.integers(0, 3, m)
        t = rng.uniform(-CAP_L, CAP_L, m)
        th = rng.uniform(0, 2 * np.pi, m)
        p = np.zeros((m, 3), np.float32)
        for a in range(3):
            k = axis == a
            o1, o2 = (a + 1) % 3, (a + 2) % 3
            p[k, a] = t[k]
            p[k, o1] = CAP_R * np.cos(th[k])
            p[k, o2] = CAP_R * np.sin(th[k])
        keep = np.abs(cross_sdf(p)) < 1e-4
        pts.append(p[keep])
    return np.concatenate(pts)[:n]


def torus_surface_points(n=20000, seed=1):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    return np.stack(
        [(R_MAJ + R_MIN * np.cos(v)) * np.cos(u), R_MIN * np.sin(v),
         (R_MAJ + R_MIN * np.cos(v)) * np.sin(u)], 1,
    ).astype(np.float32)


def sample_mesh_surface(verts, faces, n=20000, seed=2):
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    fi = rng.choice(len(faces), n, p=areas / areas.sum())
    a, b = rng.uniform(0, 1, (2, n))
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    t = tri[fi]
    return (t[:, 0] * (1 - a - b)[:, None] + t[:, 1] * a[:, None]
            + t[:, 2] * b[:, None]).astype(np.float32)


SHAPES = {
    # extent = the largest span, for the %-of-extent normalisation.
    "torus": (torus_gaussians, torus_sdf, torus_surface_points,
              2 * (R_MAJ + R_MIN)),
    "cross": (cross_gaussians, cross_sdf, cross_surface_points,
              2 * (CAP_L + CAP_R)),
}

# (nerf_iters, mesh_iters, tex_iters, grid_resolution). "reference" is the
# reference pipeline's budget: a 512-iteration NeRF distillation, a
# 2048-iteration vertex fit, a 512-iteration texture fit and a 256-grid
# extraction (ref: convert.py:186-224, 263-361, 364-442).
BUDGETS = {
    "quick": (128, 96, 64, 128),
    "default": (384, 256, 128, 192),
    "reference": (512, 2048, 512, 256),
}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def evaluate(shape="torus", budget="default", lap=0.1, device="cuda",
             n_gaussians=6000, iters=None, grid=None, n_rays=None,
             size=256, tex_size=1024):
    """One converter run on ``shape`` and its scores: the JSON row.
    ``iters`` (nerf, mesh, texture) and ``grid`` override the budget's;
    ``n_rays`` the NeRF batch (``convert.N_RAYS``); ``size`` is that of
    the teacher views of the mesh and texture fits and of the held-out
    renders, ``tex_size`` the texture's (the converter's defaults and
    lgm_tpu's script: 256 and 1024)."""
    import torch
    from scipy.spatial import cKDTree

    from lgm_tpu_torch import convert
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.trirast import render_mesh, texture
    from lgm_tpu_torch.utils import camera

    opt = CONFIGS["small"]
    make_g, sdf_fn, surface_fn, extent = SHAPES[shape]
    nerf_iters, mesh_iters, tex_iters, grid_res = BUDGETS[budget]
    if iters is not None:
        nerf_iters, mesh_iters, tex_iters = iters
    grid_res = grid or grid_res
    if n_rays is not None:
        convert.N_RAYS = n_rays
    views = 4 if budget == "quick" else 8

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    g = make_g(n_gaussians)
    sync()
    t0 = time.time()
    conv = convert.Converter(opt, g, device=device)
    conv.fit_nerf(iters=nerf_iters, log_every=64)
    conv.extract_mesh(grid_resolution=grid_res, density_thresh=10.0)
    conv.fit_mesh(iters=mesh_iters, resolution=size, lap_weight=lap,
                  log_every=64)
    conv.fit_texture(iters=tex_iters, tex_size=tex_size, resolution=size,
                     log_every=64)
    sync()
    fit_s = time.time() - t0

    # Chamfer: mesh samples to the analytic surface (its SDF), surface
    # samples to the nearest mesh sample.
    mesh_pts = sample_mesh_surface(conv.verts, conv.faces)
    d_mesh_to_true = np.abs(sdf_fn(mesh_pts))
    true_pts = surface_fn()
    d_true_to_mesh = cKDTree(mesh_pts).query(true_pts)[0]
    chamfer = 0.5 * (d_mesh_to_true.mean() + d_true_to_mesh.mean())

    # The textured mesh against the Gaussians at held-out poses.
    dev = conv.dev
    verts = torch.as_tensor(conv.verts, device=dev)
    faces = torch.as_tensor(conv.faces, dtype=torch.int64, device=dev)
    uv = torch.as_tensor(conv.uv, device=dev)
    tex = torch.as_tensor(conv.texture, device=dev)
    psnrs = []
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for _ in range(views):
            el = rng.uniform(-50, 50)
            az = rng.uniform(0, 360)
            pose = camera.orbit_camera(el, az, opt.cam_radius)
            gt, _, vp = conv.render_gs(pose, size)
            uv_img, mask = render_mesh(verts, faces, uv, torch.as_tensor(
                vp, device=dev), size)
            img = torch.where(mask[..., None], texture(tex, uv_img), 1.0)
            mse = float(torch.mean((img - gt) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
    return {
        "shape": shape,
        "budget": budget,
        "lap_weight": lap,
        "chamfer": float(chamfer),
        "chamfer_pct_of_extent": float(chamfer) / extent * 100,
        "psnr_mesh_vs_gs": float(np.mean(psnrs)),
        "n_faces": int(len(conv.faces)),
        "fit_seconds": fit_s,
        "device": str(dev),
        "card": card() if dev.type == "cuda" else None,
        "iters": [nerf_iters, mesh_iters, tex_iters],
        "grid": grid_res,
        "n_gaussians": n_gaussians,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="torus")
    ap.add_argument("--budget", choices=sorted(BUDGETS), default="default")
    ap.add_argument("--lap", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="append the JSON row to this file")
    small = ap.add_argument_group("small-size overrides (CPU tests)")
    small.add_argument("--n-gaussians", type=int, default=6000)
    small.add_argument("--nerf-iters", type=int, default=None)
    small.add_argument("--mesh-iters", type=int, default=None)
    small.add_argument("--tex-iters", type=int, default=None)
    small.add_argument("--grid", type=int, default=None)
    small.add_argument("--n-rays", type=int, default=None)
    small.add_argument("--size", type=int, default=256)
    small.add_argument("--tex-size", type=int, default=1024)
    args = ap.parse_args(argv)
    iters = None
    if any(x is not None for x in (args.nerf_iters, args.mesh_iters,
                                   args.tex_iters)):
        base = BUDGETS[args.budget][:3]
        iters = tuple(b if x is None else x for b, x in zip(
            base, (args.nerf_iters, args.mesh_iters, args.tex_iters)))
    row = evaluate(args.shape, args.budget, args.lap, args.device,
                   args.n_gaussians, iters, args.grid, args.n_rays,
                   args.size, args.tex_size)
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return row


if __name__ == "__main__":
    main()
