"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor lgm_tpu, so it runs on a host with only PyTorch
and the CUDA toolkit (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from lgm_tpu_torch.ops.gsplat import flatsort as fs
from lgm_tpu_torch.ops.mha import mha_fwd, mha_reference

pytestmark = pytest.mark.gpu

FOVY = 49.1
TAN = float(np.tan(0.5 * np.deg2rad(FOVY)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("S,D", [(256, 32), (512, 64), (4096, 32)])
def test_mha_fwd_kernel_matches_plain(cuda, S, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, (3, S, D)),
                               dtype=torch.float32, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = mha_fwd.launches
    with torch.inference_mode():
        o = mha_fwd(q, k, v, D ** -0.5)
        ref = mha_reference(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 1
    # Two bf16 rounding steps of the output scale (different sum orders).
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err


def test_mha_fwd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 64, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(x, x, x, 1.0)  # D = 48
    y = torch.zeros(1, 64, 32, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(y, y, y, 1.0)  # f32
    z = torch.zeros(1, 64, 32, dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    with pytest.raises(NotImplementedError):
        mha_fwd(z, z, z, 1.0)


@pytest.mark.parametrize("tile", [(32, 32), (8, 32)])
def test_composite_fwd_kernel_matches_plain(cuda, tile):
    th, tw = tile
    rng = np.random.default_rng(4)
    n, S = 3000, 128
    g = np.zeros((n, 14), np.float32)
    g[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    g[:, 3] = rng.uniform(0.2, 1.0, n)
    g[:, 4:7] = rng.uniform(0.01, 0.08, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = rng.uniform(0, 1, (n, 3))
    from lgm_tpu_torch.utils import camera

    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    for with_depth in (True, False):
        with torch.inference_mode():
            params, counts = fs._prepare_view(
                torch.as_tensor(g, device=cuda),
                torch.as_tensor(view, device=cuda), S, TAN, 1.0, th, tw, 16,
                512, with_depth)
            args = (params, counts, th, tw, S // tw)
            out = fs.composite_fwd(*args)
            ref = fs.composite_reference(*args)
        torch.cuda.synchronize()
        assert int(counts.max()) > 128  # several chunks per tile
        # f32 order + the 1e-4 early-out flipping at its threshold.
        assert (out - ref).abs().max().item() <= 1e-3
