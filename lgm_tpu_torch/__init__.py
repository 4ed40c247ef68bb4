"""lgm_tpu_torch — the PyTorch/CUDA port of ``lgm_tpu`` for NVIDIA Hopper.

A second package beside ``lgm_tpu`` (the JAX/TPU reference, which it never
imports): the same modules under the same names, in PyTorch, with a kernel
written by hand in CUDA C++ for ``sm_90a`` wherever ``lgm_tpu`` wrote a
Pallas kernel. This slice covers LGM inference:

- ``config``         Options + presets (copy of ``lgm_tpu.config``)
- ``utils.camera``   orbit poses, Plücker rays, rasterizer cameras (numpy)
- ``io.ply``         PLY import/export
- ``models``         the multi-view U-Net and the LGM forward (NCHW)
- ``ops.mha``        cross-view attention, kernel K1 (``csrc/mha_fwd.cu``)
- ``ops.gsplat``     projection, flatsort binning, kernel K2
                     (``gsplat/csrc/composite_fwd.cu``) and the oracle
- ``weights``        reference state dicts and Flax parameter trees
- ``infer``          images -> Gaussians -> .ply + orbit frames

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper takes its plain PyTorch version; on
a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
