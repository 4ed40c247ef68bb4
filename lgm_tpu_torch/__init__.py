"""lgm_tpu_torch — the PyTorch/CUDA port of ``lgm_tpu`` for NVIDIA Hopper.

A second package beside ``lgm_tpu`` (the JAX/TPU reference, which it never
imports): the same modules under the same names, in PyTorch, with a kernel
written by hand in CUDA C++ for ``sm_90a`` wherever ``lgm_tpu`` wrote a
Pallas kernel. It covers LGM inference and single-GPU training:

- ``config``         Options + presets (copy of ``lgm_tpu.config``)
- ``utils.camera``   orbit poses, Plücker rays, rasterizer cameras (numpy)
- ``utils.logging``  JSONL metrics (+ TensorBoard), image grids
- ``io.ply``         PLY import/export
- ``data.synthetic`` seeded scenes and poses, views rendered on the device
- ``models``         the multi-view U-Net, the LGM forward and its loss
                     graph, LPIPS (NCHW)
- ``ops.mha``        cross-view attention, kernels K1 and K1ᵇ
                     (``csrc/mha_fwd.cu``, ``csrc/mha_bwd.cu``)
- ``ops.gsplat``     projection, flatsort binning, kernels K2 and K2ᵇ
                     (``gsplat/csrc/composite_{fwd,bwd}.cu``), the oracle
- ``weights``        reference state dicts and Flax parameter trees
- ``infer``          images -> Gaussians -> .ply + orbit frames
- ``train``          AdamW training loop, checkpoints, resume

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper takes its plain PyTorch version; on
a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
