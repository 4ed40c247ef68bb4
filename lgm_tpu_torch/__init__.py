"""lgm_tpu_torch — the PyTorch/CUDA port of ``lgm_tpu`` for NVIDIA Hopper.

A second package beside ``lgm_tpu`` (the JAX/TPU reference, which it never
imports): the same modules under the same names, in PyTorch, with a kernel
written by hand in CUDA C++ for ``sm_90a`` wherever ``lgm_tpu`` wrote a
Pallas kernel. It covers LGM inference from four views or from one image
(the MVDream / ImageDream front-end), training on synthetic or disk
data, on one GPU or several, and the finetune of the diffusion U-Net:

- ``config``         Options + presets (copy of ``lgm_tpu.config``)
- ``utils.camera``   orbit poses, Plücker rays, rasterizer cameras (numpy)
- ``utils.image``, ``utils.resize``  recentring, compositing, OpenCV's
                     linear / cubic / area resizes (numpy)
- ``utils.logging``  JSONL metrics (+ TensorBoard), image grids
- ``diffusion``      the multi-view diffusion pipeline: MV-U-Net (K1 at
                     its joint self-attention), VAE, CLIP towers and BPE
                     tokenizer, DDIM; its finetune (``diffusion.train``:
                     DDPM ε-loss, CFG dropout, EMA; ``diffusion.data``:
                     synthetic and LVIS frames)
- ``io.ply``         PLY import/export
- ``io.png``         PNG reader and writer (scanline unfilter in host C++,
                     ``data/csrc/png_unfilter.cpp``)
- ``data.synthetic`` seeded scenes and poses, views rendered on the device
- ``data.decode``    PNG views -> white-background composite, two resizes
- ``data.provider``  Objaverse / LVIS datasets, the worker-process loader
- ``utils.augment``  grid distortion and camera jitter (numpy)
- ``parallel.dist``  dp x vp worlds under torchrun, ZeRO-1 slices
- ``models``         the multi-view U-Net, the LGM forward and its loss
                     graph, LPIPS (NCHW)
- ``ops.mha``        cross-view attention, kernels K1 and K1ᵇ
                     (``csrc/mha_fwd_wgmma.cu``, ``csrc/mha_bwd_wgmma.cu``)
- ``ops.gsplat``     projection, flatsort binning, kernels K2 and K2ᵇ
                     (``gsplat/csrc/composite_{fwd,bwd}.cu``), the oracle
- ``weights``        reference state dicts and Flax parameter trees
                     (LGM and the diffusion pipeline; lgm_tpu's finetune
                     state)
- ``infer``          one image or four views -> Gaussians -> .ply + orbit
                     frames
- ``train``          AdamW training loop (DDP, ZeRO-1), checkpoints, resume;
                     ``Optimizer`` over any optax-style AdamW chain

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper takes its plain PyTorch version; on
a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
