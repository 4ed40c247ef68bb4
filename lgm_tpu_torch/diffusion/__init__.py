"""The MVDream / ImageDream diffusion front-end (port of
``lgm_tpu.diffusion``'s inference modules): ``pipeline`` (configs and the
sampler), ``mv_unet``, ``vae``, ``clip``, ``tokenizer``, ``ddim``."""
