"""DDIM scheduler (deterministic sampler), numpy.

The package's own copy of ``lgm_tpu/diffusion/ddim.py`` (diffusers'
DDIMScheduler as the reference pipeline configures it, ref:
mvdream/pipeline_mvdream.py:38,461-462,534-536): scaled-linear betas
0.00085..0.012 over 1000 steps, epsilon prediction, leading timestep
spacing plus ``steps_offset`` 1, ``set_alpha_to_one=False``, no clipping.
``step`` and ``add_noise`` take numpy arrays; the pipeline's own loop
runs on the device from ``step_arrays``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"

    init_noise_sigma: float = 1.0
    timesteps: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        T = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5, T,
                                dtype=np.float64) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, T,
                                dtype=np.float64)
        else:
            raise ValueError(self.beta_schedule)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self.final_alpha_cumprod = (
            np.float32(1.0) if self.set_alpha_to_one
            else self.alphas_cumprod[0])
        self.timesteps = np.arange(T)[::-1].copy()

    def set_timesteps(self, num_inference_steps: int):
        """'leading' spacing with offset (diffusers' default for SD)."""
        step = self.num_train_timesteps // num_inference_steps
        self.timesteps = (
            (np.arange(num_inference_steps) * step).round()[::-1]
            .astype(np.int64) + self.steps_offset)
        self.num_inference_steps = num_inference_steps

    def step_arrays(self):
        """The denoising loop's per-step values, from the host: timesteps
        (int64) and the alpha-bar of each step and of the step after it
        (f32; ``final_alpha_cumprod`` past the end)."""
        steps = np.asarray(self.timesteps, np.int64)
        prev = steps - self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[steps].astype(np.float32)
        a_prev = np.where(prev >= 0,
                          self.alphas_cumprod[np.maximum(prev, 0)],
                          self.final_alpha_cumprod).astype(np.float32)
        return steps, a_t, a_prev

    def step(self, model_output, t: int, sample, eta: float = 0.0,
             noise=None):
        """One DDIM update x_t -> x_{t-1} (``noise`` needed for eta > 0)."""
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[t]
        a_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                  else self.final_alpha_cumprod)

        if self.prediction_type == "epsilon":
            x0 = (sample - np.sqrt(1 - a_t) * model_output) / np.sqrt(a_t)
            eps = model_output
        elif self.prediction_type == "v_prediction":
            x0 = np.sqrt(a_t) * sample - np.sqrt(1 - a_t) * model_output
            eps = np.sqrt(a_t) * model_output + np.sqrt(1 - a_t) * sample
        else:
            raise ValueError(self.prediction_type)

        sigma = eta * np.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        prev = np.sqrt(a_prev) * x0 + np.sqrt(1 - a_prev - sigma**2) * eps
        if eta > 0:
            if noise is None:
                raise ValueError("DDIM step with eta > 0 needs noise")
            prev = prev + sigma * noise
        return prev

    def add_noise(self, sample, noise, t):
        a = self.alphas_cumprod[np.asarray(t)]
        while a.ndim < sample.ndim:
            a = a[..., None]
        return np.sqrt(a) * sample + np.sqrt(1 - a) * noise
