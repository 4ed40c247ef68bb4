"""The port's diffusion finetune (lgm_tpu_torch/diffusion/train.py)
against lgm_tpu's trainer on the CPU, MVDream's tiny config in f32, both
started from one state (lgm_tpu's, carried across by
weights.diffusion_train_state_to_torch, the zero leaves of the U-Net
filled so that every layer has a gradient), on the same host batch and
seed: prepare_batch, the U-Net gradients, two steps (the first at lr 0),
and a checkpoint of lgm_tpu's converted by scripts/dckpt_to_torch.py and
continued one step in the port.

Tolerances. The host draws (noise, t, the dropout, the camera rows) are
equal bit for bit; what the frozen encoders make (latents, context) to
f32 rounding: 1e-5 of its scale. Loss and gradient norm: 1e-5 relative.
Gradients: 1e-4 of each leaf's largest |value| + 1e-7 (the floor is f32
noise: a ResBlock's time-embedding bias has no gradient when its
GroupNorm holds one channel a group, and both sides compute ~1e-10
there). Parameters and the EMA after the steps: 1e-5 relative + 2e-7 +
Σlr / 4 (Adam steps each element by about lr, so a gradient element
computed to a relative error e, or a bf16 first moment that rounds to
the other neighbour, moves it e·lr apart; at most 0.1 lr here),
except where a gradient is f32 noise and Adam's g/|g| may turn either way
(at most 0.1% of the elements, each within 2 Σlr). Adam's bf16 first
moment to two bf16 steps of each leaf's scale + 1e-7, the f32 second
moment to 1e-4 of its scale + 1e-13."""

import numpy as np
import pytest

from diffusion_twins import (LR, check_gradients, check_prepare_batch,
                             check_states, check_steps, run_twins)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_twins("tiny-test", 0.5, tmp_path_factory.mktemp("dckpt"))


def test_prepare_batch_matches_lgm_tpu(run):
    check_prepare_batch(run)


def test_gradients_match_lgm_tpu(run):
    check_gradients(run)


def test_two_steps_match_lgm_tpu(run):
    check_steps(run)


def test_lgm_tpu_checkpoint_continues_in_the_port(run):
    """lgm_tpu's dckpt_2 (orbax) -> scripts/dckpt_to_torch.py -> a fresh
    port trainer's --resume: one more step matches lgm_tpu's next."""
    assert run["restored_step"] == 2
    jm, tm = run["step3"]
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    check_states(run["state3"], run["jax_state3"], 2 * LR, "step 3")
