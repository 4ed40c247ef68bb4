"""Shared fixtures of the benchmark's CPU tests: small sizes of each cell.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def nano_options(**over) -> dict:
    """The program's ``nano`` preset as a configuration's ``options``."""
    from lgm_tpu_torch.config import CONFIGS

    opts = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(CONFIGS["nano"]).items()}
    opts.update(over)
    return opts


# Each cell at a size a CPU test holds: the nano preset (four input views
# where the inference path needs them) and a few small objects.
SMALL = {
    "lgm-big.train-bs8": (dict(), {"batches": 2, "scene_gaussians": 256,
                                   "check_steps": 2}),
    "lgm-big.object-orbit": (dict(num_input_views=4),
                             {"objects": 2, "scene_gaussians": 256,
                              "frames": 4, "chunk": 2}),
}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
