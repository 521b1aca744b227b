"""Determinism helpers (counterpart of nasa_niswan_tpu/utils/seeding.py).

The reference seeds python, numpy and torch (utils.py:77-88).  Where the
JAX package returns the root PRNG key, the port returns a
``torch.Generator``: its random draws (dropout, the init's) take one
explicitly, never the global generator.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_rng(seed: int = 0, *, device) -> torch.Generator:
    """Seed python's, numpy's and torch's global generators (every device's)
    and return a generator on ``device`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
