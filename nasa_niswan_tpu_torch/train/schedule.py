"""Learning-rate schedules (counterpart of nasa_niswan_tpu/train/schedule.py).

The reference uses torch StepLR (train.py:72): lr is multiplied by gamma
every ``step_size`` epochs, stepping at epoch boundaries.
"""

from __future__ import annotations


def step_lr(base_lr: float, step_size: float, gamma: float, epoch_index: int) -> float:
    """LR for 0-based ``epoch_index`` under StepLR(step_size, gamma): epochs
    [0, step) run at base_lr, [step, 2*step) at base_lr*gamma, etc.
    ``step_size`` arrives as float from the CLI and is truncated."""
    return base_lr * gamma ** (epoch_index // int(step_size))
