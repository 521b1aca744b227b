"""The order in which a training epoch visits its windows, worked out
independently of the port: the windows' indices shuffled by numpy's
``default_rng(uint32(seed) + uint32(epoch))``, cut into batches, the last
partial batch dropped (the reference trainer's documented order)."""

from __future__ import annotations

from typing import List

import numpy as np


def order_seed(seed: int) -> int:
    """The run's seed as the 32-bit seed the order is drawn from."""
    return int(seed) % 2 ** 32


def batch_order(n: int, batch: int, seed: int, epoch: int) -> List[np.ndarray]:
    order = np.arange(n)
    np.random.default_rng(np.uint32(order_seed(seed)) + np.uint32(epoch)).shuffle(order)
    return [order[a:a + batch] for a in range(0, n - n % batch, batch)]
