"""The closed loop that every runner's window runs.

One unit of work (a chunk, a call, a training step) is dispatched after
another.  On a card the loop waits, after dispatching unit n, for unit n-1
to finish: the device always has the next unit queued, and the host never
runs more than one unit ahead.  The window ends after the unit that
crosses ``seconds`` (or after ``count`` units) and a synchronize, so its
wall time holds all the work it dispatched.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import record_function


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(unit: Callable[[int], None], device: torch.device, *,
                seconds: Optional[float] = None, count: Optional[int] = None,
                span: str = "bench.unit") -> Tuple[int, float]:
    """Run ``unit(i)`` for i = 0, 1, ... ; returns (units, wall seconds)."""
    if seconds is None and count is None:
        raise ValueError("give seconds or count")
    cuda = device.type == "cuda"
    sync(device)
    t0 = time.perf_counter()
    n, prev = 0, None
    while True:
        with record_function(span):
            unit(n)
        n += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            if prev is not None:
                with record_function("bench.wait"):
                    prev.synchronize()
            prev = ev
        if count is not None and n >= count:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - t0
