"""Tracing and timing (counterpart of nasa_niswan_tpu/utils/profiling.py).

  * ``trace(logdir)``: ``torch.profiler`` over the enclosed block (the CPU,
    and the card's kernels where one is visible), written to
    ``<logdir>/trace.json`` as a Chrome trace (Perfetto opens it).
  * ``device_sync``: waits for the device of a tree's first tensor.
  * ``StepTimer``: the sustained step-time / model-days-per-min meter, one
    reading per window of ``sync_every`` ticks: CUDA events on the card
    (device time between the windows' ends), ``perf_counter`` on the CPU.
  * ``layer_summary``: the torchsummary-style parameter table, line for line
    the JAX package's for the same parameter tree.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nasa_niswan_tpu_torch.bridge import tree_leaves, tree_paths


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; the trace goes to ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(x: Any) -> Optional[torch.Tensor]:
    return next((t for t in tree_leaves(x) if isinstance(t, torch.Tensor)), None)


def device_sync(x: Any) -> None:
    """Wait until the work queued on the device of ``x``'s first tensor is
    done (a tree of tensors; nothing to wait for on the CPU)."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Sustained throughput meter for the training and rollout loops.

    >>> timer = StepTimer(steps_per_day=48)
    >>> for batch in batches:
    ...     out = step(...)
    ...     timer.tick(out, n_steps=seq_len, batch=B)
    >>> timer.summary()
    """

    def __init__(self, steps_per_day: int = 48, sync_every: int = 10):
        self.steps_per_day = steps_per_day
        self.sync_every = sync_every
        self._mark = None  # the last window's end: a CUDA event or perf_counter
        self._model_steps = 0.0
        self._ticks = 0
        self.records: List[Dict[str, float]] = []

    def _now(self, out: Any):
        t = _first_tensor(out)
        if t is not None and t.is_cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(t.device))
            event.synchronize()
            return event
        return time.perf_counter()

    def tick(self, out: Any, *, n_steps: int, batch: int = 1) -> None:
        self._ticks += 1
        self._model_steps += n_steps * batch
        if self._ticks % self.sync_every:
            return
        now = self._now(out)
        if self._mark is not None:
            if isinstance(now, torch.cuda.Event):
                elapsed = self._mark.elapsed_time(now) / 1000.0
            else:
                elapsed = now - self._mark
            days = self._model_steps / self.steps_per_day
            self.records.append({"elapsed_s": elapsed, "model_days": days,
                                 "model_days_per_min": days / (elapsed / 60.0)})
        self._mark = now
        self._model_steps = 0.0

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {"model_days_per_min": float("nan"), "windows": 0}
        rates = [r["model_days_per_min"] for r in self.records]
        return {
            "model_days_per_min": float(np.mean(rates)),
            "best": float(np.max(rates)),
            "windows": len(self.records),
        }


def layer_summary(params: Any) -> str:
    """Parameter table over a parameter tree (torchsummary analog,
    test.ipynb cell 58): one row per leaf with path, shape, count."""
    rows = []
    total = 0
    for name, leaf in zip(tree_paths(params), tree_leaves(params)):
        shape = tuple(int(s) for s in leaf.shape)
        n = int(np.prod(shape)) if shape else 1
        total += n
        rows.append((name, shape, n))
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'layer':<{width}}{'shape':<24}{'params':>12}"]
    lines.append("-" * (width + 36))
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    lines.append("-" * (width + 36))
    lines.append(f"{'total':<{width}}{'':<24}{total:>12,}")
    return "\n".join(lines)
