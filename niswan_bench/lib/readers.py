"""Arithmetic that more than one per-layer metric reader uses.

A reader gets ``ctx`` with ``config``, ``traffic``, ``window`` (the
measured window: units, wall seconds and what its runner counted),
``trace`` (the profiled sub-window's summary, lib/trace.py, or None),
``trace_window`` (what the runner counted in that sub-window) and
``launches`` (the launches per kernel class that the trace was checked
against).  It returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from niswan_bench.lib import work


def idle_percent(ctx) -> Optional[float]:
    """The share of the profiled sub-window in which the card ran no
    kernel, copy or memset."""
    if ctx.trace is None or ctx.trace["idle_frac"] is None:
        return None
    return 100.0 * ctx.trace["idle_frac"]


def percentile_ms(ctx, q: float) -> Optional[float]:
    lat = ctx.window.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), q))


def mfu_percent(ctx, flops: float) -> Optional[float]:
    """``flops`` of the measured window over its wall time at the peak."""
    if flops <= 0 or ctx.window["wall_s"] <= 0:
        return None
    return 100.0 * flops / (ctx.window["wall_s"] * work.PEAKS["bf16_flops_per_s"])


def roofline_percent(ctx, classes: Iterable[str], bound_s: float) -> Optional[float]:
    """The kernels' least time over their device time in the traced
    sub-window, where the trace holds every launch of those classes."""
    if ctx.trace is None or not ctx.launches:
        return None
    classes = list(classes)
    if any(ctx.launches.get(c, 0) == 0 for c in classes if c in ctx.launches):
        return None
    took = sum(ctx.trace["class_s"].get(c, 0.0) for c in classes)
    return 100.0 * bound_s / took if took > 0 else None
