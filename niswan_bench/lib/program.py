"""What the port records about itself, for the per-layer readers: its spans
and always-on counters (``nasa_niswan_tpu_torch.utils.profiling``:
``spans(name)``, ``counters()``).

A span records only while a profiler records, so the port's records of a
run are those of its profiled sub-window (``ctx.trace_window``); where that
sub-window was profiled again after a trace that lost records, the last
``units`` records of a span that fires once a unit are the sub-window that
was read.  A port that keeps no such records (one older than its spans)
reads as nothing: every function here returns None.
"""

from __future__ import annotations

from typing import List, Optional


def profiling():
    """The port's tracing module, or None where it has no spans."""
    try:
        from nasa_niswan_tpu_torch.utils import profiling as prof
    except ImportError:
        return None
    return prof if hasattr(prof, "spans") and hasattr(prof, "counters") else None


def unit_spans(ctx, name: str) -> Optional[List]:
    """The records of span ``name`` of the profiled sub-window, one a unit:
    the last ``units`` of them; None where there are fewer."""
    prof = profiling()
    if prof is None or not ctx.trace_window:
        return None
    units = ctx.trace_window["units"]
    records = prof.spans(name)
    if units <= 0 or len(records) < units:
        return None
    return records[-units:]


def mean_host_s(ctx, name: str) -> Optional[float]:
    """The mean host seconds of span ``name`` over the sub-window's units."""
    records = unit_spans(ctx, name)
    if records is None or any(r.host_s is None for r in records):
        return None
    return sum(r.host_s for r in records) / len(records)


def device_share_percent(ctx, name: str) -> Optional[float]:
    """The device seconds of the sub-window's spans ``name`` (each from the
    moment the stream reached it to its last operation), as a share of the
    traced sub-window (``ctx.trace["window_s"]``)."""
    records = unit_spans(ctx, name)
    if records is None or ctx.trace is None or not ctx.trace["window_s"]:
        return None
    took = [r.device_s for r in records]
    if any(t is None for t in took):
        return None
    return 100.0 * sum(took) / ctx.trace["window_s"]


def counter(name: str) -> Optional[float]:
    """One of the port's always-on counters, since the process started."""
    prof = profiling()
    return None if prof is None else prof.counters().get(name)
