"""Tracing and timing (counterpart of nasa_niswan_tpu/utils/profiling.py).

  * ``trace(logdir)``: ``torch.profiler`` over the enclosed block (the CPU,
    and the card's kernels where one is visible), written to
    ``<logdir>/trace.json`` as a Chrome trace (Perfetto opens it).
  * ``span(name)``: the port's own spans around the host work of its hot
    paths (the serving step and chunk, the training step, the uploads, the
    graph runners' staging, replay and capture, the kernels' load).  They
    record only while a ``torch.profiler`` session records (``trace`` or
    any other): then each is a ``record_function`` range in the profiler's
    trace, beside the card's kernels, and a record kept in memory
    (``spans(name)``).  Outside a profiler a span is a shared no-op.
    ``counters()``: the always-on set-up counters (``graph.capture_s``,
    ``kernels.load_s``).
  * ``device_sync``: waits for the device of a tree's first tensor.
  * ``StepTimer``: the sustained step-time / model-days-per-min meter, one
    reading per window of ``sync_every`` ticks: CUDA events on the card
    (device time between the windows' ends), ``perf_counter`` on the CPU.
  * ``layer_summary``: the torchsummary-style parameter table, line for line
    the JAX package's for the same parameter tree.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Union

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


MAX_SPANS = 100_000  # records kept in memory; the oldest are dropped

_records: Deque["SpanRecord"] = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, float] = {"graph.capture_s": 0.0, "kernels.load_s": 0.0}
_counter_lock = threading.Lock()
_stack = threading.local()  # each thread's open spans, innermost last
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled  # this thread under a profiler


class SpanRecord:
    """One span: ``name``, ``parent`` (the record of the span it opened
    inside, on the same thread, or None), host start and end
    (``time.perf_counter_ns``; ``end_ns`` is None while it is open) and,
    for a device span, its device seconds (``device_s``): from the moment
    the stream reached its start to its last operation, read from a CUDA
    event pair once the caller has synchronized."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str, parent: Optional["SpanRecord"]):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = None
        self.events = None

    @property
    def host_s(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self) -> Optional[float]:
        if self.events is None:
            return None
        start, end = self.events
        return start.elapsed_time(end) / 1e3


class _Span:
    """A span that times itself into a counter (``counter``), and records
    while a profiler records."""

    __slots__ = ("name", "device", "counter", "record", "range", "t0")

    def __init__(self, name: str, device, counter: Optional[str]):
        self.name, self.device, self.counter = name, device, counter
        self.record = self.range = None

    def __enter__(self):
        if _profiling():
            stack = _open_spans()
            self.record = SpanRecord(self.name, stack[-1] if stack else None)
            stack.append(self.record)
            _records.append(self.record)
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            self.record.start_ns = time.perf_counter_ns()  # the host window holds the events
            stream = _stream(self.device)
            if stream is not None:
                self.record.events = (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))
                self.record.events[0].record(stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.counter is not None:
            took = time.perf_counter() - self.t0
            with _counter_lock:
                _counters[self.counter] += took
        rec = self.record
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record(_stream(self.device))
            rec.end_ns = time.perf_counter_ns()
            self.range.__exit__(*exc)
            _open_spans().pop()
        return False


def _open_spans() -> List[SpanRecord]:
    if not hasattr(_stack, "spans"):
        _stack.spans = []
    return _stack.spans


def _stream(device) -> Optional["torch.cuda.Stream"]:
    """The stream a device span's events go on: the current stream of
    ``device`` (a CUDA ``torch.device``, or True for the current CUDA
    device); None elsewhere."""
    if isinstance(device, torch.device):
        return torch.cuda.current_stream(device) if device.type == "cuda" else None
    if device and torch.cuda.is_available():
        return torch.cuda.current_stream()
    return None


def span(name: str, device: Union[bool, torch.device] = False,
         counter: Optional[str] = None):
    """A context manager around host work of the port, named ``name``.

    While a ``torch.profiler`` session records on this thread, it enters
    ``torch.profiler.record_function(name)`` (a ``user_annotation`` in the
    profiler's trace, on its clock) and keeps a ``SpanRecord`` (at most
    ``MAX_SPANS``, the oldest dropped); with ``device`` (True: the current
    CUDA device, or a ``torch.device``) it also records a CUDA event pair on
    that device's current stream.  Otherwise it records nothing and is a
    shared no-op, unless ``counter`` names one of ``counters()``: the
    block's host seconds are then added to it whether a profiler records or
    not.  Never open one inside a body that is captured into a CUDA
    graph."""
    if counter is None and not _profiling():
        return _OFF
    return _Span(name, device, counter)


def spans(name: str) -> List[SpanRecord]:
    """The records of the spans named ``name``, in the order they opened."""
    return [r for r in list(_records) if r.name == name]


def counters() -> Dict[str, float]:
    """The always-on counters: ``graph.capture_s``, host seconds spent
    capturing CUDA graphs (``niswan.graph.capture``: a serving runner's
    warm-up and capture, a training step's eager first call and capture),
    and ``kernels.load_s``, host seconds spent making the CUDA kernels
    ready (``niswan.kernels.load``: the sources' digest, nvcc where the
    library is missing, the load), since the process started."""
    with _counter_lock:
        return dict(_counters)


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
