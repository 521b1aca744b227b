"""Reading a torch.profiler Chrome trace of one profiled sub-window.

The sub-window is the host span named ``WINDOW`` (a ``record_function``
of the runner), and the profiler records nothing else: every device event
of the trace is the sub-window's work.  Device activity is every kernel,
copy and memset event; the busy time is the union of their intervals
inside the sub-window and the idle share is the rest of it.  Kernels are
put into the classes of ``metrics/kernel_classes.json`` by their demangled
names, as scripts/torch_trace_summary.py does, and the launches of each
class that the port's counters say ran are checked against the trace.

The classes' times and launches, and the longest operations, are read over
every device event of the trace, not only those whose timestamps fall in
the span: on an H100 the profiler now and then places a few device events
milliseconds before their launch, outside the span.  It also now and then
drops a few records; a trace that lacks a counted launch raises
``IncompleteTrace``, and is not read.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"
CALL_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")

CLASSES_FILE = Path(__file__).resolve().parent.parent / "metrics" / "kernel_classes.json"


def load_classes(path: Path = CLASSES_FILE) -> dict:
    return json.loads(Path(path).read_text())["classes"]


class TraceError(RuntimeError):
    pass


class IncompleteTrace(TraceError):
    """The profiler lost records of the sub-window: profile it again."""


def kernel_class(name: str, classes: dict) -> Optional[str]:
    """The class of a kernel name, or None for a kernel of no class.  A
    kernel matching a class that names an epilogue, whose name holds none
    of the epilogues of the classes it matches, raises."""
    epilogue_miss = False
    for cls, spec in classes.items():
        if not any(n in name for n in spec["names"]):
            continue
        epi = spec.get("epilogue")
        if epi is None or epi in name:
            return cls
        epilogue_miss = True
    if epilogue_miss:
        raise TraceError(f"a cell kernel whose epilogue is not in its name: {name[:200]}")
    return None


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str, limit: int = 100) -> str:
    """A kernel's demangled name without ``void``, anonymous namespaces and
    its parameter list, cut to ``limit`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:limit]


def _interval(e: dict) -> Tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def _innermost(events: List[dict], t: float) -> Optional[str]:
    best = None
    for e in events:
        s, end = _interval(e)
        if s <= t < end and (best is None or end - s < best[0]):
            best = (end - s, e["name"])
    return None if best is None else best[1]


def summarize(events: List[dict], classes: dict, n_top: int = 10) -> dict:
    """The sub-window's busy and idle time, its kernels by class (device
    microseconds and launches counted, over the whole trace), the longest
    device operations and the longest idle gaps, each gap named by what the
    host was doing when it began (the innermost span of the runner, then the
    innermost call)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    windows = [e for e in xs if e.get("cat") == SPAN_CAT and e.get("name") == WINDOW]
    if len(windows) != 1:
        raise IncompleteTrace(f"expected one '{WINDOW}' span in the trace, found {len(windows)}")
    w0, w1 = _interval(windows[0])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    clipped = [(max(s, w0), min(e, w1)) for s, e in map(_interval, dev)]
    clipped = [iv for iv in clipped if iv[1] > iv[0]]
    busy = merged(clipped)
    busy_us = sum(e - s for s, e in busy)
    window_us = w1 - w0

    class_us: Dict[str, float] = collections.Counter()
    counted: Dict[str, int] = collections.Counter()
    by_name: Dict[str, float] = collections.Counter()
    for e in dev:
        s, end = _interval(e)
        name = e["name"]
        by_name[short_name(name)] += end - s
        if e.get("cat") != "kernel":
            continue
        cls = kernel_class(name, classes)
        if cls is None:
            continue
        class_us[cls] += end - s
        if any(n in name for n in classes[cls].get("counted", ())):
            counted[cls] += 1

    gaps = []
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    spans = [e for e in xs if e.get("cat") == SPAN_CAT and e.get("name") != WINDOW]
    calls = [e for e in xs if e.get("cat") in CALL_CATS]
    idle_gaps = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:n_top]:
        label = " / ".join(x for x in (_innermost(spans, g0), _innermost(calls, g0)) if x)
        idle_gaps.append([label or "host: no span", (g1 - g0) / 1e6])

    return {
        "window_s": window_us / 1e6,
        "busy_s": busy_us / 1e6,
        "idle_frac": 1.0 - busy_us / window_us if window_us > 0 else None,
        "class_s": {k: v / 1e6 for k, v in class_us.items()},
        "counted": dict(counted),
        "device_ops": [[n, us / 1e6] for n, us in by_name.most_common(n_top)],
        "idle_gaps": idle_gaps,
    }


def expected_launches(deltas: Dict[str, int], classes: dict) -> Dict[str, int]:
    """Per class with counters, the launches the counters add up to."""
    return {cls: sum(deltas.get(c, 0) for c in spec["counters"])
            for cls, spec in classes.items() if spec.get("counters")}


def check_counts(summary: dict, deltas: Dict[str, int], classes: dict) -> Dict[str, int]:
    """Raise ``IncompleteTrace`` unless the trace holds, for every class
    with counters, exactly the launches the counters say ran; returns them."""
    want = expected_launches(deltas, classes)
    seen = summary["counted"]
    bad = {cls: (seen.get(cls, 0), n) for cls, n in want.items() if seen.get(cls, 0) != n}
    if bad:
        text = ", ".join(f"{cls}: {s} in the trace, {n} counted" for cls, (s, n) in bad.items())
        raise IncompleteTrace(f"the trace does not hold every counted launch ({text})")
    return want
