#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 niswan_bench/run.py --workload serve_l20_chunked --seed 7 \
        --seconds 30 --trace 0

The run makes its inputs and weights on the card from ``--seed``, warms up
every shape its traffic uses (set-up, ``setup_s``), measures a closed-loop
window of ``--seconds``, then lets the plain reference check what the
window's path produced.  With ``--trace 1`` a short profiled sub-window
runs right after set-up, and the result holds the cell's per-layer metrics
instead of its end-to-end ones.  The last line of standard output is one
JSON object; the last lines of standard error give each number compared
for ``correct`` beside its limit.

A run refuses to start without a CUDA device and fails, printing no result,
where the process holds JAX or the JAX package after set-up, after the
window or before it prints, or where the trace lacks a kernel launch that
the port's counters say ran.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from niswan_bench.lib import clock  # noqa: E402  (the process clock, before torch loads)

CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
TRACE_ATTEMPTS = 3  # profiled sub-windows before a trace that lost records fails the run


def cache_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout (the port's own nvcc
    build lands in ``build/kernels/`` there)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / "build" / "bench_cache" / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def profiled(drv, traffic, device, attempts: int = TRACE_ATTEMPTS):
    """The profiled sub-window: (trace summary, what the runner counted,
    the launches per kernel class that the trace was checked against).
    Where the profiler lost records of it (``trace.IncompleteTrace``), the
    trace is not read and the runner's next units are profiled instead."""
    from niswan_bench.lib import trace

    for attempt in range(1, attempts + 1):
        try:
            return profile_once(drv, traffic, device)
        except trace.IncompleteTrace as e:
            if attempt == attempts:
                raise
            print(f"trace {attempt} of {attempts} not read: {e}", file=sys.stderr)


def profile_once(drv, traffic, device):
    from torch.profiler import ProfilerActivity, profile, record_function

    from nasa_niswan_tpu_torch.ops import launch_counts
    from niswan_bench.lib import port, trace

    classes = trace.load_classes()
    before = launch_counts()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            window = drv.run(count=traffic["trace_units"], measured=False)
    deltas = port.count_deltas(before, launch_counts())
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    summary = trace.summarize(events, classes)
    launches = trace.check_counts(summary, deltas, classes)
    return summary, window, launches


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict, limits: dict, *,
             seed: int, seconds: float, trace: bool, device):
    """One run of a cell on ``device`` after the look for a chip: set-up,
    the profiled sub-window (``trace``), the window, the check.  Returns
    (the result line's object, the numbers compared)."""
    import torch

    from niswan_bench.lib import compare, guard, spec

    cuda = device.type == "cuda"
    before_setup = clock.process_age_s()
    drv = spec.runner(traffic["runner"]).Runner(config, traffic, seed, device)
    drv.setup()
    guard.check("after set-up")
    setup_s = clock.process_age_s()
    print(f"set-up {setup_s:.2f} s: start {before_setup:.2f} s, {drv.phases}", file=sys.stderr)
    summary = trace_window = launches = None
    if trace:
        summary, trace_window, launches = profiled(drv, traffic, device)
    window = drv.run(seconds=seconds)
    print(f"window: {window['units']} units in {window['wall_s']:.4f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    guard.check("after the window")
    drv.release()
    values, compared = drv.check()
    guard.check("before the result")

    metrics = {}
    if not trace:
        e2e = dict(drv.e2e(window), setup_s=setup_s)
        for m in spec.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(config=config, traffic=traffic, window=window, trace=summary,
                              trace_window=trace_window, launches=launches)
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": compare.verdict(values, limits), "attempted": window["units"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": limits.get(name)}
                        for name, v in values.items()}
    return result, compared


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch

    from niswan_bench.lib import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, compared = run_cell(
        bench, cell, spec.config(cell["config"]), spec.traffic(cell["traffic"]),
        spec.limits(cell["name"]), seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0))
    sys.stdout.flush()
    print(f"compared {compared} answers of {args.workload}, seed {args.seed}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
