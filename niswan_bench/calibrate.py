#!/usr/bin/env python3
"""Read the numbers that decide a cell's ``correct`` over many seeds in one
process, to set the cell's limits (``workloads/<cell>.json``).

    python3 niswan_bench/calibrate.py --workload serve_l20_chunked \
        --seeds 101-112 --control-seeds 201-203 --seconds 3 \
        [--control-seconds 10] [--faults half_batch,answer_altered] [--out readings.jsonl]

For every seed it runs the cell's runner as a run does (set-up, a window
of ``--seconds`` at the cell's own load, the check), on the port for
``--seeds``, on the control (the reference at fp8, reference/convlstm.py,
in the port's place) for ``--control-seeds``, and on the port with each fault of
lib/faults.py planted for ``--control-seeds``.  One JSON line per run:
the system, the fault, the seed, the units of its window and the numbers.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from niswan_bench.run import cache_env  # noqa: E402


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def one(spec_mod, cell, traffic, seed, seconds, device, system="port"):
    import torch

    config = spec_mod.config(cell["config"])
    drv = spec_mod.runner(traffic["runner"]).Runner(config, traffic, seed, device, system=system)
    t0 = time.perf_counter()
    drv.setup()
    window = drv.run(seconds=seconds)
    drv.release()
    values, compared = drv.check()
    out = {"seed": seed, "units": window["units"], "compared": compared, "values": values,
           "readings": getattr(drv, "readings", None), "s": time.perf_counter() - t0}
    del drv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the control's window (default --seconds): it runs slower")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache_env()
    import torch

    from niswan_bench.lib import faults, spec

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(spec.benchmark(), args.workload)
    traffic = spec.traffic(cell["traffic"])
    sink = open(args.out, "a") if args.out else None
    runs = [("port", None, s) for s in seeds(args.seeds)]
    runs += [("control", None, s) for s in seeds(args.control_seeds)]
    runs += [("port", f, s) for f in filter(None, args.faults.split(","))
             for s in seeds(args.control_seeds)]
    try:
        for system, fault, seed in runs:
            if fault is None:
                secs = args.seconds if system == "port" else (args.control_seconds
                                                              or args.seconds)
                rec = one(spec, cell, traffic, seed, secs, device, system)
            else:
                with faults.planted(fault, traffic["runner"]):
                    rec = one(spec, cell, traffic, seed, args.seconds, device)
            rec = {"cell": args.workload, "system": system, "fault": fault, **rec}
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
