"""The port's kernel wrappers.

Every module here that launches a kernel keeps one module-level launch
counter per kernel (or mode) and names them in its ``LAUNCH_COUNTERS``.
``launch_counts`` reads every such counter of the loaded modules and
``add_launch_counts`` adjusts them: a CUDA graph replay (graph.py)
runs no Python, so its runner takes back what was counted while capturing
and adds it once per replay.
"""

from __future__ import annotations

import sys
from typing import Dict


def _counter_modules():
    prefix = __name__ + "."
    return [m for name, m in sorted(sys.modules.items())
            if name.startswith(prefix) and hasattr(m, "LAUNCH_COUNTERS")]


def launch_counts() -> Dict[str, int]:
    """Every launch counter of the loaded kernel modules, by
    ``module.counter``."""
    return {f"{m.__name__}.{n}": getattr(m, n)
            for m in _counter_modules() for n in m.LAUNCH_COUNTERS}


def add_launch_counts(deltas: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times each delta of ``launch_counts``' keys."""
    for key, d in deltas.items():
        mod, name = key.rsplit(".", 1)
        m = sys.modules[mod]
        setattr(m, name, getattr(m, name) + sign * d)
