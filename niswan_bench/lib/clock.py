"""Clocks: the seconds since this process started, for ``setup_s``."""

from __future__ import annotations

import os
import time

_IMPORTED = time.monotonic()


def process_age_s() -> float:
    """Seconds since the process started, from /proc (clock-tick resolution,
    10 ms); where /proc cannot be read, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22 of stat(5), after pid and comm
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


class Phases:
    """Seconds spent in the named phases of a set-up, in order."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def __str__(self) -> str:
        return ", ".join(f"{k} {v:.2f} s" for k, v in self.seconds.items())
