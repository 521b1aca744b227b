"""Tiny configurations and traffic for running the runners on the CPU."""

from __future__ import annotations

import copy

from niswan_bench.lib import spec

GRID = [10, 16]
PADDED = [12, 20]


def config(name: str, in_channels: int = 6, dynamic: int = None) -> dict:
    """A configuration file's keys with the widths cut for the CPU."""
    cfg = copy.deepcopy(spec.config(name))
    dynamic = cfg["dynamic_channels"] if dynamic is None else dynamic
    static = cfg["in_channels"] - cfg["dynamic_channels"]
    cfg.update(in_channels=min(dynamic, in_channels) + static,
               dynamic_channels=min(dynamic, in_channels),
               hidden_channels=[8, 4, 4], grid=GRID, padded=PADDED,
               batch_size=2, sequence_length=4)
    return cfg


TRAFFIC = {
    "chained_384": dict(chunk_steps=6, sample_within=3, trace_units=1),
    "inline_pinned48": dict(pool_frames=5, first_calls=7, late_calls=4, late_within=5,
                          trace_units=3),
    "resident_year": dict(slab_frames=40, trace_units=1),
}


def traffic(name: str) -> dict:
    tr = copy.deepcopy(spec.traffic(name))
    tr.update(TRAFFIC[name])
    return tr
