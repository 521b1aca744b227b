"""The numbers that decide ``correct``, each a gap between what the port
produced and what the reference works out from the same inputs."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import math

import torch


def frame_rms_max(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Predictions (B, T, H, W): the largest RMS error of one frame, over
    the standard deviation of the reference's frames together."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    err = (prog - ref).pow(2).mean(dim=(-2, -1)).sqrt()
    return float(err.max() / ref.std())


def rel_rms(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS of the difference over the RMS of the reference."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    return float((prog - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-300))


def carry_rms_max(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    """The largest ``rel_rms`` over the leaves of a carry."""
    return max(rel_rms(p, r) for p, r in zip(prog, ref))


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / abs(ref) if ref != 0 else math.inf


def norms(leaves: Iterable[torch.Tensor]) -> List[float]:
    return [float(t.detach().double().norm()) for t in leaves]


def step_gradients(moments: Sequence[Sequence[torch.Tensor]],
                   beta1: float) -> List[List[torch.Tensor]]:
    """Each step's gradient as Adam got it, from its first moments after
    each step (a list of leaves a step): g_k = (m_k - beta1 m_{k-1}) /
    (1 - beta1), with m_0 = 0."""
    out, prev = [], None
    for m in moments:
        out.append([(t if q is None else t - beta1 * q) / (1.0 - beta1)
                    for t, q in zip(m, prev or [None] * len(m))])
        prev = m
    return out


def worst_leaf(gaps: Sequence[float], ref: Sequence[float],
               keep: Optional[Sequence[bool]] = None, scale: float = 0.0) -> float:
    """The largest of ``gaps`` (one a leaf), each over the reference's norm
    of that leaf or of the median leaf, whichever is larger (or ``scale``,
    where that is larger still).  ``keep`` leaves some leaves out."""
    keep = [True] * len(ref) if keep is None else list(keep)
    kept = sorted(r for r, k in zip(ref, keep) if k)
    median = kept[len(kept) // 2] if kept else 0.0
    out = [g / max(r, median, scale, 1e-300) for g, r, k in zip(gaps, ref, keep) if k]
    return max(out) if out else math.inf


def leaf_norm_gap(prog: Sequence[float], ref: Sequence[float],
                  keep: Optional[Sequence[bool]] = None) -> float:
    """By the worst leaf: the gap between the port's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    return worst_leaf([abs(p - r) for p, r in zip(prog, ref)], ref, keep)


def moved_leaves(ref_grad_norms: Sequence[float], floor: float = 1e-3) -> List[bool]:
    """The leaves whose reference gradient is not nought to rounding: a norm
    of at least ``floor`` times the median leaf's.  Adam moves the others by
    round-off alone."""
    med = sorted(ref_grad_norms)[len(ref_grad_norms) // 2]
    return [g >= floor * med for g in ref_grad_norms]


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number has a limit and lies within it."""
    return all(name in limits and math.isfinite(v) and v <= limits[name]
               for name, v in values.items()) and bool(values)
