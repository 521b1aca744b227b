"""Synthetic E33OMA-shaped fixture data (a copy of
nasa_niswan_tpu/data/synthetic.py: numpy only, and importing it from the
JAX package would import JAX; tests hold the two byte-equal).

The reference's data lives on a private NASA filesystem (hard-coded
``/home/serfani/...`` roots, dataset.py:102,127,303,405). This module
generates a deterministic, physically-flavored stand-in with the exact shape
and variable catalog of the 90-day packed file (``E33OMA-90Days.nc``,
dataset.py:301-340): smooth wind/precip fields from rotating spectral modes,
and a tracer concentration produced by an explicit advection-diffusion-decay
recurrence driven by the winds and the emission field — so emulators trained
on it have real signal to learn (R^2 well above zero), which the end-to-end
training tests rely on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _spectral_field(
    rng: np.random.Generator,
    T: int,
    H: int,
    W: int,
    n_modes: int = 12,
    mean: float = 0.0,
    amp: float = 1.0,
) -> np.ndarray:
    """Sum of rotating large-scale Fourier modes; (T, H, W) float32."""
    y = np.linspace(0, 2 * np.pi, H, endpoint=False)[:, None]
    x = np.linspace(0, 2 * np.pi, W, endpoint=False)[None, :]
    t = np.arange(T, dtype=np.float32)
    field = np.zeros((T, H, W), np.float32)
    for _ in range(n_modes):
        ky, kx = rng.integers(1, 4, size=2)
        omega = rng.normal(0, 0.05)
        phase = rng.uniform(0, 2 * np.pi)
        a = amp * rng.uniform(0.2, 1.0) / n_modes**0.5
        spatial = np.cos(ky * y + kx * x + phase).astype(np.float32)
        field += a * np.cos(omega * t)[:, None, None] * spatial
        field += a * np.sin(omega * t)[:, None, None] * np.sin(
            ky * y + kx * x + phase
        ).astype(np.float32)
    return field + mean


def _advect_tracer(
    u: np.ndarray,
    v: np.ndarray,
    src: np.ndarray,
    *,
    diffusion: float = 0.3,
    decay: float = 0.02,
    dt: float = 0.2,
) -> np.ndarray:
    """Explicit upwind-ish advection-diffusion-decay driven by (u, v, src).

    Cyclic in longitude (axis -1), closed at the poles (axis -2) — the same
    boundary topology the padding ops encode.
    """
    T, H, W = src.shape
    c = np.zeros((T, H, W), np.float32)
    cur = np.zeros((H, W), np.float32)
    for t in range(T):
        dx = (np.roll(cur, -1, axis=1) - np.roll(cur, 1, axis=1)) * 0.5
        dy = np.zeros_like(cur)
        dy[1:-1] = (cur[2:] - cur[:-2]) * 0.5
        lap = (
            np.roll(cur, 1, axis=1)
            + np.roll(cur, -1, axis=1)
            - 2 * cur
        )
        lap[1:-1] += cur[2:] + cur[:-2] - 2 * cur[1:-1]
        cur = cur + dt * (
            -u[t] * dx - v[t] * dy + diffusion * lap + src[t] - decay * cur
        )
        cur = np.maximum(cur, 0.0)
        c[t] = cur
    return c


def synthetic_e33oma_90d(
    *,
    species="bcb",
    T: int = 480,
    H: int = 90,
    W: int = 144,
    nlev: int = 1,
    n_static: int = 3,
    seed: int = 0,
    burn_in: int = 300,
) -> Dict[str, np.ndarray]:
    """Generate an E33OMA-90Days-shaped dataset.

    Returns a dict with keys u, v, omega, prec, ``{sp}_src``,
    ``{sp}_conc`` each (T, H, W) float32 (or (T, nlev, H, W) for the
    tracer concentration when nlev > 1), plus ``static`` (n_static, H, W)
    standing in for static_attrs.nc (dataset.py:100-122).

    ``species`` may be a single name or a sequence of names: each species
    gets its own emission field and advected concentration driven by the
    SAME meteorology — the multi-tracer (config #5) fixture, mirroring how
    the reference's three tracers share one ModelE atmosphere
    (dataset.py:198-253).  A single name reproduces the historical draws
    bit-for-bit.
    """
    species_list = [species] if isinstance(species, str) else list(species)
    rng = np.random.default_rng(seed)
    # generate burn_in extra leading steps so the advected tracer reaches
    # statistical steady state (relaxation time ~ 1/(decay*dt) = 250 steps);
    # without it the test-period tail sits far above the training range and
    # every split comparison measures spin-up drift instead of skill
    Tb = T + burn_in
    u = _spectral_field(rng, Tb, H, W, mean=0.2, amp=6.0)
    v = _spectral_field(rng, Tb, H, W, mean=0.3, amp=5.0)
    omega = _spectral_field(rng, Tb, H, W, mean=0.0, amp=6e-5)
    prec = np.maximum(_spectral_field(rng, Tb, H, W, mean=1.0, amp=6.0), 0.0)

    tracers = {}
    for sp in species_list:
        # localized bursty emissions (biomass-burning flavor)
        base = np.maximum(_spectral_field(rng, 1, H, W, amp=3.0)[0], 0.0) ** 2
        season = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(Tb) / max(Tb, 1))
        src = base[None] * season[:, None, None].astype(np.float32)
        src *= rng.uniform(0.5, 1.5, size=(Tb, 1, 1)).astype(np.float32)

        conc = _advect_tracer(u * 0.1, v * 0.1, src)
        src, conc = src[burn_in:], conc[burn_in:]
        if nlev > 1:
            # vertical structure: exponential decay with level plus jitter
            profile = np.exp(-np.arange(nlev, dtype=np.float32) / 6.0)
            conc = conc[:, None] * profile[None, :, None, None]
            conc += (
                0.01 * rng.standard_normal(conc.shape).astype(np.float32) * conc
            )
        tracers[f"{sp}_src"] = src
        tracers[f"{sp}_conc"] = conc.astype(np.float32)

    u, v, omega, prec = (a[burn_in:] for a in (u, v, omega, prec))
    if nlev > 1:
        # 3-D meteorology: surface winds sheared/scaled with height (the
        # 20-level fusion inputs, data/fusion.py)
        shear = (1.0 + 0.08 * np.arange(nlev, dtype=np.float32))[None, :, None, None]
        jitter = lambda: 0.05 * rng.standard_normal((1, nlev, 1, 1)).astype(np.float32)
        u = u[:, None] * (shear + jitter())
        v = v[:, None] * (shear + jitter())
        omega = omega[:, None] * (1.0 + jitter())

    static = np.stack(
        [np.maximum(_spectral_field(rng, 1, H, W, amp=2.0)[0], -2.0) for _ in range(n_static)]
    ).astype(np.float32)

    out = {
        "u": u,
        "v": v,
        "omega": omega,
        "prec": prec,
        **tracers,
        "static": static,
    }
    return out
