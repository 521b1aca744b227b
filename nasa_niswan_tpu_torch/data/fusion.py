"""2-D emission + 3-D meteorology fusion, config #2 (counterpart of
nasa_niswan_tpu/data/fusion.py, a numpy copy).

Vertical levels become input channels, so every downstream component runs
unchanged.  Channel layout (C = 3 * levels + 2 by default):
    [u_l0..u_l{L-1}, v_l0.., omega_l0.., prec, emission]
The 3-D variables go level-major, so levels=1 gives the reference's
5-channel order u, v, w, prec, src.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from nasa_niswan_tpu_torch.data.catalog import PACKED_VARS

DEFAULT_3D_VARS = ("u", "v", "omega")
DEFAULT_2D_VARS = ("prec",)


def fusion_channel_count(levels: int, n_3d: int = 3, n_2d: int = 1) -> int:
    return n_3d * levels + n_2d + 1  # + emission


def fuse_levels(
    data: Dict[str, np.ndarray],
    species: str = "bcb",
    *,
    levels: int = 20,
    vars_3d: Tuple[str, ...] = DEFAULT_3D_VARS,
    vars_2d: Tuple[str, ...] = DEFAULT_2D_VARS,
    target_level: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the fused input stack.

    data values: 3-D vars (T, L, H, W) with L >= levels (surface-only
    (T, H, W) arrays are taken as L=1); 2-D vars and the emission (T, H, W).
    Returns (xs (T, C, H, W) float32, y (T, H, W) float32 at
    ``target_level``).
    """
    src_var, conc_var = PACKED_VARS[species]
    chans: List[np.ndarray] = []
    for name in vars_3d:
        arr = np.asarray(data[name])
        if arr.ndim == 3:
            arr = arr[:, None]
        if arr.shape[1] < levels:
            raise ValueError(
                f"{name} has {arr.shape[1]} levels; fusion needs {levels}"
            )
        chans.extend(arr[:, l] for l in range(levels))
    for name in vars_2d:
        chans.append(np.asarray(data[name]))
    chans.append(np.asarray(data[src_var]))
    xs = np.stack(chans, axis=1).astype(np.float32)

    conc = np.asarray(data[conc_var])
    y = (conc[:, target_level] if conc.ndim == 4 else conc).astype(np.float32)
    return xs, y
