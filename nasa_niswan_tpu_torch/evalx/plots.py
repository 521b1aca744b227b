"""Host-side plotting and reporting (counterpart of
nasa_niswan_tpu/evalx/plots.py; reference: utils.py:124-235 and the
map/series figures of test.ipynb).

Semantics ported, not style: each function reproduces what the reference
plot shows (box/CDF/QQ panels, 1950-vs-1951 global-average comparison,
nearest-gridpoint series, exceedance curves) using matplotlib only — these
run on the host and are not part of any compiled path.  All functions
accept an ``ax``/``save_path`` and never call plt.show() (headless-safe).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

def _require_mpl():
    """matplotlib.pyplot on the Agg backend, imported only where a plot is
    drawn (the card's machine has no matplotlib)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is required for plotting utilities") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_saving_path(root: str, fformat: str, name: str) -> str:
    """Figure-path helper (reference utils.py:121-122)."""
    import os

    return os.path.join(root, f"{name}.{fformat}")


def qqplot(
    y_test: np.ndarray,
    y_pred: np.ndarray,
    *,
    axis_names: Tuple[str, str] = ("GT", "MODEL"),
    quantiles: Optional[int] = None,
    save_path: Optional[str] = None,
):
    """Box / empirical-CDF / quantile-quantile triptych (utils.py:124-171)."""
    plt = _require_mpl()
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(10, 3),
                                        constrained_layout=True)
    ax1.boxplot([y_test, y_pred], showmeans=True, showfliers=False)
    ax1.set_xticklabels(axis_names)
    ax1.grid(True)

    for vals, name, style in ((y_test, axis_names[0], "-"),
                              (y_pred, axis_names[1], "-.")):
        xs = np.sort(vals)
        ax2.plot(xs, np.arange(1, len(vals) + 1) / len(vals), style, label=name)
    ax2.grid(True)
    ax2.legend()

    q = quantiles or min(len(y_test), len(y_pred))
    qs = np.linspace(0, 1, int(q))
    xq = np.quantile(y_test, qs, method="nearest")
    yq = np.quantile(y_pred, qs, method="nearest")
    ax3.scatter(xq, yq)
    lo, hi = min(xq.min(), yq.min()), max(xq.max(), yq.max())
    ax3.plot([lo, hi], [lo, hi], "--", color="black", linewidth=1.5)
    ax3.set_xlabel(axis_names[0])
    ax3.set_ylabel(axis_names[1])

    if save_path:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0.1)
    return fig


def plot_global_ave(
    series: np.ndarray,
    *,
    split: int = 17520,
    labels: Tuple[str, str] = ("1950", "1951"),
    save_path: Optional[str] = None,
):
    """Year-over-year comparison of a global-average series: scatter of year
    1 vs year 2 plus overlaid monthly-ticked time series (utils.py:174-209)."""
    plt = _require_mpl()
    a, b = np.asarray(series[:split]), np.asarray(series[split : 2 * split])
    n = min(len(a), len(b))
    fig, (ax1, ax2) = plt.subplots(
        1, 2, figsize=(20, 4), constrained_layout=True,
        gridspec_kw={"width_ratios": [1, 4]},
    )
    lo = min(a.min(), b.min()) if n else 0.0
    hi = max(a.max(), b.max()) if n else 1.0
    ax1.scatter(a[:n], b[:n], alpha=0.5)
    ax1.plot([lo, hi], [lo, hi], "--", color="black", linewidth=1.5)
    ax1.set_xlabel(labels[0])
    ax1.set_ylabel(labels[1])
    ax1.grid()

    ax2.plot(a, label=labels[0])
    ax2.plot(b, label=labels[1])
    months = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
              "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
    ax2.set_xticks(range(0, split, max(split // 12, 1)))
    ax2.set_xticklabels(months[: len(range(0, split, max(split // 12, 1)))],
                        rotation=45)
    ax2.grid()
    ax2.legend()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0.1)
    return fig


def find_nearest(coords: np.ndarray, lat: float, lon: float) -> Tuple[float, float]:
    """Nearest (lat, lon) gridpoint from an (N, 2) coordinate table
    (utils.py:211-219): nearest latitude first, then nearest longitude
    within that latitude row."""
    coords = np.asarray(coords)
    lat_sel = coords[np.abs(coords[:, 0] - lat).argmin(), 0]
    row = coords[coords[:, 0] == lat_sel]
    lon_sel = row[np.abs(row[:, 1] - lon).argmin(), 1]
    return float(lat_sel), float(lon_sel)


def plot_on_grid(
    gts: np.ndarray,
    pds: np.ndarray,
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    lat: float,
    lon: float,
    *,
    save_path: Optional[str] = None,
):
    """GT-vs-prediction time series at the gridpoint nearest (lat, lon),
    annotated with its R^2 (utils.py:221-235)."""
    plt = _require_mpl()
    from nasa_niswan_tpu_torch.evalx.metrics import r2

    coords = np.array([(la, lo) for la in grid_lat for lo in grid_lon])
    lat_sel, lon_sel = find_nearest(coords, lat, lon)
    i = int(np.argmin(np.abs(np.asarray(grid_lat) - lat_sel)))
    j = int(np.argmin(np.abs(np.asarray(grid_lon) - lon_sel)))
    g, p = gts[:, i, j], pds[:, i, j]
    fig, ax = plt.subplots(figsize=(20, 4))
    ax.plot(g, label="Real Data")
    ax.plot(p, label="Model Output")
    ax.set_title(f"lat:{lat_sel}, lon:{lon_sel}, R2: {float(r2(g, p)):.2f}")
    ax.grid(True)
    ax.legend()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0.1)
    return fig


# Robinson projection table (Robinson 1974; the published 5-degree
# parallel-length X and parallel-distance Y multipliers the projection is
# DEFINED by — public mathematical constants, interpolated below).
_ROBINSON_LAT = np.arange(0.0, 91.0, 5.0)
_ROBINSON_X = np.array([
    1.0000, 0.9986, 0.9954, 0.9900, 0.9822, 0.9730, 0.9600, 0.9427,
    0.9216, 0.8962, 0.8679, 0.8350, 0.7986, 0.7597, 0.7186, 0.6732,
    0.6213, 0.5722, 0.5322,
])
_ROBINSON_Y = np.array([
    0.0000, 0.0620, 0.1240, 0.1860, 0.2480, 0.3100, 0.3720, 0.4340,
    0.4958, 0.5571, 0.6176, 0.6769, 0.7346, 0.7903, 0.8435, 0.8936,
    0.9394, 0.9761, 1.0000,
])


def robinson_xy(
    lat_deg: np.ndarray, lon_deg: np.ndarray, *, lon_0: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Project (lat, lon) degrees onto Robinson map coordinates.

    x = 0.8487 * X(|lat|) * (lon - lon_0)   [lon in radians]
    y = 1.3523 * sign(lat) * Y(|lat|)

    X/Y come from cubic interpolation of the defining 5-degree table
    (matching PROJ's robin to visual accuracy).  Pure numpy/scipy — this
    is what lets the Robinson figures of test.ipynb cells 20-21/37-38
    render without cartopy in the TPU image.
    """
    from scipy.interpolate import CubicSpline

    lat = np.asarray(lat_deg, np.float64)
    lon = np.asarray(lon_deg, np.float64)
    a = np.clip(np.abs(lat), 0.0, 90.0)
    X = CubicSpline(_ROBINSON_LAT, _ROBINSON_X)(a)
    Y = CubicSpline(_ROBINSON_LAT, _ROBINSON_Y)(a)
    dlon = lon - lon_0  # wrap to [-180, 180], preserving the boundaries
    dlon = np.where(dlon > 180.0, dlon - 360.0, dlon)
    dlon = np.where(dlon < -180.0, dlon + 360.0, dlon)
    x = 0.8487 * X * np.deg2rad(dlon)
    y = 1.3523 * np.sign(lat) * Y
    return x, y


def _robinson_pcolormesh(ax, grid_lat, grid_lon, field, *, lon_0=0.0, **kw):
    """pcolormesh of a (lat, lon) field warped onto Robinson coordinates:
    cell corners are projected individually so quads follow the curved
    parallels; adds the projection boundary and a 30/60-degree graticule."""
    la = np.asarray(grid_lat, np.float64)
    lo = np.asarray(grid_lon, np.float64)

    def corners(c, limit):
        mid = (c[:-1] + c[1:]) / 2
        return np.clip(
            np.concatenate([[2 * c[0] - mid[0]], mid, [2 * c[-1] - mid[-1]]]),
            -limit, limit,
        )
    LA, LO = np.meshgrid(corners(la, 90.0), corners(lo, 180.0), indexing="ij")
    X, Y = robinson_xy(LA, LO, lon_0=lon_0)
    im = ax.pcolormesh(X, Y, field, **kw)

    edge_lat = np.linspace(-90, 90, 181)
    for sgn in (-1.0, 1.0):
        bx, by = robinson_xy(
            edge_lat, np.full_like(edge_lat, sgn * 180.0 + lon_0), lon_0=lon_0
        )
        ax.plot(bx, by, color="black", linewidth=0.8)
    for glat in range(-60, 61, 30):
        gx, gy = robinson_xy(
            np.full(121, float(glat)), np.linspace(-180, 180, 121) + lon_0,
            lon_0=lon_0,
        )
        ax.plot(gx, gy, color="gray", linewidth=0.3, alpha=0.6)
    for glon in range(-150, 151, 60):
        gx, gy = robinson_xy(
            np.linspace(-90, 90, 91), np.full(91, float(glon) + lon_0),
            lon_0=lon_0,
        )
        ax.plot(gx, gy, color="gray", linewidth=0.3, alpha=0.6)
    ax.set_aspect("equal")
    ax.set_axis_off()
    return im


def plot_global_map(
    field: np.ndarray,
    grid_lat: Sequence[float],
    grid_lon: Sequence[float],
    *,
    projection: Optional[str] = None,
    title: Optional[str] = None,
    cbar_label: Optional[str] = None,
    save_path: Optional[str] = None,
    ax=None,
    **mesh_kw,
):
    """Global field map; ``projection=None`` is the plain lat-lon
    pcolormesh, ``projection="robinson"`` the Robinson figure of
    test.ipynb cells 20-21/37-38 — via cartopy when installed, else the
    built-in numpy Robinson warp (visually equivalent, no coastlines)."""
    plt = _require_mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 5), constrained_layout=True)
    else:
        fig = ax.figure
    if projection == "robinson":
        try:  # pragma: no cover - cartopy not in the TPU image
            import cartopy.crs as ccrs

            fig.delaxes(ax)
            ax = fig.add_subplot(projection=ccrs.Robinson())
            im = ax.pcolormesh(
                grid_lon, grid_lat, field,
                transform=ccrs.PlateCarree(), **mesh_kw,
            )
            ax.coastlines(linewidth=0.5)
            ax.set_global()
        except ImportError:
            im = _robinson_pcolormesh(ax, grid_lat, grid_lon, field, **mesh_kw)
    elif projection is None:
        im = ax.pcolormesh(grid_lon, grid_lat, field, **mesh_kw)
    else:
        raise ValueError(f"unknown projection {projection!r}")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, orientation="horizontal", pad=0.02, shrink=0.7,
                 label=cbar_label)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0.1)
    return fig


def plot_r2_map(
    r2_map: np.ndarray,
    grid_lat: Sequence[float],
    grid_lon: Sequence[float],
    *,
    projection: Optional[str] = None,
    save_path: Optional[str] = None,
):
    """Global R^2 map (test.ipynb cell 38; pass projection="robinson" for
    the notebook's Robinson rendering — built-in warp, cartopy optional)."""
    return plot_global_map(
        r2_map, grid_lat, grid_lon, projection=projection,
        cbar_label=r"Coefficient of Determination ($R^2$)",
        save_path=save_path, cmap="RdBu_r", vmin=-1, vmax=1,
    )


def plot_oat_boxplot(
    deltas,
    *,
    subsample: int = 10000,
    seed: int = 0,
    ax=None,
    save_path: Optional[str] = None,
):
    """OAT sensitivity boxplot (test.ipynb cell 57): distribution of
    |Δprediction| per perturbed input channel.

    ``deltas``: {channel_name: |Δpred| array} from
    rollout/sensitivity.oat_sensitivity; each is flattened and subsampled
    (the reference plots the full test pass — subsampling keeps the figure
    cheap at decadal scale without changing the quartiles).
    """
    plt = _require_mpl()
    rng = np.random.default_rng(seed)
    names = list(deltas)
    samples = []
    for name in names:
        flat = np.asarray(deltas[name]).ravel()
        if flat.size > subsample:
            flat = rng.choice(flat, size=subsample, replace=False)
        samples.append(flat)
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 3.2), constrained_layout=True)
    else:
        fig = ax.figure
    ax.boxplot(samples, showmeans=True, showfliers=False)
    ax.set_xticklabels(names)
    ax.set_ylabel("|Δ prediction|")
    ax.grid(True, axis="y")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0.1)
    return fig
