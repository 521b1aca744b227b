"""The port's evaluation metrics (nasa_niswan_tpu_torch/evalx/metrics.py)
against the JAX package's, on the same seeded numpy inputs: every metric,
at f32 tolerance (rtol 1e-5, atol 1e-6: sums over a few thousand f32 terms
taken in other orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.core.grid import GridSpec  # noqa: E402
from nasa_niswan_tpu.evalx import metrics as jm  # noqa: E402
from nasa_niswan_tpu_torch.evalx import metrics as tm  # noqa: E402

T, H, W = 12, 18, 24
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(31)
    gts = (2.0 + rng.standard_normal((T, H, W))).astype(np.float32)
    pds = (gts + 0.3 * rng.standard_normal((T, H, W))).astype(np.float32)
    grid = GridSpec(nlat=H, nlon=W)
    return gts, pds, grid.lat, grid.lon


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["r2", "r2_temporal", "r2_spatial", "pearson_r"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_pair_metrics_match_jax(fields, name, as_tensor):
    gts, pds, _, _ = fields
    args = (torch.from_numpy(gts), torch.from_numpy(pds)) if as_tensor else (gts, pds)
    got = getattr(tm, name)(*args)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _close(got, getattr(jm, name)(gts, pds))


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_r2_from_summed_stats_matches_jax_r2(fields, parts):
    """R^2 rebuilt from the sufficient statistics summed over parts (the
    data-parallel ranks' batches) is the JAX package's R^2 of the whole:
    1 - R^2 within 1e-5 relative (a sum of squares about 0 against one
    about the mean)."""
    gts, pds, _, _ = fields
    stats = sum(tm.r2_stats(torch.from_numpy(g), torch.from_numpy(p))
                for g, p in zip(np.array_split(gts, parts), np.array_split(pds, parts)))
    np.testing.assert_allclose(1.0 - tm.r2_from_stats(stats).item(),
                               1.0 - float(jm.r2(gts, pds)), rtol=1e-5)


@pytest.mark.parametrize("also_lon", [False, True])
def test_coslat_weighted_mean_matches_jax(fields, also_lon):
    gts, _, lat, _ = fields
    _close(tm.coslat_weighted_mean(gts, lat, also_lon=also_lon),
           jm.coslat_weighted_mean(gts, lat, also_lon=also_lon))


@pytest.mark.parametrize("band", [(-21, 21), (21, 61), (61, 90), (-90, -61)])
def test_lat_band_weighted_r2_matches_jax(fields, band):
    gts, pds, lat, _ = fields
    spatial = np.asarray(jm.r2_spatial(gts, pds))
    weight = gts.mean(axis=0)
    _close(tm.lat_band_weighted_r2(spatial, weight, lat, band),
           jm.lat_band_weighted_r2(spatial, weight, lat, band))


@pytest.mark.parametrize("region", sorted(jm.REGIONS))
def test_regional_slice_matches_jax(fields, region):
    gts, _, lat, lon = fields
    assert tm.REGIONS == jm.REGIONS
    got = tm.regional_slice(gts, lat, lon, region)
    want = np.asarray(jm.regional_slice(gts, lat, lon, region))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_exceedance_curve_and_sampling_match_jax(fields):
    gts, _, _, _ = fields
    for a, b in zip(tm.exceedance_curve(gts), jm.exceedance_curve(gts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.random_sampling(gts, 100), jm.random_sampling(gts, 100))
    assert tm.KGKG_TO_UGKG == jm.KGKG_TO_UGKG
