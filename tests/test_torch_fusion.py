"""Level fusion and preprocessing of the port (data/fusion.py,
``SingleStepDataset`` and ``make_preprocess_fn`` in data/dataset.py,
data/monthly.py, data/stats_tools.py, data/statistics.py) against the JAX
package's.  Fusion, the dataset items, the monthly table and the statistics
are bit-equal; ``make_preprocess_fn`` agrees within 1e-6 relative (f32,
the same formulas)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.data import fusion as jfusion  # noqa: E402
from nasa_niswan_tpu.data import monthly as jmonthly  # noqa: E402
from nasa_niswan_tpu.data import statistics as jstats  # noqa: E402
from nasa_niswan_tpu.data import stats_tools as jtools  # noqa: E402
from nasa_niswan_tpu.data.ncio import decode_noleap_times as j_decode  # noqa: E402
from nasa_niswan_tpu.data.ncfixture import write_monthly_fixture as j_write_monthly  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.data import fusion, monthly, ncfixture, statistics, stats_tools  # noqa: E402
from nasa_niswan_tpu_torch.data.ncio import decode_noleap_times  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    return synthetic_e33oma_90d(T=40, H=10, W=16, nlev=3, seed=5)


@pytest.fixture(scope="module")
def surface():
    return synthetic_e33oma_90d(T=40, H=10, W=16, nlev=1, seed=6)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("species", ["bcb", "clay"])
def test_fuse_levels_matches_jax(data, levels, species):
    d = dict(data)
    d["clay_src"], d["clay_conc"] = d["bcb_src"] * 2, d["bcb_conc"] * 3
    xs, y = fusion.fuse_levels(d, species, levels=levels)
    jxs, jy = jfusion.fuse_levels(d, species, levels=levels)
    assert xs.shape == (40, fusion.fusion_channel_count(levels), 10, 16)
    assert xs.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(y, jy)


def test_fuse_levels_surface_arrays_and_errors(data):
    d = {k: (v[:, 0] if v.ndim == 4 else v) for k, v in data.items()}
    xs, y = fusion.fuse_levels(d, levels=1)
    jxs, jy = jfusion.fuse_levels(d, levels=1)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError, match="levels"):
        fusion.fuse_levels(data, levels=4)
    for n in (1, 5, 20):
        assert fusion.fusion_channel_count(n) == jfusion.fusion_channel_count(n)
    assert fusion.fusion_channel_count(20) == 62


@pytest.mark.parametrize("period", ["train", "val", "test"])
@pytest.mark.parametrize("in_channels,transform,padding,host",
                         [(5, False, None, False), (6, False, None, False),
                          (6, True, (12, 20), True), (5, False, (12, 20), True)])
def test_single_step_dataset_matches_jax(surface, period, in_channels, transform, padding,
                                         host):
    data = surface
    kw = dict(period=period, in_channels=in_channels, transform=transform,
              padding=padding, host_preprocessed=host, seed=3)
    ds, jds = tdata.SingleStepDataset(data, **kw), jdata.SingleStepDataset(data, **kw)
    assert len(ds) == len(jds) > 0
    for a, b in ((ds.normalizer.x_mean, jds.normalizer.x_mean),
                 (ds.normalizer.x_std, jds.normalizer.x_std)):
        np.testing.assert_array_equal(a, b)
    assert (ds.normalizer.y_mean, ds.normalizer.y_std) == (jds.normalizer.y_mean,
                                                           jds.normalizer.y_std)
    for i in range(len(jds)):
        for a, b in zip(ds[i], jds[i]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(ds.feedback_stream(), jds.feedback_stream()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("species", ["bcb", "clay"])
def test_dynamic_channels_match_jax(surface, species):
    """The five dynamic channels, named and stacked in the JAX order."""
    assert tdata.DYNAMIC_CHANNELS == jdata.DYNAMIC_CHANNELS
    d = dict(surface)
    d["clay_src"], d["clay_conc"] = d["bcb_src"] * 2, d["bcb_conc"] * 3
    for a, b in zip(tdata._stack_inputs(d, species), jdata._stack_inputs(d, species)):
        np.testing.assert_array_equal(a, b)


def test_single_step_dataset_rejects_other_channel_counts(surface):
    with pytest.raises(ValueError, match="5 or 6"):
        tdata.SingleStepDataset(surface, period="train", in_channels=7)


@pytest.mark.parametrize("lead", [(3,), (2, 4)])
@pytest.mark.parametrize("static,padded", [(False, None), (True, (12, 20)), (False, (12, 20))])
def test_make_preprocess_fn_matches_jax(surface, lead, static, padded):
    """(B, [T,] C, H, W) raw batches -> normalized, padded NHWC, and the
    normalized targets; f32 within 1e-6 relative (XLA may divide by the
    std as a product with its reciprocal: one f32 ulp apart)."""
    ds = jdata.SequenceDataset(surface, period="train", sequence_length=4)
    st = surface["static"][:2] if static else None
    rng = np.random.default_rng(9)
    x = rng.standard_normal((*lead, 5, 10, 16)).astype(np.float32) * 3 + 1
    y = rng.standard_normal((lead[0], 10, 16)).astype(np.float32)
    norm = tdata.Normalizer(x_mean=ds.normalizer.x_mean, x_std=ds.normalizer.x_std,
                            y_mean=ds.normalizer.y_mean, y_std=ds.normalizer.y_std)
    gx, gy = tdata.make_preprocess_fn(norm, padded, static=st)(x, y)
    wx, wy = jdata.make_preprocess_fn(ds.normalizer, padded, static=st)(x, y)
    assert tuple(gx.shape) == wx.shape and gx.dtype == torch.float32
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6, atol=1e-6)


def test_statistics_json_and_species_stats_match_jax():
    assert statistics.load_statistics() == {
        s: {k: statistics.VariableStats(**vars(v)) for k, v in d.items()}
        for s, d in jstats.load_statistics().items()}
    for species in statistics.SPECIES:
        for transform in (False, True):
            got = statistics.species_stats(species, transform=transform)
            want = jstats.species_stats(species, transform=transform)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert vars(got[2]) == vars(want[2])
    with pytest.raises(ValueError, match="species"):
        statistics.species_stats("dust")


def test_compute_statistics_matches_jax(data, tmp_path):
    for surface_only in (True, False):
        got = stats_tools.compute_statistics(data, surface_only=surface_only)
        want = jtools.compute_statistics(data, surface_only=surface_only)
        assert got == want
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    stats_tools.write_statistics(got, a)
    jtools.write_statistics(want, b)
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)


@pytest.mark.parametrize("months", [12, 15])
def test_monthly_attrs_table_and_merge_match_jax(tmp_path, months):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    oracle = ncfixture.write_monthly_fixture(a, months=months, H=6, W=8)
    j_write_monthly(b, months=months, H=6, W=8)
    m, fields = monthly.load_monthly_attrs(a)
    jm, jfields = jmonthly.load_monthly_attrs(b)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(m, oracle["month"])
    for k in jfields:
        np.testing.assert_array_equal(fields[k], jfields[k])
    table = monthly.monthly_climatology(m, fields)
    np.testing.assert_array_equal(table, jmonthly.monthly_climatology(jm, jfields))
    hours = np.arange(0, 24 * 365, 24 * 20.0)
    idx = monthly.month_index(decode_noleap_times(hours, "hours since 1950-01-01"))
    np.testing.assert_array_equal(
        idx, jmonthly.month_index(j_decode(hours, "hours since 1950-01-01")))
    for channels in (None, (0, 3)):
        got = monthly.merge_monthly(table, idx, channels=channels)
        want = jmonthly.merge_monthly(table, idx, channels=channels)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert monthly.fractional_year_to_date(1950.5) == jmonthly.fractional_year_to_date(1950.5)
