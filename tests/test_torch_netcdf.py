"""The port's netCDF-tree loaders (nasa_niswan_tpu_torch/data/netcdf.py,
ncfixture.py) against the JAX package's on synthetic daily-file trees of the
ModelE schema (H = 10, W = 16, 3 levels): the fixture files, the time
index, ``read_day_fields``, both lazy datasets (values, splits, the
feedback channel, the static channels, padding), ``pack_to_npz``,
``load_90days_nc`` with levels, ``build_static_attrs`` and
``json_normalizer``.  Every comparison is bit-equal."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import ncfixture as jfix  # noqa: E402
from nasa_niswan_tpu.data import ncio as jncio  # noqa: E402
from nasa_niswan_tpu.data import netcdf as jnc  # noqa: E402
from nasa_niswan_tpu_torch.data import catalog, ncfixture, ncio, netcdf  # noqa: E402

PAD = (12, 20)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_reader():
    """The JAX package's native reader loaded in this worker, whatever other
    workers build at the same time (tests/jax_native_reader.py)."""
    import jax_native_reader

    jax_native_reader.load()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("e33oma"))
    fields = ncfixture.write_fixture_tree(root, days=4, steps_per_day=8, H=10, W=16,
                                          levels=3, seed=0)
    static_dir = str(tmp_path_factory.mktemp("static"))
    paths = ncfixture.write_static_attrs_inputs(static_dir, H=10, W=16)
    static_path = os.path.join(static_dir, "static_attrs.nc")
    netcdf.build_static_attrs(paths["land_cover"], paths["lai"], paths["grid"], static_path)
    return root, fields, static_path


def _ns(index):
    return index.as_unit("ns").asi8


def test_fixture_tree_files_match_jax_byte_for_byte(tree, tmp_path):
    root, fields, _ = tree
    jroot = str(tmp_path / "j")
    jfields = jfix.write_fixture_tree(jroot, days=4, steps_per_day=8, H=10, W=16,
                                      levels=3, seed=0)
    names = sorted(os.path.basename(p) for p in glob.glob(root + "/*.nc"))
    assert names == sorted(os.path.basename(p) for p in glob.glob(jroot + "/*.nc"))
    assert len(names) == 20
    for n in names:
        with open(os.path.join(root, n), "rb") as a, open(os.path.join(jroot, n), "rb") as b:
            assert a.read() == b.read(), n
    for k, v in jfields.items():
        if k == "time":
            np.testing.assert_array_equal(fields[k].asi8, _ns(v))
        else:
            np.testing.assert_array_equal(fields[k], v)


def test_daily_filename_and_species_catalog_match_jax():
    from nasa_niswan_tpu.data import catalog as jcat

    assert catalog.FILE_FAMILIES == jcat.FILE_FAMILIES
    assert {k: vars(v) for k, v in catalog.SPECIES_VARS.items()} == {
        k: vars(v) for k, v in jcat.SPECIES_VARS.items()}
    for fam in catalog.FILE_FAMILIES:
        assert catalog.daily_filename("19500131", fam) == jcat.daily_filename("19500131", fam)


def test_load_time_index_matches_jax(tree):
    root, fields, _ = tree
    got, want = netcdf.load_time_index(root), jnc.load_time_index(root)
    assert len(got) == 32
    np.testing.assert_array_equal(got.asi8, _ns(want))
    np.testing.assert_array_equal(got.asi8, fields["time"].asi8)
    assert (got - got[0])[1] == 3 * 3600 * 10**9


@pytest.mark.parametrize("species", ["bcb", "clay", "seasalt"])
@pytest.mark.parametrize("levels", [None, 2])
def test_read_day_fields_matches_jax(tree, species, levels):
    root, fields, _ = tree
    day = fields["time"][8].strftime("%Y%m%d")
    got = netcdf.read_day_fields(root, day, species, levels=levels)
    want = jnc.read_day_fields(root, day, species, levels=levels)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "time":
            np.testing.assert_array_equal(got[k].asi8, _ns(want[k]))
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if levels:
        assert got["u"].shape == (8, 2, 10, 16)


def test_month_boundary_names_and_reads(tmp_path):
    """A tree that crosses Jan 31 -> Feb 1 names its files by the no-leap
    date of each day's first step, and reads back as the JAX package does."""
    root = str(tmp_path / "mb")
    ncfixture.write_fixture_tree(root, days=3, steps_per_day=4, H=6, W=8, levels=1,
                                 start_hours=29 * 24.0)
    days = sorted({os.path.basename(p).split(".")[0] for p in glob.glob(root + "/*.nc")})
    assert days == ["19500130", "19500131", "19500201"]
    got, want = netcdf.load_time_index(root), jnc.load_time_index(root)
    np.testing.assert_array_equal(got.asi8, _ns(want))
    assert [t.month for t in got] == list(np.asarray(want.month))
    ds = netcdf.LazyE33OMASequence(root, period="test", sequence_length=3, padding=None)
    jds = jnc.LazyE33OMASequence(root, period="test", sequence_length=3, padding=None)
    for i in range(len(jds)):
        for a, b in zip(ds[i], jds[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("period", ["train", "val", "test"])
@pytest.mark.parametrize("in_channels,transform", [(5, False), (6, False), (6, True)])
def test_lazy_single_step_matches_jax(tree, period, in_channels, transform):
    root = tree[0]
    kw = dict(period=period, in_channels=in_channels, transform=transform, padding=PAD)
    ds, jds = netcdf.LazyE33OMASingleStep(root, **kw), jnc.LazyE33OMASingleStep(root, **kw)
    assert len(ds) == len(jds) > 0
    np.testing.assert_array_equal(ds.times.asi8, _ns(jds.times))
    np.testing.assert_array_equal(ds.prev_times.asi8, _ns(jds.prev_times))
    for i in range(len(jds)):
        (x, y), (jx, jy) = ds[i], jds[i]
        assert x.shape == (in_channels, *PAD) and x.dtype == np.float32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("period", ["train", "val", "test"])
@pytest.mark.parametrize("in_channels,padding", [(5, PAD), (8, PAD), (7, None)])
def test_lazy_sequence_matches_jax(tree, period, in_channels, padding):
    root, _, static_path = tree
    kw = dict(period=period, sequence_length=6, in_channels=in_channels, padding=padding,
              static_attrs_path=static_path)
    ds, jds = netcdf.LazyE33OMASequence(root, **kw), jnc.LazyE33OMASequence(root, **kw)
    assert len(ds) == len(jds) > 0
    np.testing.assert_array_equal(ds.targets.asi8, _ns(jds.targets))
    for i in range(len(jds)):
        (x, y), (jx, jy) = ds[i], jds[i]
        assert x.shape == (6, in_channels, *(padding or (10, 16)))
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_lazy_sequence_needs_the_static_path(tree):
    with pytest.raises(ValueError, match="static"):
        netcdf.LazyE33OMASequence(tree[0], period="train", sequence_length=6, in_channels=8)


@pytest.mark.parametrize("levels", [None, 3])
def test_pack_to_npz_matches_jax(tree, tmp_path, levels):
    root = tree[0]
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    netcdf.pack_to_npz(root, a, "clay", levels=levels)
    jnc.pack_to_npz(root, b, "clay", levels=levels)
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fb.files:
            np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("levels", [None, 2, 3])
@pytest.mark.parametrize("fmt", ["netcdf3", "cdf5"])
def test_load_90days_nc_matches_jax(tmp_path, levels, fmt):
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d

    d = synthetic_e33oma_90d(T=12, H=10, W=16, nlev=3, seed=4)
    dims4, dims3 = ("time", "level", "lat", "lon"), ("time", "lat", "lon")
    variables = {k: (dims4 if d[k].ndim == 4 else dims3, d[k])
                 for k in ("u", "v", "omega", "prec", "bcb_src", "bcb_conc")}
    path = str(tmp_path / "E33OMA-90Days.nc")
    ncio.write_nc(path, {"time": 12, "level": 3, "lat": 10, "lon": 16}, variables,
                  time_values=np.arange(12) * 0.5, fmt=fmt)
    got, want = netcdf.load_90days_nc(path, levels=levels), jnc.load_90days_nc(path, levels=levels)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    lev = slice(None, levels) if levels else 0
    np.testing.assert_array_equal(got["u"], d["u"][:, lev])
    np.testing.assert_array_equal(got["prec"], d["prec"])


def test_load_90days_nc_names_missing_variables(tmp_path):
    path = str(tmp_path / "bad.nc")
    ncio.write_nc(path, {"time": 2, "lat": 3, "lon": 4},
                  {"u": (("time", "lat", "lon"), np.zeros((2, 3, 4), np.float32))},
                  time_values=[0.0, 1.0])
    with pytest.raises(ValueError, match="omega"):
        netcdf.load_90days_nc(path)


def test_static_attrs_builder_and_loader_match_jax(tree, tmp_path):
    root, _, static_path = tree
    paths = jfix.write_static_attrs_inputs(str(tmp_path / "in"), H=10, W=16)
    jpath = str(tmp_path / "static_jax.nc")
    jnc.build_static_attrs(paths["land_cover"], paths["lai"], paths["grid"], jpath)
    with open(static_path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    got, want = netcdf.load_static_attrs(static_path), jnc.load_static_attrs(jpath)
    assert got.shape == (5, 10, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("species", ["bcb", "clay", "seasalt"])
@pytest.mark.parametrize("transform", [False, True])
def test_json_normalizer_matches_jax(species, transform):
    got = netcdf.json_normalizer(species, transform=transform)
    want = jnc.json_normalizer(species, transform=transform)
    np.testing.assert_array_equal(got.x_mean, want.x_mean)
    np.testing.assert_array_equal(got.x_std, want.x_std)
    assert (got.y_mean, got.y_std) == (want.y_mean, want.y_std)


def test_netcdf4_tree_reads_like_netcdf3(tmp_path):
    """A netCDF4 (HDF5) tree reads through h5py to the same samples."""
    a, b = str(tmp_path / "nc3"), str(tmp_path / "nc4")
    ncfixture.write_fixture_tree(a, days=2, steps_per_day=4, H=6, W=8, levels=1)
    ncfixture.write_fixture_tree(b, days=2, steps_per_day=4, H=6, W=8, levels=1,
                                 fmt="netcdf4")
    x = netcdf.LazyE33OMASequence(a, period="train", sequence_length=2, padding=None)
    y = netcdf.LazyE33OMASequence(b, period="train", sequence_length=2, padding=None)
    for i in range(len(x)):
        for p, q in zip(x[i], y[i]):
            np.testing.assert_array_equal(p, q)
    assert jncio.open_nc(glob.glob(b + "/*.nc")[0]).time is not None
