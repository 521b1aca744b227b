"""The port's netCDF I/O (nasa_niswan_tpu_torch/data/ncio.py and
ncio_native.py) against the JAX package's: the no-leap time decoding to the
nanosecond, ``write_nc`` -> ``open_nc`` in netCDF3, CDF-5 and netCDF4 both
ways between the packages (bit-equal), the native reader against scipy,
where the native reader is built, and that the port's data modules import
and read netCDF3 without pandas or h5py.

Sizes: a few 3 x 2 x 4 x 5 variables; every comparison is exact."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from nasa_niswan_tpu.data import ncio as jncio
from nasa_niswan_tpu_torch.data import ncio, ncio_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_native_reader():
    """The JAX package's native reader loaded in this worker, whatever other
    workers build at the same time (tests/jax_native_reader.py)."""
    import jax_native_reader

    jax_native_reader.load()


# (values, units, calendar): the units tests/test_netcdf_real.py uses, hours
# since with fractional steps, seconds since with a time-of-day base, days
# across Feb 28 and a year end, and the standard calendar before its base
DECODE_CASES = [
    (np.arange(0, 96) * 0.5, "hours since 1950-01-01", "noleap"),
    (np.random.default_rng(0).uniform(0, 2 * 8760, 200), "hours since 1950-01-01", "noleap"),
    ([0, 1800, 3600, 86399.5], "seconds since 1950-06-15 12:30:00", "365_day"),
    ([0.0, 1.0, 2.0, 364.9999, 365.0], "days since 1951-02-27", "noleap"),
    (np.random.default_rng(1).uniform(-5e6, 5e6, 100), "seconds since 2000-03-01 06:00:00",
     "standard"),
    (np.arange(0, 48) * 30.0, "minutes since 1952-12-31 23:00", "365day"),
]


def _ns(index):
    """Instants as int64 nanoseconds: a port ``TimeIndex`` as it is, the JAX
    package's pandas index converted (pandas may keep coarser units)."""
    if isinstance(index, ncio.TimeIndex):
        return index.asi8
    return index.as_unit("ns").asi8


@pytest.mark.parametrize("values,units,calendar", DECODE_CASES)
def test_decode_noleap_times_matches_jax_to_the_nanosecond(values, units, calendar):
    want = jncio.decode_noleap_times(values, units, calendar)
    got = ncio.decode_noleap_times(values, units, calendar)
    np.testing.assert_array_equal(got.asi8, _ns(want))
    assert len(got) == len(want)
    assert [t.strftime("%Y%m%d %H:%M:%S") for t in got] == [
        t.strftime("%Y%m%d %H:%M:%S") for t in want]
    np.testing.assert_array_equal(got.month, np.asarray(want.month))
    assert got[3].value == want[3].as_unit("ns").value and got[3].month == want[3].month
    np.testing.assert_array_equal(got[1:4].asi8, _ns(want[1:4]))
    np.testing.assert_array_equal(got[np.array([2, 0])].asi8, _ns(want[np.array([2, 0])]))
    both = got.append([got[:2]])
    np.testing.assert_array_equal(both.asi8, _ns(want.append([want[:2]])))
    np.testing.assert_array_equal(got - got[1], _ns(want - want[1]))


def test_decode_rejects_bad_units():
    with pytest.raises(ValueError, match="unparseable"):
        ncio.decode_noleap_times([0.0], "fortnights", "noleap")
    with pytest.raises(ValueError, match="unsupported"):
        ncio.decode_noleap_times([0.0], "weeks since 1950-01-01", "noleap")


def _sample():
    rng = np.random.default_rng(3)
    return {
        "u": (("time", "level", "lat", "lon"),
              rng.standard_normal((3, 2, 4, 5)).astype(np.float32)),
        "prec": (("time", "lat", "lon"), rng.standard_normal((3, 4, 5)).astype(np.float32)),
        "mask": (("lat", "lon"), np.arange(20, dtype=np.int32).reshape(4, 5)),
        "depth": (("level",), np.array([1.5, 2.5])),
    }


def _assert_same_file(got, want):
    assert sorted(got.variables) == sorted(want.variables)
    for n in want.variables:
        np.testing.assert_array_equal(got[n], want[n])
        assert got[n].dtype == want[n].dtype, n
        assert got.dims[n] == want.dims[n], n
    assert sorted(got.data_vars) == sorted(want.data_vars)
    if want.time is None:
        assert got.time is None
    else:
        np.testing.assert_array_equal(got.time.asi8, _ns(want.time))


@pytest.mark.parametrize("fmt", ["netcdf3", "cdf5", "netcdf4"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_write_open_roundtrip_between_packages(tmp_path, fmt, writer):
    """A file written by one package is read bit-equal by the other, and
    by itself, in each format."""
    path = str(tmp_path / f"{fmt}.nc")
    write = (ncio if writer == "port" else jncio).write_nc
    write(path, {"time": 3, "level": 2, "lat": 4, "lon": 5}, _sample(),
          time_values=np.array([0.0, 0.5, 1.0]), time_units="hours since 1950-01-01",
          fmt=fmt)
    got, want = ncio.open_nc(path), jncio.open_nc(path)
    _assert_same_file(got, want)
    for name, (_dims, arr) in _sample().items():
        np.testing.assert_array_equal(got[name], arr)


def test_native_reader_matches_scipy(tmp_path):
    if not ncio_native.available():
        pytest.skip("the native reader did not build (no g++)")
    path = str(tmp_path / "a.nc")
    ncio.write_nc(path, {"time": 3, "level": 2, "lat": 4, "lon": 5}, _sample(),
                  time_values=np.array([0.0, 0.5, 1.0]))
    before = ncio_native.reads
    _assert_same_file(ncio_native.open_nc_native(path), ncio._open_scipy(path))
    assert ncio_native.reads == before + 1
    part = ncio_native.read_vars(path, ["u"], levels=1)
    np.testing.assert_array_equal(part["u"], _sample()["u"][1][:, :1])
    np.testing.assert_array_equal(ncio_native.read_var_slice(path, "prec", 1, 2),
                                  _sample()["prec"][1][1:3])


def test_open_nc_env_opt_out_reads_through_scipy(tmp_path, monkeypatch):
    path = str(tmp_path / "a.nc")
    ncio.write_nc(path, {"time": 3, "level": 2, "lat": 4, "lon": 5}, _sample(),
                  time_values=np.array([0.0, 0.5, 1.0]))
    a = ncio.open_nc(path)
    monkeypatch.setenv("NISWAN_NO_NATIVE_NC", "1")
    before = ncio_native.reads
    _assert_same_file(ncio.open_nc(path), a)
    assert ncio_native.reads == before


def test_native_build_writes_under_build_only(tmp_path, monkeypatch):
    """The port compiles native/nc3read.cpp into its own directory through
    a name of its own process and thread, then os.replace: it never writes
    under native/ (the JAX package's library lives there)."""
    assert ncio_native.BUILD_DIR == __import__("pathlib").Path(ROOT) / "build" / "nc3read"
    monkeypatch.setattr(ncio_native, "BUILD_DIR", tmp_path / "build" / "nc3read")
    written = []
    real_run, real_replace = ncio_native.subprocess.run, ncio_native.os.replace

    def run(cmd, **kw):
        written.append(cmd[cmd.index("-o") + 1])
        return real_run(cmd, **kw)

    def replace(src, dst):
        written.append(str(dst))
        return real_replace(src, dst)

    monkeypatch.setattr(ncio_native.subprocess, "run", run)
    monkeypatch.setattr(ncio_native.os, "replace", replace)
    so = ncio_native.build()
    if so is None:
        pytest.skip("g++ missing or the build failed")
    assert so.is_file() and so.parent == tmp_path / "build" / "nc3read"
    assert len(written) == 2 and str(os.getpid()) in written[0]
    assert written[1] == str(so)
    assert all(os.path.dirname(w) == str(so.parent) for w in written)
    assert not any("native" + os.sep in w for w in written)


def test_native_reader_leaves_the_jax_library_alone(tmp_path):
    """Using the port's native reader leaves native/libnc3read.so's mtime
    unchanged (and creates no file there)."""
    lib = os.path.join(ROOT, "native", "libnc3read.so")
    before = os.stat(lib).st_mtime_ns if os.path.exists(lib) else None
    listing = sorted(os.listdir(os.path.join(ROOT, "native")))
    if not ncio_native.available():
        pytest.skip("the native reader did not build (no g++)")
    path = str(tmp_path / "a.nc")
    ncio.write_nc(path, {"lat": 4, "lon": 5}, {"mask": _sample()["mask"]})
    assert ncio_native.open_nc_native(path) is not None
    assert str(ncio_native.library_path()).startswith(os.path.join(ROOT, "build") + os.sep)
    after = os.stat(lib).st_mtime_ns if os.path.exists(lib) else None
    assert after == before
    assert [n for n in sorted(os.listdir(os.path.join(ROOT, "native"))) if n not in listing] == []


def test_hdf5_without_h5py_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / "a.nc")
    ncio.write_nc(path, {"lat": 4, "lon": 5}, {"mask": _sample()["mask"]}, fmt="netcdf4")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        ncio.open_nc(path)


def test_port_data_modules_need_neither_pandas_nor_h5py(tmp_path):
    """In a fresh interpreter where pandas and h5py cannot be imported, every
    data module of the port imports, a netCDF3 fixture tree reads through
    the lazy dataset, and a packed .nc loads: the card's installation (no
    pandas or h5py needed) suffices."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["pandas"] = None
        sys.modules["h5py"] = None
        sys.path.insert(0, {ROOT!r})
        import importlib
        for m in ("catalog", "dataset", "fusion", "monthly", "ncfixture", "ncio",
                  "ncio_native", "netcdf", "pipeline", "statistics", "stats_tools",
                  "synthetic"):
            importlib.import_module("nasa_niswan_tpu_torch.data." + m)
        import nasa_niswan_tpu_torch.train.__main__
        from nasa_niswan_tpu_torch.data import ncfixture, netcdf, ncio
        from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
        root = {str(tmp_path / "tree")!r}
        ncfixture.write_fixture_tree(root, days=2, steps_per_day=4, H=6, W=8, levels=2)
        ds = netcdf.LazyE33OMASequence(root, period="train", sequence_length=2,
                                       padding=(8, 12))
        x, y = ds[0]
        assert x.shape == (2, 5, 8, 12) and y.shape == (6, 8), (x.shape, y.shape)
        d = synthetic_e33oma_90d(T=4, H=6, W=8, nlev=2, seed=0)
        dims = {{"time": 4, "level": 2, "lat": 6, "lon": 8}}
        v = {{k: (("time", "level", "lat", "lon") if d[k].ndim == 4 else
                 ("time", "lat", "lon"), d[k]) for k in ("u", "v", "omega", "prec",
                                                     "bcb_src", "bcb_conc")}}
        ncio.write_nc(root + "/packed.nc", dims, v, time_values=[0.0, 1, 2, 3])
        out = netcdf.load_90days_nc(root + "/packed.nc", levels=2)
        assert out["u"].shape == (4, 2, 6, 8)
        assert "pandas" not in sys.modules or sys.modules["pandas"] is None
        print("ok")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
