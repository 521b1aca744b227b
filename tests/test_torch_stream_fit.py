"""The slice as a whole: a small fused config read from a packed ``.nc``
trains through the port's streamed ``fit`` as the JAX package's
``fit(device_resident=False)`` does.

Config: levels 2 (C = 3 * 2 + 2 = 8), 2 layers, hidden 8, kernels 3, grid
10 x 16 padded to 12 x 20, sequence length 6, batch 2, f32.  The packed file
holds 24 steps: 16 training windows (8 steps an epoch) and 3 validation
windows (the last batch padded).  From the same weights (``bridge.py``)
the epoch-1 loss and R^2 agree within 1e-4 relative; the port's resident and
streamed routes agree bit for bit; the CLI trains an epoch from the file."""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.fusion import fuse_levels as j_fuse_levels  # noqa: E402
from nasa_niswan_tpu.data.dataset import SequenceDataset as JSequenceDataset  # noqa: E402
from nasa_niswan_tpu.data.netcdf import load_90days_nc as j_load_90days_nc  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import SequenceDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.fusion import fuse_levels  # noqa: E402
from nasa_niswan_tpu_torch.data.ncio import write_nc  # noqa: E402
from nasa_niswan_tpu_torch.data.netcdf import load_90days_nc  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.train import __main__ as cli  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402

LEVELS, C = 2, 8
MODEL = dict(in_channels=C, hidden_channels=(8, 8), kernel_sizes=(3, 3))
CFG = dict(model="LSTM-s", in_channels=C, hidden_channels=(8, 8), kernel_size=(3, 3),
           num_layers=2, sequence_length=6, input_size=(12, 20), batch_size=2,
           num_epochs=1, checkpoint_every=0, levels=LEVELS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A packed E33OMA-90Days-style netCDF3 file of 24 steps, 3 levels."""
    d = synthetic_e33oma_90d(T=24, H=10, W=16, nlev=3, seed=11)
    dims4, dims3 = ("time", "level", "lat", "lon"), ("time", "lat", "lon")
    path = str(tmp_path_factory.mktemp("packed") / "E33OMA-90Days.nc")
    write_nc(path, {"time": 24, "level": 3, "lat": 10, "lon": 16},
             {k: (dims4 if d[k].ndim == 4 else dims3, d[k])
              for k in ("u", "v", "omega", "prec", "bcb_src", "bcb_conc")},
             time_values=np.arange(24) * 0.5)
    return path


def _datasets(make, fused):
    return tuple(make(fused, period=p, sequence_length=6) for p in ("train", "val"))


def _port_fit(packed, tmp, params, device_resident):
    xs, y = fuse_levels(load_90days_nc(packed, levels=LEVELS), levels=LEVELS)
    train, val = _datasets(SequenceDataset, (xs, y))
    cfg = TrainConfig(snapshot_dir=str(tmp), device="cpu", **CFG)
    out = tloop.fit(build_model("LSTM-s", **MODEL), train, val, cfg, device="cpu",
                    init_params=params, device_resident=device_resident, verbose=False)
    return out


def _copy(params):
    return {"cells": [{k: v.detach().clone().requires_grad_(True) for k, v in c.items()}
                      for c in params["cells"]],
            "head": {k: v.detach().clone().requires_grad_(True)
                     for k, v in params["head"].items()}}


@pytest.fixture(scope="module")
def jax_fit(packed, tmp_path_factory):
    """One epoch of the JAX package's streamed fit, from seeded weights."""
    data = j_load_90days_nc(packed, levels=LEVELS)
    train, val = _datasets(JSequenceDataset, j_fuse_levels(data, levels=LEVELS))
    bundle = j_build_model("LSTM-s", **MODEL)
    params, _ = bundle.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    cfg = JTrainConfig(snapshot_dir=str(tmp_path_factory.mktemp("jsnap")), **CFG)
    out = jloop.fit(bundle, train, val, cfg, init_params=params, init_state=None,
                    device_resident=False, verbose=False)
    return init, out["logger"]


def test_streamed_fit_matches_jax(packed, jax_fit, tmp_path):
    init, jlog = jax_fit
    params = bridge.params_from_jax(init)
    for t in param_leaves(params):
        t.requires_grad_(True)
    log = _port_fit(packed, tmp_path, params, device_resident=False)["logger"]
    for key in ("MSELoss", "r2_score", "r2_score_val"):
        np.testing.assert_allclose(log[key], jlog[key], rtol=1e-4)


def test_resident_and_streamed_routes_agree_bit_for_bit(packed, jax_fit, tmp_path):
    params = bridge.params_from_jax(jax_fit[0])
    for t in param_leaves(params):
        t.requires_grad_(True)
    p_res, p_str = _copy(params), _copy(params)
    res = _port_fit(packed, tmp_path / "r", p_res, device_resident=True)
    stm = _port_fit(packed, tmp_path / "s", p_str, device_resident=None)
    assert stm["logger"] == res["logger"]
    for a, b in zip(param_leaves(p_res), param_leaves(p_str)):
        assert torch.equal(a, b)
    # None takes the resident route on the CPU: force the streamed one too
    p_forced = _copy(params)
    forced = _port_fit(packed, tmp_path / "f", p_forced, device_resident=False)
    assert forced["logger"] == res["logger"]
    for a, b in zip(param_leaves(p_res), param_leaves(p_forced)):
        assert torch.equal(a, b)


def test_cli_trains_config2_from_nc(packed, tmp_path):
    """``--data-path x.nc --levels 2 --device cpu`` fuses the levels
    (in_channels becomes 3 * 2 + 2) and trains an epoch."""
    snap = str(tmp_path / "snap")
    cfg = TrainConfig(snapshot_dir=snap, device="cpu", data_path=packed,
                      **dict(CFG, in_channels=5))
    assert cfg.in_channels == C
    out = cli.main(cfg)
    assert len(out["logger"]["MSELoss"]) == 1
    assert np.isfinite(out["logger"]["MSELoss"][0])
    assert os.path.exists(os.path.join(snap, "logger.npy"))
    assert out["params"]["cells"][0]["w_x"].shape[2] == C


def test_resident_route_needs_frame_slabs(packed, tmp_path):
    """A dataset without a frame slab (as the lazy netCDF datasets) cannot
    take the resident route; None streams it."""
    xs, y = fuse_levels(load_90days_nc(packed, levels=LEVELS), levels=LEVELS)
    train, val = _datasets(SequenceDataset, (xs, y))

    class NoSlab:
        def __init__(self, ds):
            self.ds, self.normalizer = ds, ds.normalizer

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            return self.ds[i]

    cfg = TrainConfig(snapshot_dir=str(tmp_path), device="cpu", **CFG)
    bundle = build_model("LSTM-s", **MODEL)
    with pytest.raises(ValueError, match="frame slabs"):
        tloop.fit(bundle, NoSlab(train), NoSlab(val), cfg, device="cpu",
                  device_resident=True, verbose=False)
    assert not tloop.slabs_fit((NoSlab(train), val), torch.device("cpu"))
