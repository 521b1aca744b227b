"""The port's OAT sensitivity sweep (nasa_niswan_tpu_torch/rollout/
sensitivity.py) against the JAX package's, serial and batched, and the
batched sweep against the serial one and against single rollouts.

Shape: 2 layers, hidden (8, 4), kernels (5, 3), C = 5, grid (16, 24)
padded to (20, 28), T = 4.  Against JAX's XLA cell in f32: atol 2e-5 (the
deltas are differences of predictions in physical units, the tolerance of
tests/test_torch_rollout.py); batched against serial in the port: f32
bit-equal, bf16 within 2e-3 (tests/test_torch_rollout.py's bf16
tolerance: a conv over a larger batch may sum in another order)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.rollout import autoregressive as jroll  # noqa: E402
from nasa_niswan_tpu.rollout import sensitivity as jsens  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig  # noqa: E402
from nasa_niswan_tpu_torch.rollout import sensitivity as tsens  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402

C, T, GRID, PADDED = 5, 4, (16, 24), (20, 28)
LAYERS = dict(hidden_channels=(8, 4), kernel_sizes=(5, 3))
GEO = dict(padded_shape=PADDED, grid_shape=GRID)
NAMES = ("u", "v", "w", "prec", "src")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    forcings = (1.0 + rng.standard_normal((1, T, C, *GRID))).astype(np.float32)
    stats = (rng.standard_normal(C).astype(np.float32),
             (1.0 + rng.random(C)).astype(np.float32), 0.4, 2.0)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(
        jax.random.PRNGKey(4), jm.ConvLSTMConfig(C, cell_impl="xla", **LAYERS)))
    return forcings, stats, tree, bridge.params_from_jax(tree)


@pytest.mark.parametrize("batched", [False, True])
def test_oat_matches_jax(setup, batched):
    forcings, stats, tree, params = setup
    jr = jroll.make_rollout_fn(jm.ConvLSTMConfig(C, cell_impl="xla", **LAYERS),
                               jdata.Normalizer(*stats), cell_impl=None, **GEO)
    tr = make_rollout_fn(ConvLSTMConfig(C, **LAYERS), tdata.Normalizer(*stats), **GEO)
    want = jsens.oat_sensitivity(jr, tree, forcings, batched=batched)
    got = tsens.oat_sensitivity(tr, params, forcings, batched=batched)
    assert sorted(got) == sorted(want) == sorted(NAMES)
    for k in NAMES:
        assert got[k].shape == want[k].shape == (1, T, *GRID)
        np.testing.assert_allclose(got[k], want[k], atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_oat_equals_serial_and_single_rollouts(setup, dtype):
    forcings, stats, _, params = setup
    tr = make_rollout_fn(ConvLSTMConfig(C, compute_dtype=dtype, **LAYERS),
                         tdata.Normalizer(*stats), **GEO)
    serial = tsens.oat_sensitivity(tr, params, forcings, channels=[0, 3])
    batched = tsens.oat_sensitivity(tr, params, torch.from_numpy(forcings),
                                    channels=[0, 3], batched=True)
    assert sorted(serial) == sorted(batched) == ["prec", "u"]
    for k in serial:
        if dtype == "float32":
            np.testing.assert_array_equal(batched[k], serial[k])
        else:
            np.testing.assert_allclose(batched[k], serial[k], atol=2e-3)
    base, _ = tr(params, forcings)
    x = forcings.copy()
    x[:, :, 3] *= 1.05
    pert, _ = tr(params, x)
    np.testing.assert_array_equal(serial["prec"], np.abs(pert.numpy() - base.numpy()))


def test_batched_oat_needs_batch_one(setup):
    forcings, stats, _, params = setup
    tr = make_rollout_fn(ConvLSTMConfig(C, **LAYERS), tdata.Normalizer(*stats), **GEO)
    with pytest.raises(ValueError, match="B == 1"):
        tsens.oat_sensitivity(tr, params, np.concatenate([forcings, forcings]),
                              batched=True)
