"""The port's serving artifacts and carry files (nasa_niswan_tpu_torch/
rollout/export.py): a ``.pt2`` exported on the CPU serves what the live
rollout serves, chunk after chunk through its carry, and the carry
``.npz`` round-trips with the JAX package's ``save_rollout_state`` /
``load_rollout_state`` in both directions.

Shape: 2 layers, hidden (8, 4), kernels (5, 3), C = 8, grid (16, 24)
padded to (20, 28).  The artifact runs the same plain ops as the live
rollout on the CPU, so the two are held bit-equal."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.rollout import export as jexp  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig  # noqa: E402
from nasa_niswan_tpu_torch.rollout import export as texp  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402

C, GRID, PADDED, CHUNK = 8, (16, 24), (20, 28), 3
LAYERS = dict(hidden_channels=(8, 4), kernel_sizes=(5, 3))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    forcings = (1.0 + rng.standard_normal((1, 2 * CHUNK, C, *GRID))).astype(np.float32)
    static = rng.random((2, *GRID)).astype(np.float32)
    norm = Normalizer(rng.standard_normal(C).astype(np.float32),
                      (1.0 + rng.random(C)).astype(np.float32), 0.3, 1.7)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(
        jax.random.PRNGKey(2), jm.ConvLSTMConfig(C + 2, **LAYERS)))
    return forcings, static, norm, bridge.params_from_jax(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_rollout_equals_the_live_rollout(setup, tmp_path, dtype):
    forcings, static, norm, params = setup
    cfg = ConvLSTMConfig(C + 2, compute_dtype=dtype, **LAYERS)
    path = str(tmp_path / "r.pt2")
    size = texp.export_rollout(cfg, norm, params, batch=1, chunk_steps=CHUNK,
                               n_channels=C, grid_shape=GRID, padded_shape=PADDED,
                               static=static, path=path)
    assert size > 0
    fn, sig = texp.load_rollout_info(path)
    assert sig == (1, CHUNK, C, *GRID)
    live = make_rollout_fn(cfg, norm, padded_shape=PADDED, grid_shape=GRID, static=static)
    state = texp.initial_rollout_state(cfg, 1, PADDED)
    live_state = None
    for s in (0, CHUNK):  # two chunks through the carry
        p, state = fn(forcings[:, s : s + CHUNK], state)
        q, live_state = live(params, forcings[:, s : s + CHUNK], live_state)
        assert torch.equal(p, q)
        for (h, c), (lh, lc) in zip(state, live_state):
            assert torch.equal(h, lh) and torch.equal(c, lc)
    assert fn.runner.captures == 0  # the CPU runs the program without a graph


def test_load_rollout_runs_without_the_model(setup, tmp_path):
    """The loaded program needs no parameters: only the artifact."""
    forcings, static, norm, params = setup
    cfg = ConvLSTMConfig(C + 2, **LAYERS)
    path = str(tmp_path / "r.pt2")
    texp.export_rollout(cfg, norm, params, batch=1, chunk_steps=CHUNK, n_channels=C,
                        grid_shape=GRID, padded_shape=PADDED, static=static, path=path)
    preds, state = texp.load_rollout(path)(forcings[:, :CHUNK],
                                           texp.initial_rollout_state(cfg, 1, PADDED))
    assert tuple(preds.shape) == (1, CHUNK, *GRID) and bool(torch.isfinite(preds).all())
    assert [tuple(h.shape) for h, _ in state] == [(1, *PADDED, 8), (1, *PADDED, 4)]


def test_state_spec_matches_jax():
    cfg = ConvLSTMConfig(C, **LAYERS)
    want = jexp.rollout_state_spec(jm.ConvLSTMConfig(C, **LAYERS), 2, PADDED)
    got = texp.rollout_state_spec(cfg, 2, PADDED)
    for (h, c), (jh, jc) in zip(got, want):
        assert tuple(h.shape) == jh.shape and tuple(c.shape) == jc.shape
        assert h.dtype == torch.float32 and jh.dtype == np.float32


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_npz_round_trips_between_packages(tmp_path, with_prev, writer):
    rng = np.random.default_rng(3)
    state = [(rng.standard_normal((1, *PADDED, hc)).astype(np.float32),
              rng.standard_normal((1, *PADDED, hc)).astype(np.float32)) for hc in (8, 4)]
    prev = rng.standard_normal((1, *GRID)).astype(np.float32) if with_prev else None
    path = str(tmp_path / "carry.npz")
    if writer == "jax":
        jexp.save_rollout_state(path, state, prev_norm=prev)
    else:
        texp.save_rollout_state(path, [(torch.from_numpy(h), torch.from_numpy(c))
                                       for h, c in state],
                                prev_norm=None if prev is None else torch.from_numpy(prev))
    for load in (jexp.load_rollout_state, texp.load_rollout_state):
        got, got_prev = load(path)
        for (h, c), (wh, wc) in zip(got, state):
            np.testing.assert_array_equal(np.asarray(h), wh)
            np.testing.assert_array_equal(np.asarray(c), wc)
        assert (got_prev is None) == (prev is None)
        if prev is not None:
            np.testing.assert_array_equal(np.asarray(got_prev), prev)
