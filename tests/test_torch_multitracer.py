"""The port's multi-tracer rollouts (nasa_niswan_tpu_torch/rollout/
multitracer.py) against the JAX package's and against S single-species
rollouts: per-species streams and the shared-meteorology variant, a
carry chained across two chunks, and the stacking helpers.

Shape: S = 3 species, 2 layers, hidden (8, 4), kernels (5, 3), C = 6,
grid (16, 24) padded to (20, 28).  Against JAX's XLA cell in f32: atol
2e-5 in physical units, the tolerance of tests/test_torch_rollout.py;
against the port's own single rollouts, bit-equal in f32 (the same ops on
the same values); the shared variant casts the meteorology once before the
loop and the single rollout per step, so in bf16 it is held to the single
rollout at 2e-3, tests/test_torch_rollout.py's bf16 tolerance."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.rollout import multitracer as jmt  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig  # noqa: E402
from nasa_niswan_tpu_torch.rollout import multitracer as tmt  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402

S, C, T = 3, 6, 4
GRID, PADDED = (16, 24), (20, 28)
LAYERS = dict(hidden_channels=(8, 4), kernel_sizes=(5, 3))
GEO = dict(padded_shape=PADDED, grid_shape=GRID)
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def species():
    rng = np.random.default_rng(17)
    met = (1.0 + rng.standard_normal((1, T, C - 1, *GRID))).astype(np.float32)
    emis = rng.random((S, 1, T, *GRID)).astype(np.float32)
    forcings = np.stack([np.concatenate([met, emis[s][:, :, None]], axis=2)
                         for s in range(S)])
    # the species share the meteorology's statistics and differ in the
    # emission slot and the target's
    met_mean = 0.1 * rng.standard_normal(C - 1)
    met_std = 1.0 + rng.random(C - 1)
    stats = [(np.append(met_mean, 0.5 + s).astype(np.float32),
              np.append(met_std, 1.0 + 0.5 * s).astype(np.float32), 0.2 * s, 1.0 + s)
             for s in range(S)]
    trees = [jax.tree.map(np.asarray, jm.convlstm_init(
        jax.random.PRNGKey(10 + s), jm.ConvLSTMConfig(C, cell_impl="xla", **LAYERS)))
             for s in range(S)]
    return met, emis, forcings, stats, trees


def _norms(stats, mod):
    return [mod.Normalizer(*s) for s in stats]


@pytest.mark.parametrize("shared", [False, True])
def test_multitracer_matches_jax(species, shared):
    met, emis, forcings, stats, trees = species
    jcfg = jm.ConvLSTMConfig(C, cell_impl="xla", **LAYERS)
    tcfg = ConvLSTMConfig(C, **LAYERS)
    jparams = jmt.stack_params(trees)
    tparams = tmt.stack_params([bridge.params_from_jax(t) for t in trees])
    if shared:
        jr = jmt.make_multitracer_rollout_shared(jcfg, _norms(stats, jdata), cell_impl=None, **GEO)
        tr = tmt.make_multitracer_rollout_shared(tcfg, _norms(stats, tdata), **GEO)
        args = (met, emis)
    else:
        jr = jmt.make_multitracer_rollout(jcfg, _norms(stats, jdata), cell_impl=None, **GEO)
        tr = tmt.make_multitracer_rollout(tcfg, _norms(stats, tdata), **GEO)
        args = (forcings,)
    h = T // 2
    if shared:
        half = [(met[:, :h], emis[:, :, :h]), (met[:, h:], emis[:, :, h:])]
    else:
        half = [(forcings[:, :, :h],), (forcings[:, :, h:],)]
    jst = tst = None
    for part in half:
        jp, jst = jr(jparams, *part, jst)
        tp, tst = tr(tparams, *part, tst)
        assert tuple(tp.shape) == (S, 1, T // 2, *GRID)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    for (h, c), (jh, jc) in zip(tst, jst):
        assert tuple(h.shape) == (S, 1, *PADDED, h.shape[-1])
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_multitracer_equals_single_rollouts(species, dtype, shared):
    met, emis, forcings, stats, trees = species
    cfg = ConvLSTMConfig(C, compute_dtype=dtype, **LAYERS)
    params = [bridge.params_from_jax(t) for t in trees]
    norms = _norms(stats, tdata)
    if shared:
        got, _ = tmt.make_multitracer_rollout_shared(cfg, norms, **GEO)(
            tmt.stack_params(params), met, emis)
    else:
        got, _ = tmt.make_multitracer_rollout(cfg, norms, **GEO)(
            tmt.stack_params(params), forcings)
    for s in range(S):
        want, _ = make_rollout_fn(cfg, norms[s], **GEO)(params[s], forcings[s])
        if shared and dtype == "bfloat16":
            np.testing.assert_allclose(got[s].numpy(), want.numpy(), atol=2e-3)
        else:
            assert torch.equal(got[s], want)


def test_stack_helpers_match_jax(species):
    _, _, _, stats, trees = species
    jp = jmt.stack_params(trees)
    tp = tmt.stack_params([bridge.params_from_jax(t) for t in trees])
    for cell_t, cell_j in zip(tp["cells"], jp["cells"]):
        for k in ("w_x", "w_h", "b"):
            np.testing.assert_array_equal(cell_t[k].numpy(), np.asarray(cell_j[k]))
    jn = jmt.stack_normalizers(_norms(stats, jdata))
    tn = tmt.stack_normalizers(_norms(stats, tdata))
    for f in ("x_mean", "x_std", "y_mean", "y_std"):
        np.testing.assert_array_equal(getattr(tn, f), getattr(jn, f))
