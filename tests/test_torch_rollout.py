"""The serving slice as a whole: the PyTorch port's ``make_rollout_fn``
against the JAX package's, on the same weights and raw forcings, plus the
port's own carry, streaming and import contracts.

Shape: 3 layers, hidden (8, 4, 4), kernels (5, 3, 3), C = 8 (the 2-level
fusion layout 3*2 + 2), grid (16, 24) padded to (20, 28).  The JAX bf16
reference runs its fused kernel in Pallas interpret mode."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.rollout import autoregressive as jro  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.models import convlstm as tm  # noqa: E402
from nasa_niswan_tpu_torch.ops import convlstm_cell  # noqa: E402
from nasa_niswan_tpu_torch.rollout import autoregressive as tro  # noqa: E402

C = 3 * 2 + 2
N_STATIC = 2
GRID = (16, 24)
PADDED = (20, 28)
T = 6
LAYERS = dict(hidden_channels=(8, 4, 4), kernel_sizes=(5, 3, 3))
GEO = dict(padded_shape=PADDED, grid_shape=GRID)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20)
    forcings = (3.0 + 2.0 * rng.standard_normal((2, T, C, *GRID))).astype(np.float32)
    static = rng.random((N_STATIC, *GRID)).astype(np.float32)
    stats = (
        np.full(C, 3.0, np.float32) + 0.1 * rng.standard_normal(C).astype(np.float32),
        (2.0 + rng.random(C)).astype(np.float32),
        0.7,
        2.5,
    )
    return forcings, static, stats


def _pair(dtype="float32", with_static=False, seed=0, cell_impl="xla"):
    """JAX and port configs with the same weights (drawn by JAX)."""
    in_ch = C + (N_STATIC if with_static else 0)
    jcfg = jm.ConvLSTMConfig(
        in_channels=in_ch, compute_dtype=dtype, cell_impl=cell_impl, **LAYERS
    )
    tcfg = tm.ConvLSTMConfig(in_channels=in_ch, compute_dtype=dtype, **LAYERS)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, tree, bridge.params_from_jax(tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _close_state(got, want, atol):
    assert len(got) == len(want)
    for (th, tc), (jh, jc) in zip(got, want):
        assert tuple(th.shape) == tuple(jh.shape)
        assert th.dtype == torch.float32
        _close(th, jh, atol)
        _close(tc, jc, atol)


@pytest.mark.parametrize("with_static", [False, True])
def test_rollout_f32_matches_jax(data, with_static):
    """f32: XLA convs vs the port's f32 cell; atol 2e-5 on predictions
    (unnormalized, y_std 2.5) and on the carry."""
    forcings, static, stats = data
    jcfg, tcfg, tree, params = _pair(with_static=with_static, seed=1)
    st = static if with_static else None
    want_p, want_s = jro.make_rollout_fn(
        jcfg, jdata.Normalizer(*stats), static=st, **GEO
    )(tree, forcings)
    got_p, got_s = tro.make_rollout_fn(
        tcfg, tdata.Normalizer(*stats), static=st, **GEO
    )(params, forcings)
    assert tuple(got_p.shape) == tuple(want_p.shape) == (2, T, *GRID)
    assert got_p.dtype == torch.float32
    _close(got_p, want_p, 2e-5)
    _close_state(got_s, want_s, 2e-5)


def test_rollout_bf16_matches_jax_pallas2(data):
    """bf16 against the JAX fused kernel (interpret mode), which also sums
    in f32.  atol 2e-3: the bf16 head product and bf16 re-rounding of h
    between steps differ by whole bf16 quanta (measured 3.1e-4 here).  The
    JAX XLA cell rounds its gates to bf16 as well and differs from its own
    fused kernel by up to ~4e-4, so it is not the reference here."""
    forcings, _, stats = data
    jcfg, tcfg, tree, params = _pair("bfloat16", seed=2, cell_impl="pallas2")
    want_p, want_s = jro.make_rollout_fn(
        jcfg, jdata.Normalizer(*stats), cell_impl=None, **GEO
    )(tree, forcings)
    got_p, got_s = tro.make_rollout_fn(tcfg, tdata.Normalizer(*stats), **GEO)(
        params, forcings
    )
    _close(got_p, want_p, 2e-3)
    _close_state(got_s, want_s, 2e-3)


def test_carry_crosses_between_packages(data):
    """A JAX chunk's carry continues in the port (and the port's in JAX)
    as the other package would continue it."""
    forcings, _, stats = data
    jcfg, tcfg, tree, params = _pair(seed=3)
    jroll = jro.make_rollout_fn(jcfg, jdata.Normalizer(*stats), **GEO)
    troll = tro.make_rollout_fn(tcfg, tdata.Normalizer(*stats), **GEO)
    first, rest = forcings[:, :3], forcings[:, 3:]
    _, j_state = jroll(tree, first)
    _, t_state = troll(params, first)
    want_p, want_s = jroll(tree, rest, j_state)
    got_p, got_s = troll(params, rest, [tuple(map(np.asarray, s)) for s in j_state])
    _close(got_p, want_p, 2e-5)
    _close_state(got_s, want_s, 2e-5)
    back_p, _ = jroll(tree, rest, [tuple(s.numpy() for s in hc) for hc in t_state])
    _close(back_p, want_p, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_equals_one_shot(data, dtype):
    forcings, static, stats = data
    _, tcfg, _, params = _pair(dtype, with_static=True, seed=4)
    roll = tro.make_rollout_fn(tcfg, tdata.Normalizer(*stats), static=static, **GEO)
    p_all, s_all = roll(params, forcings)
    p_a, s_a = roll(params, forcings[:, :2])
    p_b, s_b = roll(params, forcings[:, 2:], s_a)
    assert torch.equal(torch.cat([p_a, p_b], dim=1), p_all)
    for (h1, c1), (h2, c2) in zip(s_b, s_all):
        assert torch.equal(h1, h2) and torch.equal(c1, c2)


def test_streaming_matches_rollout_and_jax(data):
    forcings, _, stats = data
    jcfg, tcfg, tree, params = _pair(seed=5)
    norm_t = tdata.Normalizer(*stats)
    step = tro.make_streaming_rollout(tcfg, norm_t, params, **GEO)
    jstep = jro.make_streaming_rollout(jcfg, jdata.Normalizer(*stats), tree, **GEO)
    want, _ = tro.make_rollout_fn(tcfg, norm_t, **GEO)(params, forcings)
    for t in range(3):
        got = step(forcings[:, t])
        assert tuple(got.shape) == (2, *GRID)
        assert torch.equal(got, want[:, t])
        _close(got, jstep(forcings[:, t]), 2e-5)


def test_unnormalize_flag(data):
    forcings, _, stats = data
    _, tcfg, _, params = _pair(seed=6)
    norm = tdata.Normalizer(*stats)
    phys, _ = tro.make_rollout_fn(tcfg, norm, **GEO)(params, forcings[:, :2])
    raw, _ = tro.make_rollout_fn(tcfg, norm, unnormalize=False, **GEO)(
        params, forcings[:, :2]
    )
    assert torch.equal(phys, raw * stats[3] + stats[2])


def test_prep_frame_matches_jax(data):
    """Normalize, cast, static concat, pad, channels last: same values and
    dtype as the JAX package's ``_prep_frame``."""
    forcings, static, stats = data
    st = jdata.zscore_static(static)
    for cast_j, cast_t in ((None, None), (jax.numpy.bfloat16, torch.bfloat16)):
        want = jro._prep_frame(forcings, jdata.Normalizer(*stats), st, PADDED, cast_j)
        got = tro._prep_frame(
            torch.from_numpy(forcings), tdata.Normalizer(*stats),
            torch.from_numpy(st), PADDED, cast_t,
        )
        assert got.dtype == (cast_t or torch.float32)
        assert tuple(got.shape) == tuple(want.shape) == (2, T, *PADDED, C + N_STATIC)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(np.float32))
        )


def test_model_days_per_min_matches_jax():
    for args, kw in (((192, 2.5), {}), ((384, 7.0), {"batch": 4}),
                     ((48, 1.0), {"steps_per_day": 24})):
        assert tro.model_days_per_min(*args, **kw) == jro.model_days_per_min(*args, **kw)
    assert tro.model_days_per_min(48, 60.0) == 1.0


def test_cpu_path_never_launches_the_kernel(data):
    forcings, _, stats = data
    _, tcfg, _, params = _pair("bfloat16", seed=7)
    before = convlstm_cell.launches
    preds, _ = tro.make_rollout_fn(tcfg, tdata.Normalizer(*stats), **GEO)(
        params, forcings[:, :2]
    )
    assert convlstm_cell.launches == before == 0
    assert bool(torch.isfinite(preds).all())


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in JAX or the JAX package."""
    root = Path(__file__).resolve().parents[1]
    pkg = root / "nasa_niswan_tpu_torch"
    modules = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )
    for name in (
        "ops.convlstm_cell", "ops.convgrad", "ops.convlstm_bptt",
        "models.registry", "evalx.metrics", "data.synthetic", "data.catalog",
        "train.schedule", "train.checkpoint", "train.loop", "train.config",
        "train.__main__",
    ):
        assert f"nasa_niswan_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'nasa_niswan_tpu' or m.startswith('nasa_niswan_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
