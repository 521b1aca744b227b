"""The port's test-period evaluation (nasa_niswan_tpu_torch/evalx/evaluate.py)
against the JAX package's on one small fixture and one set of weights
(drawn by JAX, carried across by bridge.py): the windowed and rollout
predictions, the per-window taps, the chunked episode with a ragged tail
and its carry, and the metric report; plus the key of the CUDA-graph
runner (rollout/graph.py), whose logic runs without a card.

Shape: 2 layers, hidden (4, 4), kernels (5, 3), 5 forcings (7 channels
with the static ones), grid (8, 12) padded to (12, 16), f32.  Predictions
are in physical units; the f32 tolerance 2e-5 is that of
tests/test_torch_rollout.py for the same computation (XLA's convs against
the port's plain cell)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.core.grid import GridSpec  # noqa: E402
from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu.evalx import evaluate as jeval  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build  # noqa: E402
from nasa_niswan_tpu.rollout import autoregressive as jroll  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.evalx import evaluate as teval  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model as t_build  # noqa: E402
from nasa_niswan_tpu_torch.rollout import autoregressive as troll  # noqa: E402
from nasa_niswan_tpu_torch.rollout import graph  # noqa: E402

LAYERS = dict(hidden_channels=(4, 4), kernel_sizes=(5, 3))
GRID, PADDED = (8, 12), (12, 16)
SEQ = 4
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fixture():
    data = synthetic_e33oma_90d(T=60, H=GRID[0], W=GRID[1], seed=3)
    jds = jdata.SequenceDataset(data, period="test", sequence_length=SEQ, in_channels=7)
    tds = tdata.SequenceDataset(data, period="test", sequence_length=SEQ, in_channels=7)
    static = data["static"][:2]
    jb = j_build("LSTM-e", in_channels=7, **LAYERS)
    tb = t_build("LSTM-e", in_channels=7, **LAYERS)
    tree, _ = jb.init(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, tree)
    return jds, tds, static, jb, tb, tree, bridge.params_from_jax(tree)


@pytest.mark.parametrize("batch_size", [4, 5])
def test_predict_test_set_matches_jax(fixture, batch_size):
    """Windowed inference from the device-resident slab, a padded tail
    batch (the test split has 9 windows)."""
    jds, tds, static, jb, tb, tree, params = fixture
    want = jeval.predict_test_set(jb, tree, None, jds, padded_shape=PADDED,
                                  batch_size=batch_size, static=static)
    got = teval.predict_test_set(tb, params, None, tds, padded_shape=PADDED,
                                 batch_size=batch_size, static=static)
    assert len(tds) % batch_size
    np.testing.assert_array_equal(got["GTs"], want["GTs"])
    assert got["PDs"].shape == want["PDs"].shape == (len(tds), *GRID)
    np.testing.assert_allclose(got["PDs"], want["PDs"], atol=ATOL)


def test_predict_test_rollout_matches_jax(fixture):
    jds, tds, static, jb, tb, tree, params = fixture
    want = jeval.predict_test_rollout(jb.config, tree, jds, padded_shape=PADDED,
                                      static=static)
    got = teval.predict_test_rollout(tb.config, params, tds, padded_shape=PADDED,
                                     static=static)
    np.testing.assert_array_equal(got["GTs"], want["GTs"])
    np.testing.assert_allclose(got["PDs"], want["PDs"], atol=ATOL)


def test_predict_test_hidden_matches_jax(fixture):
    jds, tds, static, jb, tb, tree, params = fixture
    want = jeval.predict_test_hidden(jb.config, tree, jds, padded_shape=PADDED,
                                     batch_size=4, static=static)
    got = teval.predict_test_hidden(tb.config, params, tds, padded_shape=PADDED,
                                    batch_size=4, static=static)
    assert got.shape == want.shape == (len(tds), SEQ, *GRID)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("chunk", [4, 11, 16])
def test_run_chunked_episode_carry_matches_jax(fixture, chunk):
    """11 frames in chunks of 4 (a ragged tail of 3, repeat-padded), one
    chunk, and one oversized chunk kept at 16 (the JAX function's
    ``clamp_chunk=False``; the port's never clamps): the
    trimmed predictions and the final carry, which crosses every chunk."""
    jds, tds, static, jb, tb, tree, params = fixture
    frames = jds.forcing_stream()[0][:11]
    jr = jroll.make_rollout_fn(jb.config, jds.normalizer, padded_shape=PADDED,
                               grid_shape=GRID, static=static)
    tr = troll.make_rollout_fn(tb.config, tds.normalizer, padded_shape=PADDED,
                               grid_shape=GRID, static=static)

    def jrun(st, x):
        p, st = jr(tree, x[None], st)
        return st, p[0]

    def trun(st, x):
        p, st = tr(params, x[None], st)
        return st, p[0]

    want, (jst,) = jeval.run_chunked_episode_carry(jrun, [None], frames, chunk,
                                                   clamp_chunk=chunk != 16)
    got, (tst,) = teval.run_chunked_episode_carry(trun, [None], frames, chunk)
    assert got.shape == want.shape == (11, *GRID)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for (h, c), (jh, jc) in zip(tst, jst):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL)
    if chunk == 11:  # one chunk: the rollout over all frames, same carry
        p_all, s_all = tr(params, frames[None])
        np.testing.assert_array_equal(got, p_all[0].numpy())


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pad_tail_chunk_matches_jax(as_tensor):
    x = np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4)
    want = np.asarray(jeval.pad_tail_chunk(x, 5))
    got = teval.pad_tail_chunk(torch.from_numpy(x) if as_tensor else x, 5)
    got = got.numpy() if as_tensor else got
    np.testing.assert_array_equal(got, want)
    assert teval.pad_tail_chunk(x, 3) is x


def test_evaluation_report_matches_jax():
    rng = np.random.default_rng(4)
    gts = (1.0 + rng.random((6, 18, 24))).astype(np.float32)
    pds = (gts + 0.1 * rng.standard_normal(gts.shape)).astype(np.float32)
    grid = GridSpec(nlat=18, nlon=24)
    want = jeval.evaluation_report(gts, pds, grid.lat, grid.lon)
    got = teval.evaluation_report(gts, pds, grid.lat, grid.lon)
    assert set(got) == set(want)
    for key in ("temporal_r2", "spatial_r2"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)
    for key in ("temporal_r2_summary", "band_weighted_r2", "regional_r2"):
        assert set(got[key]) == set(want[key])
        for k in want[key]:
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=1e-5, atol=1e-6)
    for key in ("pearson_r", "global_r2"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    months = np.array([2, 2, 8, 8, 5, 2])
    wm = jeval.monthly_breakdown(gts, pds, months, grid.lat, grid.lon)
    tm_ = teval.monthly_breakdown(gts, pds, months, grid.lat, grid.lon)
    assert set(tm_) == set(wm) == {2, 8}
    for m in wm:
        for region, v in wm[m].items():
            np.testing.assert_allclose(tm_[m][region], v, rtol=1e-5, atol=1e-6)


def test_test_results_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(5)
    gts, pds = rng.random((3, 4, 5)), rng.random((3, 4, 5))
    path = teval.save_test_results(str(tmp_path / "t"), gts, pds)
    for load in (jeval.load_test_results, teval.load_test_results):
        g, p = load(path)
        np.testing.assert_array_equal(g, gts)
        np.testing.assert_array_equal(p, pds)


def test_graph_key_changes_with_weights_in_place_and_tree():
    """A graph replays baked-in pointers, so its key must change when a
    parameter leaf changes in place (an optimizer step: same storage, new
    version) and when the tree is replaced; it stays when nothing changed."""
    params = bridge.params_from_jax(jax.tree.map(
        np.asarray, jm.convlstm_init(jax.random.PRNGKey(0), jm.ConvLSTMConfig(5, **LAYERS))))
    key = graph.params_key(params)
    assert graph.params_key(params) == key
    w = params["cells"][1]["w_h"]
    with torch.no_grad():
        w.add_(1.0)
    moved = graph.params_key(params)
    assert moved != key
    assert [a[:2] for a in moved] == [a[:2] for a in key]  # same leaves, same storage
    opt = torch.optim.Adam([params["head"]["w"].requires_grad_(True)], lr=1e-3)
    params["head"]["w"].grad = torch.ones_like(params["head"]["w"])
    opt.step()
    stepped = graph.params_key(params)
    assert stepped != moved
    replaced = {**params, "head": {k: v.clone() for k, v in params["head"].items()}}
    assert graph.params_key(replaced) != stepped
    with torch.inference_mode():
        frozen = {"head": {"w": torch.zeros(1)}}
    assert graph.params_key(frozen)[0][2] == 0  # inference tensors: no version


def test_graph_signature_separates_shapes_and_dtypes():
    a = torch.zeros((1, 4, 5))
    assert graph.signature([a]) == graph.signature([torch.ones((1, 4, 5))])
    assert graph.signature([a]) != graph.signature([torch.zeros((1, 3, 5))])
    assert graph.signature([a]) != graph.signature([a.to(torch.bfloat16)])


def test_cpu_rollout_runs_no_graph(fixture):
    """On the CPU the rollout is the eager body: nothing is captured."""
    jds, tds, static, jb, tb, tree, params = fixture
    tr = troll.make_rollout_fn(tb.config, tds.normalizer, padded_shape=PADDED,
                               grid_shape=GRID, static=static)
    frames = jds.forcing_stream()[0][None, :4]
    p, _ = tr(params, frames)
    q, _ = tr.eager(params, frames)
    assert torch.equal(p, q) and tr.runner.captures == 0


def test_launch_counters_are_all_registered():
    """The graph runner takes back and re-adds every counter of
    ``ops.launch_counts``: each kernel module's ``*launches`` counters must
    all be named in its ``LAUNCH_COUNTERS``, and adding a delta moves one
    counter and nothing else."""
    from nasa_niswan_tpu_torch import ops
    from nasa_niswan_tpu_torch.ops import convgrad, convlstm_cell

    counts = ops.launch_counts()
    for m in (convgrad, convlstm_cell):
        ints = {n for n, v in vars(m).items()
                if n.endswith("launches") and isinstance(v, int)}
        assert ints and {f"{m.__name__}.{n}" for n in ints} <= set(counts)
    key = f"{convgrad.__name__}.dw_launches"
    ops.add_launch_counts({key: 3})
    after = ops.launch_counts()
    ops.add_launch_counts({key: 3}, -1)
    assert after[key] == counts[key] + 3
    assert {k: v for k, v in after.items() if k != key} == {
        k: v for k, v in counts.items() if k != key}
    assert ops.launch_counts() == counts
