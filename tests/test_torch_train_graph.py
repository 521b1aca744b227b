"""Training and evaluation steps as CUDA graph replays (train/graph.py over
graph.py), on the CPU, against the JAX package and against the eager body.

* The tensor lr across a StepLR change: on the remat, per-cell and
  hoisted routes, 3 Adam steps with the lr halved between steps 2 and 3
  against JAX's ``make_train_step`` + ``set_learning_rate``.
* Config #3's draws, made before the step from the step's generator: bit
  for bit the draws the step used to make inside itself, and JAX's
  external-draw step on them.
* ``load_optimizer_state`` puts Adam's step on the parameters' device.
* The runner on a CPU stand-in for a CUDA graph
  (``fake_cuda_graph.FakeGraph``: a capture runs the body and undoes what
  it wrote, a replay runs it on the static buffers and leaves every
  version as a replay leaves it): the first call is one step, K calls are
  K eager steps, one capture per signature, none after replays or an lr
  change, a recapture for new leaves, every written leaf's version bumped
  by each call.
* The data-parallel and spatially sharded steps on two gloo ranks,
  through the restructured step functions, against one device.

Shapes: 2 layers, hidden (4, 3), kernels (3, 3), 7 input channels, T = 4,
grid (16, 24) padded to (20, 28), batch 2 or 3; one intra-op thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.rollout import seq2seq as js2s  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch import graph as cuda_graph  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models import convlstm as tm  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.parallel import launch  # noqa: E402
from nasa_niswan_tpu_torch.rollout import seq2seq as ts2s  # noqa: E402
from nasa_niswan_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402

import fake_cuda_graph  # noqa: E402  (tests/ is on the path)
import torch_train_ranks as ranks  # noqa: E402

MODEL = dict(in_channels=7, hidden_channels=(4, 3), kernel_sizes=(3, 3))
GEO = dict(padded_shape=(20, 28), grid_shape=(16, 24))
SEQ, BS, LR, BETAS = 4, 3, 1e-3, (0.5, 0.999)
ROUTES = {"remat": dict(remat=True), "per-cell": dict(remat=False),
          "hoist": dict(remat=False, precompute_input_conv=True)}
S2S_LAYERS = dict(hidden_channels=(4, 4), kernel_sizes=(5, 3))
S2S_GRID, S2S_PADDED = (8, 12), (12, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fixture():
    data = synthetic_e33oma_90d(T=60, H=16, W=24, seed=7)
    return data, tdata.SequenceDataset(data, period="train", sequence_length=SEQ,
                                       in_channels=7)


def _batch(ds, step, bs=BS):
    idx = np.random.default_rng(step).permutation(len(ds))[:bs]
    xs, ys = zip(*(ds[int(i)] for i in idx))
    return np.stack(xs), np.stack(ys)


def _trainable(tree):
    params = bridge.params_from_jax(jax.tree.map(np.asarray, tree))
    for t in tckpt.param_leaves(params):
        t.requires_grad_(True)
    return params


def _init_tree(seed=0):
    return jax.tree.map(np.asarray, j_build_model("LSTM-g", **MODEL).init(
        jax.random.PRNGKey(seed))[0])


def _lr(s):
    """Steps 1 and 2 at LR, step 3 at LR / 2 (a StepLR change)."""
    return LR if s < 2 else LR * 0.5


# --- the tensor lr across a StepLR change, against JAX ----------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_steplr_change_matches_jax(fixture, route):
    """3 Adam steps, ``set_learning_rate`` between steps 2 and 3: per-step
    loss rtol 2e-4, final weights rtol 5e-3 / atol 5e-5 (the trajectory
    test's bounds in tests/test_torch_train.py)."""
    data, ds = fixture
    static = data["static"][:2]
    jb = j_build_model("LSTM-g", **MODEL, **ROUTES[route])
    jparams, jstate = jb.init(jax.random.PRNGKey(0))
    jopt = jloop.make_optimizer(LR, BETAS)
    jopt_state = jopt.init(jparams)
    jstep = jloop.make_train_step(jb, ds.normalizer, jopt, static=static, donate=False, **GEO)
    params = _trainable(_init_tree())
    opt = tloop.make_optimizer(params, LR, BETAS)
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    step = tloop.make_train_step(build_model("LSTM-g", **MODEL, **ROUTES[route]),
                                 ds.normalizer, opt, static=static, **GEO)
    want, got = [], []
    for s in range(3):
        jopt_state = jloop.set_learning_rate(jopt_state, _lr(s))
        jparams, jstate, jopt_state, m = jstep(jparams, jstate, jopt_state, *_batch(ds, s),
                                               jax.random.PRNGKey(1))
        want.append(float(m["loss"]))
        tloop.set_learning_rate(opt, _lr(s))
        got.append(step(params, None, *_batch(ds, s))[1]["loss"].item())
    assert float(opt.param_groups[0]["lr"]) == LR * 0.5
    np.testing.assert_allclose(got, want, rtol=2e-4)
    for a, b in zip(jax.tree.leaves(bridge.params_to_jax(params)), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-3, atol=5e-5)


def test_tensor_lr_equals_a_float_lr(fixture):
    """The tensor lr (float64 on the CPU) takes bit for bit the update of
    the float lr it stands for, across a change."""
    data, ds = fixture
    out = []
    for tensor_lr in (True, False):
        params = _trainable(_init_tree(3))
        leaves = tckpt.param_leaves(params)
        opt = (tloop.make_optimizer(params, LR, BETAS) if tensor_lr
               else torch.optim.Adam(leaves, lr=LR, betas=BETAS, eps=1e-8))
        step = tloop.make_train_step(build_model("LSTM-g", **MODEL), ds.normalizer, opt,
                                     static=data["static"][:2], **GEO)
        for s in range(3):
            tloop.set_learning_rate(opt, _lr(s))
            step(params, None, *_batch(ds, s))
        out.append([t.detach().clone() for t in leaves])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# --- config #3's draws --------------------------------------------------------

@pytest.fixture(scope="module")
def s2s_data():
    data = synthetic_e33oma_90d(T=90, H=S2S_GRID[0], W=S2S_GRID[1], seed=4)
    return data, tdata.Seq2SeqDataset(data, period="train", sequence_length=4)


def _s2s_batches(ds, n, B=2):
    rng = np.random.default_rng(3)
    out = []
    for tp in np.linspace(0.8, 0.2, n):
        idx = rng.integers(0, len(ds), size=B)
        xs, p0s, ys = zip(*(ds[int(i)] for i in idx))
        out.append((np.stack(xs), np.stack(p0s), np.stack(ys), float(tp)))
    return out


def _in_step_draws(gen, tp, T, B):
    """The draws as the step made them inside itself before they moved out:
    uniform < teacher_prob from the generator, as f32 0/1."""
    return (torch.rand((T, B), generator=gen) < tp).to(torch.float32)


@pytest.mark.parametrize("remat", [False, True])
def test_seq2seq_draws_outside_equal_the_in_step_draws(s2s_data, remat):
    """Three steps drawing from a generator take bit for bit the update of
    three steps given the draws the step used to make inside itself from a
    generator of the same seed, in the same order."""
    _, ds = s2s_data
    batches = _s2s_batches(ds, 3)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(jax.random.PRNGKey(6),
                                                     jm.ConvLSTMConfig(6, **S2S_LAYERS)))
    cfg = tm.ConvLSTMConfig(6, remat=remat, **S2S_LAYERS)
    geo = dict(padded_shape=S2S_PADDED, grid_shape=S2S_GRID)
    runs = []
    for external in (False, True):
        params = _trainable(tree)
        step = ts2s.make_seq2seq_train_step(cfg, ds.normalizer,
                                            tloop.make_optimizer(params, LR, BETAS),
                                            external_draws=external, **geo)
        gen, losses = torch.Generator().manual_seed(11), []
        for x, p0, y, tp in batches:
            d = _in_step_draws(gen, tp, 4, 2) if external else gen
            losses.append(step(params, x, p0, y, d, tp)["loss"].item())
        runs.append((losses, [t.detach().clone() for t in tckpt.param_leaves(params)]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_seq2seq_generator_step_matches_jax_external_draws(s2s_data):
    """The generator-fed step against JAX's ``external_draws`` step given
    the same draws (made from a generator of the same seed): per-step loss
    rtol 2e-4, final weights rtol 5e-3 / atol 5e-5."""
    _, ds = s2s_data
    batches = _s2s_batches(ds, 3)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(jax.random.PRNGKey(6),
                                                     jm.ConvLSTMConfig(6, **S2S_LAYERS)))
    geo = dict(padded_shape=S2S_PADDED, grid_shape=S2S_GRID)
    jopt = jloop.make_optimizer(LR, BETAS)
    jstep = js2s.make_seq2seq_train_step(jm.ConvLSTMConfig(6, remat=False, **S2S_LAYERS),
                                         ds.normalizer, jopt, external_draws=True, **geo)
    jparams, jopt_state, want = tree, jopt.init(tree), []
    gen = torch.Generator().manual_seed(12)
    for x, p0, y, tp in batches:
        d = _in_step_draws(gen, tp, 4, 2).numpy() > 0
        jparams, jopt_state, m = jstep(jparams, jopt_state, x, p0, y, jnp.asarray(d), tp)
        want.append(float(m["loss"]))
    params = _trainable(tree)
    step = ts2s.make_seq2seq_train_step(tm.ConvLSTMConfig(6, remat=False, **S2S_LAYERS),
                                        ds.normalizer, tloop.make_optimizer(params, LR, BETAS),
                                        **geo)
    gen = torch.Generator().manual_seed(12)
    got = [step(params, x, p0, y, gen, tp)["loss"].item() for x, p0, y, tp in batches]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    for a, b in zip(jax.tree.leaves(bridge.params_to_jax(params)), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-3, atol=5e-5)


# --- resume -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_load_optimizer_state_puts_step_on_the_params_device(fixture, dtype):
    """Adam's restored step lies on its parameter's device, in f32, and the
    restored optimizer then steps as the one it was saved from."""
    data, ds = fixture
    params = bridge.tree_map(lambda t: t.detach().to(dtype).requires_grad_(True),
                             _trainable(_init_tree(4)))
    opt = tloop.make_optimizer(params, LR, BETAS)
    step = tloop.make_train_step(build_model("LSTM-g", **MODEL), ds.normalizer, opt,
                                 static=data["static"][:2], **GEO)
    step(params, None, *_batch(ds, 0))
    saved = tckpt.optimizer_state(opt, params)
    copy = bridge.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    opt2 = tloop.make_optimizer(copy, LR, BETAS)
    tckpt.load_optimizer_state(opt2, copy, saved)
    for p in tckpt.param_leaves(copy):
        st = opt2.state[p]
        assert st["step"].device == p.device and st["step"].dtype == torch.float32
        assert st["step"].item() == 1.0 and st["exp_avg"].dtype == dtype
    step2 = tloop.make_train_step(build_model("LSTM-g", **MODEL), ds.normalizer, opt2,
                                  static=data["static"][:2], **GEO)
    step(params, None, *_batch(ds, 1))
    step2(copy, None, *_batch(ds, 1))
    for a, b in zip(tckpt.param_leaves(params), tckpt.param_leaves(copy)):
        assert torch.equal(a, b)


# --- the runner on a CPU stand-in for a CUDA graph ---------------------------

@pytest.fixture
def fake_graph(monkeypatch):
    """``graph.Graphed`` on the CPU with ``fake_cuda_graph.FakeGraph`` for
    the CUDA graph; returns its ``Tracked`` record, whose ``params`` name
    the gradients a replay hands back."""
    return fake_cuda_graph.install(monkeypatch)


def _written(params, optimizers):
    """The leaves a training step writes: its parameters and optimizer
    state."""
    return tckpt.param_leaves(params) + [
        t for o in optimizers for t in cuda_graph.optimizer_leaves(o)]


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tckpt.param_leaves(a), tckpt.param_leaves(b)))


def _two_steps(fixture, route="remat", tracked=None, seed=0):
    """Two copies of seeded weights, each with its Adam and step function."""
    data, ds = fixture
    out = []
    for _ in range(2):
        params = _trainable(_init_tree(seed))
        opt = tloop.make_optimizer(params, LR, BETAS)
        step = tloop.make_train_step(build_model("LSTM-g", **MODEL, **ROUTES[route]),
                                     ds.normalizer, opt, static=data["static"][:2], **GEO)
        out.append((params, opt, step))
    if tracked is not None:
        tracked.params = out[0][0]
    return out


def test_first_call_is_exactly_one_step(fixture, fake_graph):
    """The first call runs its step eagerly, captures, and returns that
    step's results: one Adam step, not two."""
    _, ds = fixture
    (p, opt, step), (q, opt_q, step_q) = _two_steps(fixture, tracked=fake_graph)
    _, m = step(p, None, *_batch(ds, 0))
    _, m_q = step_q.eager(q, None, *_batch(ds, 0))
    assert step.runner.captures == 1 and len(fake_graph.graphs) == 1
    assert m["loss"].item() == m_q["loss"].item()
    assert _leaves_equal(p, q)
    assert all(s["step"].item() == 1.0 for s in opt.state.values())
    for a, b in zip(tckpt.param_leaves(p), tckpt.param_leaves(q)):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("route", ["remat", "per-cell"])
def test_k_calls_equal_k_eager_steps(fixture, fake_graph, route):
    """Four calls (a capture, then three replays) against four eager steps:
    losses, parameters, Adam's moments and the last gradients equal."""
    _, ds = fixture
    (p, opt, step), (q, opt_q, step_q) = _two_steps(fixture, route, tracked=fake_graph)
    for s in range(4):
        a = step(p, None, *_batch(ds, s))[1]["loss"].item()
        b = step_q.eager(q, None, *_batch(ds, s))[1]["loss"].item()
        assert a == b
    assert step.runner.captures == 1
    assert _leaves_equal(p, q)
    for x, y in zip(cuda_graph.optimizer_leaves(opt), cuda_graph.optimizer_leaves(opt_q)):
        assert torch.equal(x, y)
    for a, b in zip(tckpt.param_leaves(p), tckpt.param_leaves(q)):
        assert torch.equal(a.grad, b.grad)


def test_one_capture_per_signature(fixture, fake_graph):
    """Two batch sizes take two captures; alternating between them takes
    no more."""
    _, ds = fixture
    (p, _, step), _ = _two_steps(fixture, tracked=fake_graph)
    for s in range(4):
        step(p, None, *_batch(ds, s, bs=2 + s % 2))
    assert step.runner.captures == 2


def test_no_recapture_after_replays_or_an_lr_change(fixture, fake_graph):
    """StepLR's in-place lr between replays: no new capture, and the
    replays take the new lr as the eager steps do."""
    _, ds = fixture
    (p, opt, step), (q, opt_q, step_q) = _two_steps(fixture, tracked=fake_graph)
    for s in range(4):
        tloop.set_learning_rate(opt, _lr(s))
        tloop.set_learning_rate(opt_q, _lr(s))
        step(p, None, *_batch(ds, s))
        step_q.eager(q, None, *_batch(ds, s))
    assert step.runner.captures == 1
    assert _leaves_equal(p, q)


def test_new_leaves_recapture(fixture, fake_graph):
    """A restored optimizer state (new tensors) recaptures, and the steps
    after it equal eager ones from the same restore."""
    _, ds = fixture
    (p, opt, step), (q, opt_q, step_q) = _two_steps(fixture, tracked=fake_graph)
    for s in range(2):
        step(p, None, *_batch(ds, s))
        step_q.eager(q, None, *_batch(ds, s))
    saved = tckpt.optimizer_state(opt, p)
    tckpt.load_optimizer_state(opt, p, saved)
    tckpt.load_optimizer_state(opt_q, q, tckpt.optimizer_state(opt_q, q))
    for s in range(2, 4):
        step(p, None, *_batch(ds, s))
        step_q.eager(q, None, *_batch(ds, s))
    assert step.runner.captures == 2
    assert _leaves_equal(p, q)


def test_every_written_leaf_version_rises_on_each_call(fixture, fake_graph):
    """After each replay every parameter and optimizer-state leaf's
    version is higher than before it (the stand-in's replay bumps none),
    so a cache keyed on versions sees the update."""
    _, ds = fixture
    (p, opt, step), _ = _two_steps(fixture, tracked=fake_graph)
    step(p, None, *_batch(ds, 0))
    for s in range(1, 3):
        before = [t._version for t in _written(p, (opt,))]
        step(p, None, *_batch(ds, s))
        after = [t._version for t in _written(p, (opt,))]
        assert all(b > a for a, b in zip(before, after))


def test_eval_step_replays_and_writes_nothing(fixture, fake_graph):
    """The eval step through the stand-in: each call equals its eager
    body, one capture, and no leaf's version moves."""
    _, ds = fixture
    (p, _, _), _ = _two_steps(fixture, tracked=fake_graph)
    step = tloop.make_eval_step(build_model("LSTM-g", **MODEL), ds.normalizer,
                                static=fixture[0]["static"][:2], **GEO)
    versions = [t._version for t in tckpt.param_leaves(p)]
    for s in range(3):
        scores, pred = step(p, None, *_batch(ds, s))
        want_s, want_p = step.eager(p, None, *_batch(ds, s))
        assert torch.equal(scores, want_s) and torch.equal(pred, want_p)
    assert step.runner.captures == 1
    assert [t._version for t in tckpt.param_leaves(p)] == versions


def test_seq2seq_step_replays_as_its_eager_body(s2s_data, fake_graph):
    """Config #3's step through the stand-in, draws from a generator before
    each call: three calls equal three eager steps from a generator of the
    same seed, with one capture."""
    _, ds = s2s_data
    tree = jax.tree.map(np.asarray, jm.convlstm_init(jax.random.PRNGKey(6),
                                                     jm.ConvLSTMConfig(6, **S2S_LAYERS)))
    cfg = tm.ConvLSTMConfig(6, remat=True, **S2S_LAYERS)
    geo = dict(padded_shape=S2S_PADDED, grid_shape=S2S_GRID)
    runs = []
    for graphed in (True, False):
        params = _trainable(tree)
        opt = tloop.make_optimizer(params, LR, BETAS)
        if graphed:
            fake_graph.params = params
        step = ts2s.make_seq2seq_train_step(cfg, ds.normalizer, opt, **geo)
        call = step if graphed else step.eager
        gen = torch.Generator().manual_seed(5)
        losses = [call(params, x, p0, y, gen, tp)["loss"].item()
                  for x, p0, y, tp in _s2s_batches(ds, 3)]
        runs.append((losses, params, step))
    assert runs[0][0] == runs[1][0]
    assert _leaves_equal(runs[0][1], runs[1][1])
    assert runs[0][2].runner.captures == 1


# --- two gloo ranks -----------------------------------------------------------

@pytest.fixture(scope="module")
def gloo_world(fixture):
    """The DP (2,) and spatial (1, 1, 2) steps of ``graph_bodies_world`` on
    two gloo ranks, and the single-device run they are held against."""
    data, ds = fixture
    x, y = _batch(ds, 5, bs=2)
    norm = ds.normalizer
    geo = dict(GEO, static=data["static"][:2])
    case = dict(norm=(norm.x_mean, norm.x_std, norm.y_mean, norm.y_std), model=MODEL,
                params=_init_tree(8), opt=(LR, BETAS), geo=geo, batch=(x, y), remat=True)
    results = launch.spawn(ranks.graph_bodies_world, 2, "cpu", case, timeout=300)
    params = _trainable(_init_tree(8))
    opt = tloop.make_optimizer(params, LR, BETAS)
    step = tloop.make_train_step(build_model("LSTM-t", remat=True, **MODEL), norm, opt, **geo)
    losses = []
    for s in range(2):
        tloop.set_learning_rate(opt, LR * (0.5 if s else 1.0))
        losses.append(step(params, None, x, y)[1]["loss"].item())
    return results, (losses, [t.detach().numpy() for t in tckpt.param_leaves(params)])


@pytest.mark.parametrize("name", ["dp", "spatial"])
def test_two_rank_steps_match_one_device(gloo_world, name):
    """Two steps with an lr change on two gloo ranks: the step and its
    ``.eager`` equal on every rank, and against one device's step: loss
    rtol 1e-5, parameters atol 1e-6."""
    results, (want_loss, want_params) = gloo_world
    for r in results:
        got, eager = r[(name, "step")], r[(name, "eager")]
        assert got["loss"] == eager["loss"]
        for a, b in zip(got["params"], eager["params"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        for a, b in zip(got["params"], want_params):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_chip_smoke_two_rank_replay_phase_on_gloo():
    """chip_smoke.py's two-rank replay phase (which the card's machine runs
    only with two cards) on two CPU ranks at a small size: the dp = 2 and
    (1, 1, 2) steps equal to their eager bodies on both ranks."""
    import chip_smoke

    out = launch.spawn(chip_smoke.two_rank_replay_phase, 2, "cpu", dict(
        grid=(16, 24), padded=(20, 28), hidden=(8, 4), kernels=(5, 3), bs=4, T=4,
        dtype="float32"), timeout=300)
    assert out[0] == out[1] == {"dp = 2": True, "(1, 1, 2)": True}
