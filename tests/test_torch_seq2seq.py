"""The per-cell and hoisted training routes of ``convlstm_apply`` and the
seq2seq scheduled-sampling slice (config #3) of the PyTorch port against
the JAX package: the route rule, taps under grad, the hoisted input conv,
the seq2seq train and eval steps of both routes through shared draws, the
closed-loop chunk, the datasets and the CLI.

On the CPU the port runs its plain versions; the JAX side runs its pallas2
cell in interpret mode (``cell_impl="pallas2"``), as its own tests do.
Inputs are seeded numpy, handed to both packages."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.data.pipeline import batch_iterator as j_batch_iterator  # noqa: E402
from nasa_niswan_tpu.evalx import evaluate as jeval  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.rollout import autoregressive as jroll  # noqa: E402
from nasa_niswan_tpu.rollout import seq2seq as js2s  # noqa: E402
from nasa_niswan_tpu.train import checkpoint as jckpt  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.data.pipeline import batch_iterator  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.evalx import evaluate as teval  # noqa: E402
from nasa_niswan_tpu_torch.models import convlstm as tm  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward_plain  # noqa: E402
from nasa_niswan_tpu_torch.rollout import autoregressive as troll  # noqa: E402
from nasa_niswan_tpu_torch.rollout import seq2seq as ts2s  # noqa: E402
from nasa_niswan_tpu_torch.train import __main__ as cli  # noqa: E402
from nasa_niswan_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig, parse_args  # noqa: E402

LAYERS = dict(hidden_channels=(4, 4), kernel_sizes=(5, 3))
GRID, PADDED = (8, 12), (12, 16)
LR, BETAS = 1e-3, (0.5, 0.999)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _jax_tree(in_ch, seed=0, layers=LAYERS):
    return jax.tree.map(np.asarray, jm.convlstm_init(
        jax.random.PRNGKey(seed), jm.ConvLSTMConfig(in_ch, **layers)))


def _port_params(tree):
    params = bridge.params_from_jax(tree)
    for t in tckpt.param_leaves(params):
        t.requires_grad_(True)
    return params


def _in_graph(t, name):
    """Whether an autograd node named ``name`` produced ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            return True
        todo += [n for n, _ in node.next_functions]
    return False


def _jax_grad_leaves(g):
    """JAX grads in ``param_leaves`` order (the JAX tree's leaf order)."""
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]


# ---- convlstm_apply: the route rule, taps, the hoist -----------------------


def _seq(seed, B=2, T=3, H=12, W=16, C=5):
    return np.random.default_rng(seed).standard_normal((B, T, H, W, C)).astype(np.float32)


def test_remat_and_per_cell_routes_agree():
    """``remat`` True (whole-scan BPTT) and False (per-cell Functions): the
    same loss and gradients, f32, 1e-5 of each gradient's largest entry."""
    x = _seq(0)
    params = _port_params(_jax_tree(5, 1))
    out = []
    for remat in (False, True):
        cfg = tm.ConvLSTMConfig(5, remat=remat, **LAYERS)
        pred = tm.convlstm_apply(params, _t(x), cfg)
        assert _in_graph(pred, "_ScanCellsBackward") == remat
        assert _in_graph(pred, "FusedCellBackward") == (not remat)
        loss = (pred**2).sum()
        out.append((loss.item(), torch.autograd.grad(loss, tckpt.param_leaves(params))))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _jax_grads_taps(tree, x, tap):
    cfg = jm.ConvLSTMConfig(5, cell_impl="pallas2", **LAYERS)

    def f(p):
        _, taps = jm.convlstm_apply(p, jnp.asarray(x), cfg, return_per_step=True,
                                    tap_fn=tap)
        return jnp.sum(taps**2)

    return jax.value_and_grad(f)(tree)


@pytest.mark.parametrize("custom_tap", [False, True])
def test_taps_under_grad_match_jax(custom_tap):
    """Per-step head taps and a ``tap_fn`` under grad (the per-cell route)
    vs ``jax.value_and_grad`` through the pallas2 cell's custom VJP, f32:
    loss rtol 1e-5, gradients 2e-4 / rtol 1e-4."""
    x = _seq(1)
    tree = _jax_tree(5, 2)
    jtap = (lambda h: jnp.mean(h * h, axis=-1)) if custom_tap else None
    want_v, want_g = _jax_grads_taps(tree, x, jtap)
    params = _port_params(tree)
    cfg = tm.ConvLSTMConfig(5, **LAYERS)
    ttap = (lambda h: (h * h).mean(-1)) if custom_tap else None
    _, taps = tm.convlstm_apply(params, _t(x), cfg, return_per_step=True, tap_fn=ttap)
    loss = (taps**2).sum()
    got = torch.autograd.grad(loss, tckpt.param_leaves(params), allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for g, w in zip(got, _jax_grad_leaves(want_g)):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_hoisted_input_conv_matches_jax(dtype, tol):
    """``precompute_input_conv=True`` (layer 0 in the xg mode of the
    per-cell route) vs JAX ``convlstm_apply(precompute_input_conv=True,
    cell_impl="pallas2")``: the prediction, the returned carry and the
    gradients w.r.t. the parameters.  f32: 2e-4; bf16 (the hoisted gates
    rounded to bf16 in both): 2e-2 of each array's largest entry."""
    x = _seq(2)
    tree = _jax_tree(5, 3)
    cfg = jm.ConvLSTMConfig(5, compute_dtype=dtype, cell_impl="pallas2", **LAYERS)

    def f(p):
        pred, st = jm.convlstm_apply(p, jnp.asarray(x), cfg, return_state=True,
                                     precompute_input_conv=True)
        return jnp.sum(pred**2) + sum(jnp.sum(h) + jnp.sum(c * c) for h, c in st), (pred, st)

    (want_v, (want_p, want_s)), want_g = jax.value_and_grad(f, has_aux=True)(tree)
    params = _port_params(tree)
    tcfg = tm.ConvLSTMConfig(5, compute_dtype=dtype, **LAYERS)
    pred, st = tm.convlstm_apply(params, _t(x), tcfg, return_state=True,
                                 precompute_input_conv=True)
    loss = (pred**2).sum() + sum(h.sum() + (c * c).sum() for h, c in st)
    got = torch.autograd.grad(loss, tckpt.param_leaves(params))
    close = lambda a, b: np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-6)  # noqa: E731
    assert close(pred.detach().numpy(), np.asarray(want_p))
    for (h, c), (jh, jc) in zip(st, want_s):
        assert close(h.detach().numpy(), np.asarray(jh))
        assert close(c.detach().numpy(), np.asarray(jc))
    for g, w in zip(got, _jax_grad_leaves(want_g)):
        assert close(g.numpy(), w)


def test_hoist_route_matches_eager_and_takes_no_bptt():
    """The hoist never takes the whole-scan BPTT, even with ``remat``; its
    gradients equal eager autograd through the plain cell, f32, 1e-5."""
    x = _seq(3)
    params = _port_params(_jax_tree(5, 4))
    cfg = tm.ConvLSTMConfig(5, remat=True, **LAYERS)
    grads = []
    for kw in ({}, {"cell_fn": fused_cell_forward_plain, "grads_fn": None}):
        pred = tm.convlstm_apply(params, _t(x), cfg, precompute_input_conv=True, **kw)
        assert not _in_graph(pred, "_ScanCellsBackward")
        grads.append(torch.autograd.grad((pred**2).sum(), tckpt.param_leaves(params)))
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_rollout_with_hoist_matches_jax():
    """``make_rollout_fn(precompute_input_conv=True)`` vs the JAX rollout
    with the hoist and the pallas2 cell: predictions (physical units) and
    the carry, f32, 1e-4; None (off) gives the unhoisted rollout."""
    rng = np.random.default_rng(5)
    forcings = rng.standard_normal((1, 4, 5, *GRID)).astype(np.float32)
    norm = tdata.Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.5, 2.0)
    jnorm = jdata.Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.5, 2.0)
    tree = _jax_tree(5, 5)
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    jfn = jroll.make_rollout_fn(jm.ConvLSTMConfig(5, cell_impl="pallas2", **LAYERS), jnorm,
                                precompute_input_conv=True, cell_impl=None, **geo)
    want_p, want_s = jfn(tree, jnp.asarray(forcings))
    tcfg = tm.ConvLSTMConfig(5, **LAYERS)
    params = bridge.params_from_jax(tree)
    got_p, got_s = troll.make_rollout_fn(tcfg, norm, precompute_input_conv=True, **geo)(
        params, forcings)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)
    for (h, c), (jh, jc) in zip(got_s, want_s):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
    off_p, _ = troll.make_rollout_fn(tcfg, norm, **geo)(params, forcings)
    np.testing.assert_allclose(off_p.numpy(), got_p.numpy(), atol=1e-4)


# ---- seq2seq: the train steps of both routes through shared draws ----------


@pytest.fixture(scope="module")
def s2s_data():
    data = synthetic_e33oma_90d(T=90, H=GRID[0], W=GRID[1], seed=4)
    return data, tdata.Seq2SeqDataset(data, period="train", sequence_length=4)


def _schedule(ds, n, B=2, T=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for tp in np.linspace(0.8, 0.2, n):
        idx = rng.integers(0, len(ds), size=B)
        xs, p0s, ys = zip(*(ds[int(i)] for i in idx))
        out.append((np.stack(xs), np.stack(p0s), np.stack(ys), rng.random((T, B)) < tp,
                    float(tp)))
    return out


def _jax_s2s_run(ds, tree, remat, schedule, dtype="float32"):
    cfg = jm.ConvLSTMConfig(6, compute_dtype=dtype, cell_impl="pallas2", remat=remat,
                            **LAYERS)
    opt = jloop.make_optimizer(LR, BETAS)
    step = js2s.make_seq2seq_train_step(cfg, ds.normalizer, opt, padded_shape=PADDED,
                                        grid_shape=GRID, external_draws=True)
    params, opt_state, ms = tree, opt.init(tree), []
    for x, p0, y, d, tp in schedule:
        params, opt_state, m = step(params, opt_state, x, p0, y, jnp.asarray(d), tp)
        ms.append((float(m["loss"]), float(m["r2"])))
    return np.array(ms), jax.tree.map(np.asarray, params)


def _port_s2s_run(ds, tree, remat, schedule, dtype="float32"):
    cfg = tm.ConvLSTMConfig(6, compute_dtype=dtype, remat=remat, **LAYERS)
    params = _port_params(tree)
    step = ts2s.make_seq2seq_train_step(
        cfg, ds.normalizer, tloop.make_optimizer(params, LR, BETAS),
        padded_shape=PADDED, grid_shape=GRID, external_draws=True)
    ms = []
    for x, p0, y, d, tp in schedule:
        m = step(params, x, p0, y, d, tp)
        ms.append((m["loss"].item(), m["r2"].item()))
    return np.array(ms), params


@pytest.mark.parametrize("remat", [False, True])
def test_seq2seq_train_steps_match_jax(s2s_data, remat):
    """4 scheduled-sampling Adam steps through ``external_draws`` from the
    same weights, batches and draws, against JAX's
    ``make_seq2seq_train_step(external_draws=True)`` with the pallas2 cell:
    the per-cell route (``remat`` False, the CLI's) and the whole-chunk BPTT
    (``remat`` True).  Per-step loss and R^2 rtol 2e-4 (the windowed
    trajectory test's bound), final weights rtol 5e-3 / atol 5e-5."""
    _, ds = s2s_data
    tree = _jax_tree(6, 6)
    sched = _schedule(ds, 4)
    want_m, want_p = _jax_s2s_run(ds, tree, remat, sched)
    got_m, params = _port_s2s_run(ds, tree, remat, sched)
    np.testing.assert_allclose(got_m[:, 0], want_m[:, 0], rtol=2e-4)
    np.testing.assert_allclose(got_m[:, 1], want_m[:, 1], rtol=2e-4, atol=1e-5)
    for a, b in zip(jax.tree.leaves(bridge.params_to_jax(params)), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("tp", [0.0, 0.5, 1.0])
def test_seq2seq_routes_agree_on_loss_and_grads(s2s_data, tp):
    """The whole-chunk BPTT Function against eager autograd through the
    per-step route with the plain cell, on the same draws: loss rtol 1e-6,
    every parameter gradient and the feedback seed's within 1e-5 of its
    largest entry (f32)."""
    _, ds = s2s_data
    x, p0, y, _, _ = _schedule(ds, 1)[0]
    draws = np.random.default_rng(int(10 * tp)).random((4, 2)) < tp
    params = _port_params(_jax_tree(6, 7))
    out = []
    for remat, fn in ((True, tm.fused_cell_forward), (False, fused_cell_forward_plain)):
        cfg = tm.ConvLSTMConfig(6, remat=remat, **LAYERS)
        chunk = ts2s._make_forward_chunk(cfg, ds.normalizer, padded_shape=PADDED,
                                         grid_shape=GRID, external_draws=True, cell_fn=fn)
        prev0 = _t(p0).requires_grad_(True)
        loss, _ = chunk(params, _t(x), prev0, _t(y), draws, tp)
        out.append((loss.item(), torch.autograd.grad(
            loss, tckpt.param_leaves(params) + [prev0])))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_seq2seq_bf16_step_matches_jax(s2s_data):
    """One bf16 step of the per-cell route vs JAX's: bf16 rounds the gates,
    dgates and dxh at the same places in both; loss rtol 2e-3."""
    _, ds = s2s_data
    tree = _jax_tree(6, 8)
    sched = _schedule(ds, 1, seed=4)
    want_m, _ = _jax_s2s_run(ds, tree, False, sched, "bfloat16")
    got_m, _ = _port_s2s_run(ds, tree, False, sched, "bfloat16")
    np.testing.assert_allclose(got_m[:, 0], want_m[:, 0], rtol=2e-3)


def test_seq2seq_eval_step_matches_jax(s2s_data):
    """The closed-loop eval step (teacher_prob 0, no grad): loss and R^2,
    f32, rtol 1e-5 / 1e-4."""
    _, ds = s2s_data
    tree = _jax_tree(6, 9)
    x, p0, y, _, _ = _schedule(ds, 1, seed=5)[0]
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    jstep = js2s.make_seq2seq_eval_step(
        jm.ConvLSTMConfig(6, cell_impl="pallas2", **LAYERS), ds.normalizer, **geo)
    want_l, want_r = jstep(tree, x, p0, y)
    tstep = ts2s.make_seq2seq_eval_step(tm.ConvLSTMConfig(6, **LAYERS), ds.normalizer, **geo)
    got_l, got_r = tstep(bridge.params_from_jax(tree), x, p0, y)
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(got_r.item(), float(want_r), rtol=1e-4, atol=1e-6)


def test_generator_draws_follow_teacher_prob(s2s_data):
    """Without external draws the step draws uniform < teacher_prob from
    the generator: 1 is pure teacher forcing, 0 pure feedback, and two
    generators from one seed give the same step."""
    _, ds = s2s_data
    x, p0, y, _, _ = _schedule(ds, 1, seed=6)[0]
    params = _port_params(_jax_tree(6, 10))
    cfg = tm.ConvLSTMConfig(6, **LAYERS)
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    with torch.no_grad():
        gen_chunk = ts2s._make_forward_chunk(cfg, ds.normalizer, **geo)
        ext_chunk = ts2s._make_forward_chunk(cfg, ds.normalizer, external_draws=True, **geo)
        args = (params, _t(x), _t(p0), _t(y))
        for tp in (0.0, 1.0):
            got = gen_chunk(*args, torch.Generator().manual_seed(0), tp)[0]
            want = ext_chunk(*args, np.full((4, 2), tp > 0), tp)[0]
            assert got.item() == want.item()
        a = gen_chunk(*args, torch.Generator().manual_seed(1), 0.5)[0]
        b = gen_chunk(*args, torch.Generator().manual_seed(1), 0.5)[0]
        assert a.item() == b.item()


@pytest.mark.parametrize("epoch", [1, 10, 30, 60])
def test_inverse_sigmoid_schedule_matches_jax(epoch):
    assert ts2s.inverse_sigmoid_schedule(epoch, 7.0) == js2s.inverse_sigmoid_schedule(epoch, 7.0)
    assert ts2s.inverse_sigmoid_schedule(epoch) == js2s.inverse_sigmoid_schedule(epoch)


# ---- the closed loop --------------------------------------------------------


def test_closed_loop_chunk_matches_jax(s2s_data):
    """Two chained 5-step closed-loop chunks (the carry and the feedback
    handed over) vs JAX's ``make_closed_loop_chunk`` with the pallas2 cell:
    predictions (physical units), feedback and carry, f32, 1e-4."""
    data, ds = s2s_data
    frames, prev0, _ = ds.continuous_stream()
    tree = _jax_tree(6, 11)
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    jrun = jeval.make_closed_loop_chunk(
        jm.ConvLSTMConfig(6, cell_impl="pallas2", **LAYERS), ds.normalizer, **geo)
    trun = teval.make_closed_loop_chunk(tm.ConvLSTMConfig(6, **LAYERS), ds.normalizer, **geo)
    params = bridge.params_from_jax(tree)
    jst = jeval.zero_closed_loop_state(jm.ConvLSTMConfig(6, **LAYERS), PADDED)
    tst = teval.zero_closed_loop_state(tm.ConvLSTMConfig(6, **LAYERS), PADDED)
    jprev = np.asarray(ds.normalizer.normalize_y(prev0), np.float32)[None]
    tprev = torch.from_numpy(jprev)
    for s in (0, 5):
        jst, jprev, jp = jrun(tree, jst, jprev, jnp.asarray(frames[s : s + 5]))
        tst, tprev, tp = trun(params, tst, tprev, frames[s : s + 5])
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), atol=1e-4)
    for (h, c), (jh, jc) in zip(tst, jst):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)


def test_predict_test_closed_loop_matches_jax(s2s_data):
    """The whole test split as one episode in 7-step chunks (a padded tail
    chunk): GTs equal, PDs f32 1e-4."""
    data, _ = s2s_data
    jds = jdata.Seq2SeqDataset(data, period="test", sequence_length=4)
    tds = tdata.Seq2SeqDataset(data, period="test", sequence_length=4)
    tree = _jax_tree(6, 12)
    want = jeval.predict_test_closed_loop(
        jm.ConvLSTMConfig(6, cell_impl="pallas2", **LAYERS), tree, jds,
        padded_shape=PADDED, chunk_steps=7)
    got = teval.predict_test_closed_loop(
        tm.ConvLSTMConfig(6, **LAYERS), bridge.params_from_jax(tree), tds,
        padded_shape=PADDED, chunk_steps=7)
    assert len(tds.continuous_stream()[0]) % 7 != 0
    np.testing.assert_array_equal(got["GTs"], want["GTs"])
    np.testing.assert_allclose(got["PDs"], want["PDs"], atol=1e-4)


# ---- data: Seq2SeqDataset and batch_iterator --------------------------------


@pytest.mark.parametrize("period", ["train", "val", "test"])
def test_seq2seq_dataset_matches_jax(s2s_data, period):
    """Samples, the continuous stream and the normalizer: exactly equal."""
    data, _ = s2s_data
    j = jdata.Seq2SeqDataset(data, period=period, sequence_length=4)
    t = tdata.Seq2SeqDataset(data, period=period, sequence_length=4)
    assert len(t) == len(j) > 0
    for i in (0, len(t) - 1):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(t.continuous_stream(), j.continuous_stream()):
        np.testing.assert_array_equal(a, b)
    for f in dataclasses.fields(tdata.Normalizer):
        np.testing.assert_array_equal(getattr(t.normalizer, f.name),
                                      getattr(j.normalizer, f.name))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)])
def test_batch_iterator_matches_jax(s2s_data, shuffle, drop_last):
    """The same batches in the same order, exactly equal, for any epoch."""
    _, ds = s2s_data
    for epoch in (1, 2):
        kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last, epoch=epoch)
        got, want = list(batch_iterator(ds, 3, **kw)), list(j_batch_iterator(ds, 3, **kw))
        assert len(got) == len(want) > 0
        for gb, wb in zip(got, want):
            for a, b in zip(gb, wb):
                np.testing.assert_array_equal(a, b)


# ---- the CLI ----------------------------------------------------------------


def _cli_argv(snap, *extra):
    return ["--model", "LSTM-s2s", "--device", "cpu", "--num-layers", "2",
            "--hidden-channels", "4", "3", "--kernel-size", "3", "3",
            "--batch-size", "2", "--sequence-length", "4", "--synthetic-steps", "60",
            "--synthetic-grid", *map(str, GRID), "--input-size", *map(str, PADDED),
            "--checkpoint-every", "1", "--snapshot-dir", snap, *extra]


def test_seq2seq_cli_checkpoint_loads_in_jax(tmp_path):
    """``--mode seq2seq --device cpu`` end to end: logger.npy with loss,
    R^2 and the closed-loop validation R^2 per epoch; the epoch checkpoint
    loads in JAX's ``load_checkpoint`` with its Adam state; a fine-tune
    from it with ``--use-checkpoint`` starts from its weights."""
    snap = str(tmp_path / "snap")
    cfg = parse_args(_cli_argv(snap, "--mode", "seq2seq", "--num-epochs", "2",
                               "--schedule-k", "5"))
    assert cfg.in_channels == 6 and cfg.schedule_k == 5.0
    cfg.dump()
    out = cli.main(cfg)
    with open(os.path.join(snap, "logger.npy"), "rb") as f:
        logs = [np.load(f) for _ in range(3)]
    assert all(a.shape == (2,) and np.isfinite(a).all() for a in logs)
    assert out["history"][0]["teacher_prob"] == js2s.inverse_sigmoid_schedule(1, 5.0)
    template = jm.convlstm_init(jax.random.PRNGKey(0), jm.ConvLSTMConfig(
        6, hidden_channels=(4, 3), kernel_sizes=(3, 3)))
    jparams, jstate, meta = jckpt.load_checkpoint(
        os.path.join(snap, "epoch-002"), template,
        jloop.make_optimizer(LR, BETAS).init(template))
    assert meta["epoch"] == 2 and int(jstate.count) == int(jstate.inner_state[0].count) > 0
    for a, b in zip(jax.tree.leaves(jparams),
                    jax.tree.leaves(bridge.params_to_jax(out["params"]))):
        np.testing.assert_array_equal(a, b)
    cfg2 = parse_args(_cli_argv(str(tmp_path / "ft"), "--mode", "seq2seq",
                                "--num-epochs", "1", "--use-checkpoint",
                                "--restore-from", os.path.join(snap, "epoch-002")))
    out2 = cli.main(cfg2)
    assert np.isfinite(out2["history"][0]["loss"])


def test_windowed_cli_with_hoist_and_config_keys(tmp_path):
    """``--precompute-input-conv`` trains the windowed mode through the
    hoisted route; the new keys round-trip through configurations.json with
    the JAX package both ways."""
    snap = str(tmp_path / "w")
    cfg = parse_args(_cli_argv(snap, "--in-channels", "7", "--num-epochs", "1",
                               "--precompute-input-conv"))
    assert cfg.precompute_input_conv and cfg.mode == "windowed"
    out = cli.main(cfg)
    assert np.isfinite(out["logger"]["MSELoss"][0])
    jpath = JTrainConfig(precompute_input_conv=True, schedule_k=4.0, mode="seq2seq",
                         snapshot_dir=str(tmp_path / "j")).dump()
    back = TrainConfig.load(jpath)
    assert back.precompute_input_conv and back.schedule_k == 4.0 and back.mode == "seq2seq"
    tpath = TrainConfig(precompute_input_conv=True, schedule_k=3.0,
                        snapshot_dir=str(tmp_path / "t")).dump()
    jback = JTrainConfig.load(tpath)
    assert jback.precompute_input_conv and jback.schedule_k == 3.0


def test_build_model_routes():
    """``build_model`` defaults to ``remat`` (the windowed trainer's BPTT
    route) and passes the hoist on."""
    kw = dict(in_channels=5, **{"hidden_channels": (4,), "kernel_sizes": (3,)})
    assert build_model("LSTM-r", **kw).config.remat
    x = _t(_seq(7, C=5, H=8, W=10, T=2))
    bundle = build_model("LSTM-r", precompute_input_conv=True, **kw)
    params, _ = bundle.init(torch.Generator().manual_seed(0))
    pred, _ = bundle.apply(params, None, x)
    assert _in_graph(pred, "FusedCellXgBackward")
    assert not _in_graph(pred, "_ScanCellsBackward")
    pred, _ = build_model("LSTM-r", **kw).apply(params, None, x)
    assert _in_graph(pred, "_ScanCellsBackward")


# ---- C1: fit_seq2seq streams its batches; C2: the serving hoist rule --------


def _sync_fit_seq2seq(cfg, params, ds, *, epochs, batch_size, seed):
    """The synchronous loop ``fit_seq2seq`` ran before it streamed its
    batches: ``batch_iterator``'s numpy batches fed to the step in turn,
    the draws from one generator seeded with ``seed``."""
    optimizer = tloop.make_optimizer(params, LR, BETAS)
    step = ts2s.make_seq2seq_train_step(cfg, ds.normalizer, optimizer,
                                        padded_shape=PADDED, grid_shape=GRID)
    gen = torch.Generator().manual_seed(seed)
    history, seen = [], []
    for epoch in range(1, epochs + 1):
        tp = ts2s.inverse_sigmoid_schedule(epoch, 10.0)
        losses, r2s = [], []
        for x, p0, y in batch_iterator(ds, batch_size, shuffle=True, seed=seed, epoch=epoch):
            seen.append(y)
            m = step(params, x, p0, y, gen, tp)
            losses.append(m["loss"])
            r2s.append(m["r2"])
        history.append({"epoch": epoch, "teacher_prob": tp,
                        "loss": float(torch.stack(losses).mean()),
                        "r2": float(torch.stack(r2s).mean())})
    return history, seen, gen


@pytest.mark.parametrize("remat", [False, True])
def test_fit_seq2seq_streamed_equals_the_synchronous_loop(s2s_data, remat, monkeypatch):
    """``fit_seq2seq`` takes its batches from ``async_batches``: the batches
    arrive in ``batch_iterator``'s order, the generator's draws and the
    per-epoch losses and R^2 are those of the synchronous loop, bit for
    bit (the same plain kernels on the same inputs)."""
    _, ds = s2s_data
    cfg = tm.ConvLSTMConfig(6, remat=remat, **LAYERS)
    tree = _jax_tree(6, 8)
    want, want_seen, want_gen = _sync_fit_seq2seq(cfg, _port_params(tree), ds, epochs=2,
                                                  batch_size=2, seed=5)
    seen, real = [], ts2s.async_batches

    def spy(*args, **kwargs):
        for batch in real(*args, **kwargs):
            seen.append(batch[2].numpy().copy())
            yield batch

    monkeypatch.setattr(ts2s, "async_batches", spy)
    gens = []
    real_gen = torch.Generator

    def generator(*a, **kw):
        gens.append(real_gen(*a, **kw))
        return gens[-1]

    monkeypatch.setattr(ts2s.torch, "Generator", generator)
    params = _port_params(tree)
    _, _, got = ts2s.fit_seq2seq(cfg, params, ds, padded_shape=PADDED, grid_shape=GRID,
                                 num_epochs=2, batch_size=2, learning_rate=LR, betas=BETAS,
                                 seed=5, verbose=False)
    assert got == want
    assert len(seen) == len(want_seen) == 2 * (len(ds) // 2)
    for a, b in zip(seen, want_seen):
        np.testing.assert_array_equal(a, b)
    assert len(gens) == 1
    assert torch.equal(gens[0].get_state(), want_gen.get_state())


def test_serving_hoist_default_is_the_measured_rule(monkeypatch):
    """``precompute_input_conv=None`` takes the unhoisted route (off, set
    from an H100 device-time reading, see make_rollout_fn): the model is
    asked for no hoist, and the rollout equals the unhoisted one bit for
    bit, while True asks for the hoist."""
    rng = np.random.default_rng(8)
    forcings = rng.standard_normal((1, 3, 5, *GRID)).astype(np.float32)
    norm = tdata.Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.0, 1.0)
    tcfg = tm.ConvLSTMConfig(5, **LAYERS)
    params = bridge.params_from_jax(_jax_tree(5, 9))
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    asked, real = [], troll.convlstm_apply

    def spy(*args, **kwargs):
        asked.append(kwargs["precompute_input_conv"])
        return real(*args, **kwargs)

    monkeypatch.setattr(troll, "convlstm_apply", spy)
    p_none, _ = troll.make_rollout_fn(tcfg, norm, **geo)(params, forcings)
    p_off, _ = troll.make_rollout_fn(tcfg, norm, precompute_input_conv=False, **geo)(
        params, forcings)
    troll.make_rollout_fn(tcfg, norm, precompute_input_conv=True, **geo)(params, forcings)
    assert asked == [False, False, True]
    assert torch.equal(p_none, p_off)
