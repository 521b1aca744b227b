"""The port's spatially sharded serving (nasa_niswan_tpu_torch/parallel/:
mesh, launch, halo, spatial) on gloo ranks, against dense constructions,
the port's single-device functions and the JAX package's sharded
functions on the same mesh shape (on the 8 CPU devices tests/conftest.py
makes; ``cell_impl`` "auto" resolves to the XLA cell there).

One world of ranks is spawned per mesh, (1, 2, 2), (1, 1, 4) (a lon ring of
four), (1, 1, 2) (both neighbours one rank) and (1, 1, 1), and runs every
check (tests/torch_parallel_ranks.py); the tests read its results.  Shapes:
a 16 x 24 grid padded to 20 x 28, C = 5, hidden (8, 4), kernels (5, 3),
T <= 6.

Tolerances: halos bit-equal; sharded conv 1e-6 relative; the tile cell
step against the full-grid cell (plain versions) f32 1e-6, bf16 1e-3 (the
kernel-vs-plain limit of PERF.md section 2); rollouts 1e-5 of the target's
std (sums in other orders), chunked against one chunk of twice the length
1e-6; each sharded serving entry point's call, ``.eager`` and ``.body``
bit-equal over two chained chunks.

The bf16 training step on both routes against the port's single-device
step of the same route, per leaf relative to the leaf's largest: every
leaf within BF16_GRAD_TOL, twice the largest distance the whole-scan
(remat) route measures here (5.68e-3 on every mesh: the head's weight,
whose bf16 product each tile sums on its own in both routes; every other
remat leaf <= 6.4e-7), and the leaves both routes sum in f32 (the cells'
biases) within BF16_BIAS_TOL (remat <= 2.4e-7, per-cell <= 4.0e-7).
Before the per-cell route added its halo cotangents in f32 and kept each
tile's weight gradient in f32 until the all-reduce, its biases were
1.9e-5 - 1.9e-4 off and its kernels up to 1.34e-2 (the test prints each
leaf's distance)."""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.parallel import halo as jhalo  # noqa: E402
from nasa_niswan_tpu.parallel import mesh as jmesh  # noqa: E402
from nasa_niswan_tpu.parallel import spatial as jsp  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.evalx.evaluate import (  # noqa: E402
    make_closed_loop_chunk,
    run_chunked_episode_carry,
    zero_closed_loop_state,
)
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_apply  # noqa: E402
from nasa_niswan_tpu_torch.ops.conv import conv2d  # noqa: E402
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward_plain  # noqa: E402
from nasa_niswan_tpu_torch.parallel import launch  # noqa: E402
from nasa_niswan_tpu_torch.rollout import multitracer as tmt  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402

MESHES = [(1, 2, 2), (1, 1, 4), (1, 1, 2), (1, 1, 1)]
GRID, PADDED = (16, 24), (20, 28)
GEO = dict(padded_shape=PADDED, grid_shape=GRID)
C, T, S = 5, 3, 2
LAYERS = dict(hidden_channels=(8, 4), kernel_sizes=(5, 3))
FB_GRID, FB_PADDED, FB_T, FB_CHUNK = (12, 20), (16, 24), 6, 3
CELLS = [(k, dt) for k in (5, 3, 1) for dt in ("float32", "bfloat16")]
CELL_TOL = {"float32": 1e-6, "bfloat16": 1e-3}
ENTRIES = ["rollout", "multitracer", "multitracer_shared", "feedback"]
BF16_MESHES = [(1, 1, 2), (1, 2, 2), (1, 1, 4)]
BF16_MODEL = dict(in_channels=C, compute_dtype="bfloat16", **LAYERS)
BF16_SEQ, BF16_BATCH = 4, 4
BF16_GRAD_TOL = 1.1e-2  # 2 x 5.68e-3, the remat route's largest leaf distance
BF16_BIAS_TOL = 1e-5  # the f32-summed biases: remat <= 2.4e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _norm(rng, c):
    return (rng.normal(0.0, 0.2, c).astype(np.float32),
            (1.0 + rng.random(c)).astype(np.float32), 0.5, 2.0)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(9)
    jcfg = jm.ConvLSTMConfig(in_channels=C, **LAYERS)
    tree = lambda seed, cfg=jcfg: jax.tree.map(  # noqa: E731
        np.asarray, jm.convlstm_init(jax.random.PRNGKey(seed), cfg))
    cells = {}
    for k, dt in CELLS:
        cin, hid = 9, 8
        cells[(k, dt)] = (
            rng.standard_normal((2, *PADDED, cin)).astype(np.float32),
            rng.standard_normal((2, *PADDED, hid)).astype(np.float32),
            (rng.standard_normal((k, k, cin, 4 * hid)) / np.sqrt(k * k * cin)).astype(
                np.float32),
            (0.1 * rng.standard_normal(4 * hid)).astype(np.float32),
        )
    f = (3.0 + 2.0 * rng.standard_normal((2, 2 * T, C, *GRID))).astype(np.float32)
    fb_cfg = jm.ConvLSTMConfig(in_channels=4, hidden_channels=(4, 3), kernel_sizes=(3, 3))
    return dict(
        geo=GEO,
        x=rng.standard_normal((2, *PADDED, 3)).astype(np.float32),
        conv=((0.1 * rng.standard_normal((3, 3, 3, 7))).astype(np.float32),
              rng.standard_normal(7).astype(np.float32)),
        cells=cells,
        cfg=dict(in_channels=C, **LAYERS),
        params=tree(0),
        norm=_norm(rng, C),
        x_padded=rng.standard_normal((2, T, *PADDED, C)).astype(np.float32),
        forcings=(f[:, :T], f[:, T:]),
        mt_params=[tree(1), tree(2)],
        mt_norms=[_norm(rng, C) for _ in range(S)],
        mt_forcings=(3.0 + rng.standard_normal((S, 1, 2 * T, C, *GRID))).astype(np.float32),
        mt_shared=((3.0 + rng.standard_normal((1, 2 * T, C - 1, *GRID))).astype(np.float32),
                   (3.0 + rng.standard_normal((S, 1, 2 * T, *GRID))).astype(np.float32)),
        fb_cfg=dict(in_channels=4, hidden_channels=(4, 3), kernel_sizes=(3, 3)),
        fb_params=tree(3, fb_cfg),
        fb_norm=(np.linspace(-0.2, 0.1, 3).astype(np.float32),
                 np.linspace(0.8, 1.2, 3).astype(np.float32), 0.3, 2.0),
        fb_geo=dict(padded_shape=FB_PADDED, grid_shape=FB_GRID),
        fb_frames=rng.standard_normal((FB_T, 3, *FB_GRID)).astype(np.float32),
        fb_prev0=rng.standard_normal((1, *FB_GRID)).astype(np.float32),
        fb_chunk=FB_CHUNK,
        bf16=_bf16_case(tree(0)),
    )


def _bf16_case(params):
    """The bf16 training step's inputs: the weights of ``case``'s rollout
    model and a batch of the port's synthetic fixture at GRID."""
    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d

    ds = SequenceDataset(synthetic_e33oma_90d(T=40, seed=2, H=GRID[0], W=GRID[1]),
                         period="train", sequence_length=BF16_SEQ)
    xs, ys = zip(*(ds[i] for i in range(BF16_BATCH)))
    n = ds.normalizer
    return dict(model=BF16_MODEL, params=params, geo=GEO,
                batch=(np.stack(xs), np.stack(ys)),
                norm=(np.asarray(n.x_mean), np.asarray(n.x_std), float(n.y_mean),
                      float(n.y_std)))


@pytest.fixture(scope="module")
def world(case):
    """The ranks' results per mesh, each world spawned once."""
    worlds = {}

    def get(dims):
        if dims not in worlds:
            worlds[dims] = launch.spawn(ranks.spatial_world, int(np.prod(dims)), "cpu",
                                        dims, case, timeout=300)
        return worlds[dims]
    return get


def _jmesh(dims):
    return jmesh.make_mesh(*dims, devices=jax.devices()[: int(np.prod(dims))])


def _tile_of(a, coords, dims, ext=0):
    """The (lat, lon) tile of a global (B, H, W, ...) array at ``coords``,
    grown by ``ext`` on each side of an array padded by ``ext``."""
    _, i, j = coords
    h, w = (a.shape[1] - 2 * ext) // dims[1], (a.shape[2] - 2 * ext) // dims[2]
    return a[:, i * h: (i + 1) * h + 2 * ext, j * w: (j + 1) * w + 2 * ext]


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / max(np.max(np.abs(np.asarray(want))), 1e-30))


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_halo_exchange_matches_dense_and_jax(case, world, dims):
    """Both halos, pad 1 and 2, bit-equal to np.pad constructions of the
    whole grid and to the JAX package's halos inside shard_map; a halo
    wider than the tile is refused."""
    results = world(dims)
    x = case["x"]
    spec = P("dp", "lat", "lon", None)
    for pad in (1, 2):
        zero = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        geo = np.pad(np.pad(x, ((0, 0), (0, 0), (pad, pad), (0, 0)), mode="wrap"),
                     ((0, 0), (pad, pad), (0, 0), (0, 0)))
        jz, jg = (np.asarray(jax.jit(jax.shard_map(
            lambda t, f=f: f(t, pad), mesh=_jmesh(dims), in_specs=(spec,),
            out_specs=spec))(x)) for f in (jhalo.halo_exchange_zero, jhalo.halo_exchange_geo))
        for r in results:
            got_z, got_g = r["halo"][pad]
            np.testing.assert_array_equal(got_z, _tile_of(zero, r["coords"], dims, pad))
            np.testing.assert_array_equal(got_g, _tile_of(geo, r["coords"], dims, pad))
            # JAX's output is the extended tiles laid side by side
            _, i, j = r["coords"]
            hh, ww = got_z.shape[1:3]
            np.testing.assert_array_equal(got_z, jz[:, i * hh:(i + 1) * hh, j * ww:(j + 1) * ww])
            np.testing.assert_array_equal(got_g, jg[:, i * hh:(i + 1) * hh, j * ww:(j + 1) * ww])
    assert all("exceeds local extent" in r["pad_refused"] for r in results)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_sharded_conv2d_matches_conv_and_jax(case, world, dims):
    results = world(dims)
    x = case["x"]
    k, b = case["conv"]
    want = conv2d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                  padding=1).numpy()
    spec = P("dp", "lat", "lon", None)
    jgot = np.asarray(jax.jit(jax.shard_map(
        lambda t: jhalo.sharded_conv2d(t, k, b, pad=1), mesh=_jmesh(dims),
        in_specs=(spec,), out_specs=spec))(x))
    for r in results:
        assert _rel(r["conv"], _tile_of(want, r["coords"], dims)) <= 1e-6
        assert _rel(r["conv"], _tile_of(jgot, r["coords"], dims)) <= 1e-6


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_tile_cell_step_matches_full_grid(case, world, dims):
    """The cell step on halo-extended tiles, stitched, equals the cell on
    the whole grid: k = 5, 3 (halo 2, 1) and 1 (no halo), f32 and bf16."""
    got = world(dims)[0]["cells"]
    for (k, dt), (xh, c, w, b) in case["cells"].items():
        dtype = torch.bfloat16 if dt == "bfloat16" else torch.float32
        want = fused_cell_forward_plain(torch.from_numpy(xh).to(dtype), torch.from_numpy(c),
                                        torch.from_numpy(w).to(dtype), torch.from_numpy(b))
        for g, t in zip(got[(k, dt)], want):
            assert g.shape == tuple(t.shape)
            np.testing.assert_allclose(g, t.numpy(), rtol=0, atol=CELL_TOL[dt],
                                       err_msg=f"k={k} {dt}")


def _std_close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape
    assert float(np.max(np.abs(np.asarray(got) - want))) <= tol * float(want.std())


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_sharded_rollout_matches_single_device_and_jax(case, world, dims):
    """``convlstm_apply_sharded`` against ``convlstm_apply``; the sharded
    rollout over two chunks through its tile carry against
    ``make_rollout_fn`` and the JAX package's ``make_sharded_rollout_fn``
    on the same mesh shape; two chunks equal one of twice the length; a
    carry gathered and scattered again continues the same run."""
    r = world(dims)[0]
    cfg = ConvLSTMConfig(**case["cfg"])
    params = bridge.params_from_jax(case["params"])
    norm = Normalizer(*case["norm"])
    want = convlstm_apply(params, torch.from_numpy(case["x_padded"]), cfg).detach().numpy()
    _std_close(r["apply"], want)

    ro = r["rollout"]
    H, W = PADDED
    assert ro["tile_shape"] == (2, H // dims[1], W // dims[2], 8)
    f1, f2 = case["forcings"]
    ref = make_rollout_fn(cfg, norm, **GEO)
    q1, s1 = ref(params, f1)
    q2, s2 = ref(params, f2, s1)
    jro = jsp.make_sharded_rollout_fn(jm.ConvLSTMConfig(**case["cfg"]),
                                      jdata.Normalizer(*case["norm"]), _jmesh(dims), **GEO)
    j1, js1 = jro(case["params"], f1)
    j2, js2 = jro(case["params"], f2, js1)
    for got, want_t, want_j in ((ro["p1"], q1, j1), (ro["p2"], q2, j2)):
        _std_close(got, want_t.numpy())
        _std_close(got, np.asarray(want_j))
    for (h, c), (th, tc), (jh, jc) in zip(ro["s2"], s2, js2):
        _std_close(h, th.numpy())
        _std_close(c, tc.numpy())
        _std_close(h, np.asarray(jh))
        _std_close(c, np.asarray(jc))
    both = np.concatenate([ro["p1"], ro["p2"]], axis=1)
    assert np.max(np.abs(both - ro["p12"])) <= 1e-6
    for (h, c), (h12, c12) in zip(ro["s2"], ro["s12"]):
        assert np.max(np.abs(h - h12)) <= 1e-6 and np.max(np.abs(c - c12)) <= 1e-6
    np.testing.assert_array_equal(ro["again"], ro["p2"])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_sharded_multitracer_rollouts_match(case, world, dims):
    """Both sharded multi-tracer rollouts (per-species forcings; shared
    meteorology), in two chunks through the stacked tile carry, against
    rollout/multitracer.py and the JAX package's sharded ones."""
    mt = world(dims)[0]["mt"]
    cfg = ConvLSTMConfig(**case["cfg"])
    jcfg = jm.ConvLSTMConfig(**case["cfg"])
    stacked = tmt.stack_params([bridge.params_from_jax(t) for t in case["mt_params"]])
    jstacked = jax.tree.map(lambda *a: np.stack(a), *case["mt_params"])
    norms = [Normalizer(*n) for n in case["mt_norms"]]
    jnorms = [jdata.Normalizer(*n) for n in case["mt_norms"]]
    f = case["mt_forcings"]
    met, emis = case["mt_shared"]
    want, st = tmt.make_multitracer_rollout(cfg, norms, **GEO)(stacked, f)
    want_s, _ = tmt.make_multitracer_rollout_shared(cfg, norms, **GEO)(stacked, met, emis)
    jmesh_ = _jmesh(dims)
    jwant, _ = jsp.make_sharded_multitracer_rollout(jcfg, jnorms, jmesh_, **GEO)(jstacked, f)
    jwant_s, _ = jsp.make_sharded_multitracer_rollout_shared(jcfg, jnorms, jmesh_, **GEO)(
        jstacked, met, emis)
    _std_close(mt["preds"], want.numpy())
    _std_close(mt["preds"], np.asarray(jwant))
    _std_close(mt["shared"], want_s.numpy())
    _std_close(mt["shared"], np.asarray(jwant_s))
    for (h, c), (th, tc) in zip(mt["state"], st):
        _std_close(h, th.numpy())
        _std_close(c, tc.numpy())


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_sharded_feedback_rollout_matches_closed_loop(case, world, dims):
    """The sharded closed loop, chunked through its tile carry, against
    ``make_closed_loop_chunk`` and the JAX package's sharded feedback
    rollout: predictions, the feedback frame and the carry."""
    fb = world(dims)[0]["fb"]
    cfg = ConvLSTMConfig(**case["fb_cfg"])
    params = bridge.params_from_jax(case["fb_params"])
    frames, prev0 = case["fb_frames"], case["fb_prev0"]
    ref = make_closed_loop_chunk(cfg, Normalizer(*case["fb_norm"]), **case["fb_geo"])
    want, (st, prev) = run_chunked_episode_carry(
        lambda s, p, x: ref(params, s, p, x),
        [zero_closed_loop_state(cfg, FB_PADDED), torch.from_numpy(prev0)], frames, FB_CHUNK)
    jcfg = jm.ConvLSTMConfig(**case["fb_cfg"])
    jchunk = jsp.make_sharded_feedback_rollout(jcfg, jdata.Normalizer(*case["fb_norm"]),
                                               _jmesh(dims), **case["fb_geo"])
    from nasa_niswan_tpu.evalx.evaluate import run_chunked_episode_carry as j_run
    from nasa_niswan_tpu.evalx.evaluate import zero_closed_loop_state as j_zero

    jwant, (jst, jprev) = j_run(lambda s, p, x: jchunk(case["fb_params"], s, p, x),
                                [j_zero(jcfg, FB_PADDED), prev0], frames, FB_CHUNK)
    _std_close(fb["preds"], want)
    _std_close(fb["preds"], jwant)
    _std_close(fb["prev"], prev.numpy())
    _std_close(fb["prev"], np.asarray(jprev))
    for (h, c), (th, tc) in zip(fb["state"], st):
        _std_close(h, th.numpy())
        _std_close(c, tc.numpy())


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_sharded_entry_points_call_eager_and_body_agree(world, dims, entry):
    """The graph-ready split of each sharded serving entry point: the call
    (a graph replay on a card, the body run eagerly here), ``.eager``, and
    ``.body`` on ``.runner.weights``' output and ``.inputs``' tensors give
    bit-equal predictions and carries over two chained chunks."""
    assert world(dims)[0]["graph"][entry]


@pytest.fixture(scope="module")
def bf16_single(case):
    """The port's single-device bf16 step on both routes: its gradients."""
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step

    b = case["bf16"]
    out = {}
    for route, remat in (("remat", True), ("per-cell", False)):
        params = bridge.params_from_jax(b["params"])
        for t in param_leaves(params):
            t.requires_grad_(True)
        step = make_train_step(build_model("LSTM-bf16", remat=remat, **b["model"]),
                               Normalizer(*b["norm"]),
                               make_optimizer(params, 1e-3, (0.5, 0.999)), **GEO)
        step(params, None, *b["batch"])
        out[route] = [t.grad.float().numpy() for t in param_leaves(params)]
    return out


@pytest.mark.parametrize("route", ["remat", "per-cell"])
@pytest.mark.parametrize("dims", BF16_MESHES, ids=lambda d: "x".join(map(str, d)))
def test_bf16_sharded_gradients_match_the_device_step_per_leaf(world, bf16_single, dims,
                                                               route):
    """In bf16, each leaf of the sharded step's gradient against the
    single-device step of the same route, relative to the leaf's largest:
    both routes within the same bounds (BF16_GRAD_TOL; the biases, summed
    in f32 by both, BF16_BIAS_TOL).  The per-cell route adds the halo
    strips' cotangents to B3's f32 dxh before its one cast to bf16."""
    got = world(dims)[0]["bf16_grads"][route]
    want = bf16_single[route]
    names = ["b", "w_h", "w_x"] * len(LAYERS["hidden_channels"]) + ["head/b", "head/w"]
    rels = [float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))
            for a, b in zip(got, want)]
    print(f"{dims} {route}: " + " ".join(f"{n} {r:.2e}" for n, r in zip(names, rels)))
    for name, rel in zip(names, rels):
        tol = BF16_BIAS_TOL if name == "b" else BF16_GRAD_TOL
        assert rel <= tol, (name, rel, tol)


def test_make_mesh_refuses_another_world_size():
    msg = launch.spawn(ranks.mesh_refusal, 2, "cpu", (1, 1, 4), timeout=120)
    assert all("1x1x4=4 != world size 2" in m for m in msg)


def test_spawn_raises_when_a_rank_fails():
    """A rank that raises makes spawn raise with its traceback, and the rank
    waiting on it in a collective is killed, not left to hang."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(ranks.failing, 2, "cpu", timeout=120)


def test_spawn_on_cuda_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices, 1 visible"):
        launch.spawn(ranks.failing, 2, "cuda")


@pytest.mark.parametrize("cards, env, refusal", [
    (8, dict(LOCAL_RANK="1", LOCAL_WORLD_SIZE="8"), None),
    (4, dict(LOCAL_RANK="1", LOCAL_WORLD_SIZE="8"), "8 ranks on this host need 8 CUDA "
                                                    "devices, 4 visible"),
    (4, dict(LOCAL_RANK="5"), "6 ranks on this host need 6 CUDA devices, 4 visible"),
], ids=["8-cards", "4-cards", "local-rank-5"])
def test_spawn_under_torchrun_counts_the_cards_of_this_host(monkeypatch, cards, env, refusal):
    """Under torchrun a job of 2 hosts x 8 cards (WORLD_SIZE 16) needs 8
    cards on each host, not 16: the ranks of this host (LOCAL_WORLD_SIZE,
    and LOCAL_RANK's card) are held against its cards."""
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("RANK", "9")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if refusal is None:
        launch.check_devices(16, "cuda")
        # past the device check, spawn holds the asked world size to torchrun's
        with pytest.raises(ValueError, match="torchrun started 16 ranks, 8 asked for"):
            launch.spawn(ranks.failing, 8, "cuda")
    else:
        with pytest.raises(RuntimeError, match=refusal):
            launch.spawn(ranks.failing, 16, "cuda")

