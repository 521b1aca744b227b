"""Rank functions of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_dp.py), run by ``nasa_niswan_tpu_torch.parallel.launch.spawn``
on gloo ranks.  This module imports torch and the port only, so a spawned
rank starts without JAX; the inputs come from the test as numpy arrays.
Each function returns what the test compares: a rank's own tiles, and on
rank 0 the gathered results."""

import numpy as np
import torch

from nasa_niswan_tpu_torch import bridge
from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward_plain
from nasa_niswan_tpu_torch.parallel import spatial
from nasa_niswan_tpu_torch.parallel.halo import (
    halo_exchange_geo,
    halo_exchange_zero,
    sharded_conv2d,
)
from nasa_niswan_tpu_torch.parallel.mesh import gather_tiles, local_tile, make_mesh
from nasa_niswan_tpu_torch.rollout.multitracer import stack_params


def _np(t):
    return t.detach().cpu().float().numpy()


def _state_np(state):
    return [(_np(h), _np(c)) for h, c in state]


def spatial_world(rank, dims, case):
    """Every spatial check on one (dp, lat, lon) mesh: the halos and the
    sharded conv (per rank), then the tile cell, the sharded forward, the
    rollouts and the closed loop (gathered, on rank 0)."""
    mesh = make_mesh(*dims)
    g = case["geo"]
    out = {"coords": mesh.coords, "halo": {}}
    x = torch.from_numpy(case["x"])
    xl = local_tile(x, mesh, lat_axis=1, lon_axis=2, batch_axis=0)
    for pad in (1, 2):
        out["halo"][pad] = (_np(halo_exchange_zero(xl, pad, mesh)),
                            _np(halo_exchange_geo(xl, pad, mesh)))
    try:
        halo_exchange_zero(xl, xl.shape[2] + 1, mesh)
    except ValueError as e:
        out["pad_refused"] = str(e)
    k, kb = (torch.from_numpy(a) for a in case["conv"])
    out["conv"] = _np(sharded_conv2d(xl, k, kb, pad=k.shape[0] // 2, mesh=mesh))

    cells = {}
    for key, (xh, c, w, b) in case["cells"].items():
        dtype = torch.bfloat16 if key[1] == "bfloat16" else torch.float32
        xh_l, c_l = (local_tile(torch.from_numpy(a), mesh, lat_axis=1, lon_axis=2)
                     for a in (xh, c))
        h2, c2 = spatial.cell_on_tile(xh_l.to(dtype).contiguous(), c_l.contiguous(),
                                      torch.from_numpy(w).to(dtype), torch.from_numpy(b),
                                      mesh, fused_cell_forward_plain)
        cells[key] = tuple(_np(gather_tiles(t, mesh, lat_axis=1, lon_axis=2))
                           for t in (h2, c2))

    cfg = ConvLSTMConfig(**case["cfg"])
    params = bridge.params_from_jax(case["params"])
    norm = Normalizer(*case["norm"])
    pred = spatial.convlstm_apply_sharded(params, torch.from_numpy(case["x_padded"]), cfg,
                                          mesh)
    out_apply = _np(gather_tiles(pred, mesh, lat_axis=1, lon_axis=2))

    roll = spatial.make_sharded_rollout_fn(cfg, norm, mesh, **g)
    f1, f2 = (torch.from_numpy(a) for a in case["forcings"])
    p1, s1 = roll(params, f1)
    p2, s2 = roll(params, f2, s1)
    p12, s12 = roll(params, torch.cat([f1, f2], dim=1))
    g2, g12 = spatial.gather_state(s2, mesh), spatial.gather_state(s12, mesh)
    again, _ = roll(params, f2, spatial.scatter_state(spatial.gather_state(s1, mesh), mesh))

    stacked = stack_params([bridge.params_from_jax(t) for t in case["mt_params"]])
    norms = [Normalizer(*n) for n in case["mt_norms"]]
    mt = spatial.make_sharded_multitracer_rollout(cfg, norms, mesh, **g)
    mts = spatial.make_sharded_multitracer_rollout_shared(cfg, norms, mesh, **g)
    mt_f = torch.from_numpy(case["mt_forcings"])
    met, emis = (torch.from_numpy(a) for a in case["mt_shared"])
    h = mt_f.shape[3] // 2
    mt_out, mts_out = [], []
    st = sts = None
    for sl in (slice(None, h), slice(h, None)):
        p, st = mt(stacked, mt_f[:, :, sl], st)
        mt_out.append(_np(p))
        p, sts = mts(stacked, met[:, sl], emis[:, :, sl], sts)
        mts_out.append(_np(p))
    mt_state = spatial.gather_state(st, mesh, batch_axis=1)

    fcfg = ConvLSTMConfig(**case["fb_cfg"])
    fparams = bridge.params_from_jax(case["fb_params"])
    chunk = spatial.make_sharded_feedback_rollout(fcfg, Normalizer(*case["fb_norm"]), mesh,
                                                  **case["fb_geo"])
    frames = torch.from_numpy(case["fb_frames"])
    state, prev, fb = None, torch.from_numpy(case["fb_prev0"]), []
    for s in range(0, frames.shape[0], case["fb_chunk"]):
        state, prev, p = chunk(fparams, state, prev, frames[s:s + case["fb_chunk"]])
        fb.append(_np(p))
    fb_state = spatial.gather_state(state, mesh)

    graph = graph_ready(mesh, case, cfg, params, norm, stacked, norms, fcfg, fparams)
    grads = bf16_grads(mesh, case["bf16"]) if mesh.lat * mesh.lon > 1 else None

    if rank:
        return out
    out.update(graph=graph, bf16_grads=grads)
    out.update(
        cells=cells, apply=out_apply,
        rollout=dict(p1=_np(p1), p2=_np(p2), p12=_np(p12), again=_np(again),
                     s2=_state_np(g2), s12=_state_np(g12),
                     tile_shape=tuple(s1[0][0].shape)),
        mt=dict(preds=np.concatenate(mt_out, axis=2), shared=np.concatenate(mts_out, axis=2),
                state=_state_np(mt_state)),
        fb=dict(preds=np.concatenate(fb), prev=_np(prev), state=_state_np(fb_state)),
    )
    return out


def mesh_refusal(rank, dims):
    """``make_mesh`` with a product other than the world size raises."""
    try:
        make_mesh(*dims)
    except ValueError as e:
        return str(e)
    return None


def failing(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 waits here for the rank that died
    return rank


def dp_world(rank, case):
    """The data-parallel step (both training routes) over a (2,) mesh on
    the global batches ``case["batches"]``, and one epoch of
    ``fit_seq2seq(dp_devices=2)``."""
    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset, SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.seq2seq import fit_seq2seq
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step

    mesh = make_mesh(dp=2)
    data = synthetic_e33oma_90d(**case["data"])
    ds = SequenceDataset(data, period="train", **case["seq"])
    out = {}
    for route, remat in (("remat", True), ("per-cell", False)):
        bundle = build_model("LSTM-dp", remat=remat, **case["model"])
        params = bridge.params_from_jax(case["params"])
        for t in param_leaves(params):
            t.requires_grad_(True)
        opt = make_optimizer(params, *case["opt"])
        step = make_train_step(bundle, ds.normalizer, opt, mesh=mesh, **case["geo"])
        metrics = []
        for x, y in case["batches"]:
            bl = x.shape[0] // 2
            _, m = step(params, None, x[rank * bl:(rank + 1) * bl],
                        y[rank * bl:(rank + 1) * bl])
            metrics.append((m["loss"].item(), m["r2"].item()))
        out[route] = dict(metrics=np.array(metrics),
                          params=[_np(t) for t in param_leaves(params)])

    s2s = Seq2SeqDataset(data, period="train", sequence_length=case["seq"]["sequence_length"])
    cfg = ConvLSTMConfig(**case["s2s_cfg"])
    params = bridge.params_from_jax(case["s2s_params"])
    for t in param_leaves(params):
        t.requires_grad_(True)
    _, _, history = fit_seq2seq(cfg, params, s2s, dp_devices=2, verbose=False,
                                **case["s2s_fit"])
    out["seq2seq"] = history

    from nasa_niswan_tpu_torch.parallel.dp import fit_data_parallel
    from nasa_niswan_tpu_torch.train.config import TrainConfig

    val = SequenceDataset(data, period="val", **case["seq"])
    streamed = fit_data_parallel(
        build_model("LSTM-dp", **case["model"]), ds, val,
        TrainConfig(dp_devices=2, **case["fit"]), device="cpu", device_resident=False,
        verbose=False)
    out["streamed"] = streamed["logger"]
    return out


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def graph_ready(mesh, case, cfg, params, norm, stacked, norms, fcfg, fparams):
    """Each sharded serving entry point over two chained chunks three ways:
    the call, ``.eager``, and ``.body`` on ``.runner.weights``' output and
    ``.inputs``' tensors; per entry point, whether the three agree bit for
    bit (predictions and carries)."""
    g = case["geo"]
    f1, f2 = (torch.from_numpy(a) for a in case["forcings"])
    mt_f = torch.from_numpy(case["mt_forcings"])
    met, emis = (torch.from_numpy(a) for a in case["mt_shared"])
    h = mt_f.shape[3] // 2
    frames = torch.from_numpy(case["fb_frames"])
    n = case["fb_chunk"]
    prev0 = torch.from_numpy(case["fb_prev0"])

    def via_body(fn):
        def run(params, *args):
            return fn.body(params, fn.runner.weights(params), *fn.inputs(params, *args))
        return run

    def rollout_pair(run, nest):
        p1, s1 = nest(run(params, f1))
        p2, s2 = nest(run(params, f2, s1))
        return [p1, p2, *(t for hc in s2 for t in hc)]

    def stacked_pair(run, nest, parts):
        p1, s1 = nest(run(stacked, *parts(slice(None, h))))
        p2, s2 = nest(run(stacked, *parts(slice(h, None)), s1))
        return [p1, p2, *(t for hc in s2 for t in hc)]

    def feedback_pair(run, nest):
        st1, pr1, q1 = nest(run(fparams, None, prev0, frames[:n]))
        st2, pr2, q2 = nest(run(fparams, st1, pr1, frames[n:2 * n]))
        return [q1, q2, pr2, *(t for hc in st2 for t in hc)]

    def as_rollout(out):
        return out if isinstance(out[1], list) else (out[0], _nest(out[1:]))

    def as_feedback(out):
        if isinstance(out[0], list):
            return out
        prev, preds, *st = out
        return _nest(st), prev, preds

    fb_norm = Normalizer(*case["fb_norm"])
    entries = {
        "rollout": (spatial.make_sharded_rollout_fn(cfg, norm, mesh, **g),
                    lambda run: rollout_pair(run, as_rollout)),
        "multitracer": (spatial.make_sharded_multitracer_rollout(cfg, norms, mesh, **g),
                        lambda run: stacked_pair(run, as_rollout,
                                                 lambda sl: (mt_f[:, :, sl],))),
        "multitracer_shared": (
            spatial.make_sharded_multitracer_rollout_shared(cfg, norms, mesh, **g),
            lambda run: stacked_pair(run, as_rollout,
                                     lambda sl: (met[:, sl], emis[:, :, sl]))),
        "feedback": (spatial.make_sharded_feedback_rollout(fcfg, fb_norm, mesh,
                                                           **case["fb_geo"]),
                     lambda run: feedback_pair(run, as_feedback)),
    }
    out = {}
    for name, (fn, pair) in entries.items():
        call, eager, body = pair(fn), pair(fn.eager), pair(via_body(fn))
        out[name] = _equal(call, eager) and _equal(call, body)
    return out


def _nest(flat):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def bf16_grads(mesh, case):
    """One bf16 training step of the spatially sharded step on both routes
    from the same weights and batch: the all-reduced gradients per leaf."""
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import make_optimizer

    out = {}
    for route, remat in (("remat", True), ("per-cell", False)):
        bundle = build_model("LSTM-bf16", remat=remat, **case["model"])
        params = bridge.params_from_jax(case["params"])
        for t in param_leaves(params):
            t.requires_grad_(True)
        step = make_spatial_train_step(bundle, Normalizer(*case["norm"]),
                                       make_optimizer(params, 1e-3, (0.5, 0.999)), mesh,
                                       **case["geo"])
        step(params, None, *case["batch"])
        out[route] = [_np(t.grad) for t in param_leaves(params)]
    return out
