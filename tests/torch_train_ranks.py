"""Rank functions of the port's training-at-scale tests
(tests/test_torch_spatial_train.py, tests/test_torch_dp_stateful.py,
tests/test_torch_train_graph.py), run
by ``nasa_niswan_tpu_torch.parallel.launch.spawn`` on gloo ranks.  This
module imports torch and the port only, so a spawned rank starts without
JAX; the inputs come from the test as numpy arrays."""

import numpy as np
import torch
import torch.distributed as dist

from nasa_niswan_tpu_torch import bridge
from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.models.registry import build_model
from nasa_niswan_tpu_torch.parallel.halo import (
    halo_exchange_geo,
    halo_exchange_zero,
    halo_exchange_zero_transpose,
    sharded_conv2d,
)
from nasa_niswan_tpu_torch.parallel.mesh import gather_tiles, local_tile, make_mesh
from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step, set_learning_rate


def _np(t):
    t = t.detach().cpu()
    return (t if t.dtype == torch.float64 else t.float()).numpy()


def _sum(x: torch.Tensor) -> float:
    x = x.detach().double().reshape(1).clone()
    dist.all_reduce(x)
    return float(x[0])


def _trainable(tree):
    params = bridge.params_from_jax(tree)
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def spatial_world(rank, case):
    """Every check of tests/test_torch_spatial_train.py on one world of
    four ranks: ``halo_checks`` on each of ``case["halo_meshes"]``,
    ``spatial_steps`` on each of ``case["step_meshes"]``."""
    return {"halo": {dims: halo_checks(dims, case["halo"]) for dims in case["halo_meshes"]},
            "step": {dims: spatial_steps(dims, case["step"]) for dims in case["step_meshes"]}}


def halo_checks(dims, case):
    """The halo exchange's adjoint: for both halos and pads 1 and 2, the
    global sums <E x, y> and <x, E^T y> (E^T by autograd, and for the zero
    halo also ``halo_exchange_zero_transpose``, which must equal it); then
    ``sharded_conv2d``'s gradients (x gathered to the global grid, the
    kernel's and bias's summed over the ranks) for the cotangent ``g``."""
    mesh = make_mesh(*dims)
    x = local_tile(torch.from_numpy(case["x"]), mesh, lat_axis=1, lon_axis=2).contiguous()
    x.requires_grad_(True)
    rng = np.random.default_rng(100 + mesh.rank)
    out = {}
    for pad in (1, 2):
        for name, fn in (("zero", halo_exchange_zero), ("geo", halo_exchange_geo)):
            ext = fn(x, pad, mesh)
            y = torch.from_numpy(rng.standard_normal(tuple(ext.shape)).astype(np.float32))
            (ety,) = torch.autograd.grad(ext, x, grad_outputs=y)
            out[(name, pad)] = (_sum((ext.double() * y.double()).sum()),
                                _sum((x.double() * ety.double()).sum()))
            if name == "zero":
                out[("transpose", pad)] = bool(torch.equal(
                    halo_exchange_zero_transpose(y, pad, mesh), ety))
    k, b = (torch.from_numpy(a).requires_grad_(True) for a in case["conv"])
    g = local_tile(torch.from_numpy(case["g"]), mesh, lat_axis=1, lon_axis=2)
    conv = sharded_conv2d(x, k, b, pad=k.shape[0] // 2, mesh=mesh)
    dx, dk, db = torch.autograd.grad((conv * g).sum(), (x, k, b))
    for t in (dk, db):
        dist.all_reduce(t)
    out["conv"] = (_np(gather_tiles(dx, mesh, lat_axis=1, lon_axis=2)), _np(dk), _np(db))
    out["transpose_all"] = all(v for key, v in out.items() if key[0] == "transpose")
    return out


def spatial_steps(dims, case):
    """One spatially sharded training step on ``dims`` from the JAX
    weights and the global batch, on both routes: every rank's loss, R^2
    and parameters after the step; and on the (1, 2, 2) mesh one epoch of
    ``fit(mesh=)``."""
    mesh = make_mesh(*dims)
    norm = Normalizer(*case["norm"])
    out = {}
    for route, remat in (("remat", True), ("per-cell", False)):
        bundle = build_model("LSTM-t", remat=remat, **case["model"])
        params = _trainable(case["params"])
        opt = make_optimizer(params, *case["opt"])
        step = make_spatial_train_step(bundle, norm, opt, mesh, **case["geo"])
        _, m = step(params, None, *case["batch"])
        out[route] = dict(loss=m["loss"].item(), r2=m["r2"].item(),
                          params=[_np(t) for t in param_leaves(params)],
                          grads=[_np(t.grad) for t in param_leaves(params)])
    if dims == (1, 2, 2):
        from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
        from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
        from nasa_niswan_tpu_torch.train.config import TrainConfig
        from nasa_niswan_tpu_torch.train.loop import fit

        data = synthetic_e33oma_90d(**case["data"])
        ds, val = (SequenceDataset(data, period=p, sequence_length=case["seq"])
                   for p in ("train", "val"))
        res = fit(build_model("LSTM-t", **case["model"]), ds, val,
                  TrainConfig(**case["fit"]), device="cpu", mesh=mesh, verbose=False)
        out["fit"] = dict(logger=res["logger"],
                          params=[_np(t) for t in param_leaves(res["params"])])
    return out


def stateful_dp_world(rank, case):
    """The dp = 2 step of the UNet (global BatchNorm; ``unet-f64``: the
    weights, state and batch in float64) and of the pix2pix generator
    (dropout on, global masks; ``pix2pix-nodrop``: without a generator, so
    dropout off): each rank its half of the global batch; the parameters,
    their gradients and the model state after one step.  Then the GAN
    step's refusal on these ranks."""
    mesh = make_mesh(dp=2)
    out = {}
    for name in ("unet", "unet-f64", "pix2pix", "pix2pix-nodrop"):
        c = case[name.split("-")[0]]
        cast = (lambda t: t.double()) if name.endswith("f64") else (lambda t: t)
        bundle = build_model(c["model"], **c["kw"])
        params = bridge.tree_map(cast, bridge.params_from_jax(c["params"]))
        for t in param_leaves(params):
            t.requires_grad_(True)
        state = None if c["state"] is None else bridge.tree_map(
            cast, bridge.params_from_jax(c["state"]))
        opt = make_optimizer(params, *case["opt"])
        step = make_train_step(bundle, Normalizer(*c["norm"]), opt, mesh=mesh, **c["geo"])
        x, y = (a.astype(np.float64) if name.endswith("f64") else a for a in c["batch"])
        half = x.shape[0] // 2
        rng = None if name.endswith("nodrop") else torch.Generator().manual_seed(c["seed"])
        new_state, m = step(params, state, x[rank * half:(rank + 1) * half],
                            y[rank * half:(rank + 1) * half], rng)
        out[name] = dict(
            loss=m["loss"].item(), r2=m["r2"].item(),
            params=[_np(t) for t in param_leaves(params)],
            grads=[_np(t.grad) for t in param_leaves(params)],
            state=[_np(t) for t in bridge.tree_leaves(new_state)])

    from nasa_niswan_tpu_torch.models.pix2pix import DiscriminatorConfig, GeneratorConfig
    from nasa_niswan_tpu_torch.train.gan import make_gan_train_step

    try:
        make_gan_train_step(GeneratorConfig(), DiscriminatorConfig(), None, None)
    except ValueError as e:
        out["gan_refused"] = str(e)
    return out


def spatial_families_world(rank, case):
    """Every check of tests/test_torch_spatial_families.py on one world of
    four ranks: for each (name, dims) of ``case["runs"]`` the spatially
    sharded eval step (from the initial weights) and one training step of
    the model ``case[name]`` on a ``dims`` mesh (``family_step``); then
    one epoch of ``fit`` of a UNet over a (1, 2, 2) mesh."""
    out = {}
    for name, dims in case["runs"]:
        out[(name, dims)] = family_step(make_mesh(*dims), case[name], case["opt"])
    from nasa_niswan_tpu_torch.data.dataset import SingleStepDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.train.config import TrainConfig
    from nasa_niswan_tpu_torch.train.loop import fit

    f = case["fit"]
    data = synthetic_e33oma_90d(**f["data"])
    ds, val = (SingleStepDataset(data, period=p) for p in ("train", "val"))
    bundle = build_model(f["config"]["model"], **f["kw"])
    res = fit(bundle, ds, val, TrainConfig(**f["config"]), device="cpu",
              mesh=make_mesh(*f["dims"]), init_params=_trainable(f["params"]),
              init_state=bridge.params_from_jax(f["state"]), verbose=False)
    out["fit"] = dict(logger=res["logger"], params=[_np(t) for t in param_leaves(res["params"])],
                      state=[_np(t) for t in bridge.tree_leaves(res["state"])])
    return out


def family_step(mesh, c, opt):
    """The sharded eval step's per-sample scores at the initial weights,
    then one sharded training step of ``c["model"]`` from them on the
    global batch (weights, state and batch in ``c["dtype"]``; dropout drawn
    from a generator seeded ``c["seed"]``, or off for None): its loss, R^2,
    the parameters after it, their all-reduced gradients and the new
    state."""
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_eval_step

    f64 = c["dtype"] == "float64"
    cast = (lambda t: t.double()) if f64 else (lambda t: t)
    bundle = build_model(c["model"], **c["kw"])
    params = bridge.tree_map(cast, bridge.params_from_jax(c["params"]))
    for t in param_leaves(params):
        t.requires_grad_(True)
    state = None if c["state"] is None else bridge.tree_map(
        cast, bridge.params_from_jax(c["state"]))
    norm = Normalizer(*c["norm"])
    x, y = (a.astype(np.float64) if f64 else a for a in c["batch"])
    scores, _ = make_spatial_eval_step(bundle, norm, mesh, **c["geo"])(params, state, x, y)
    step = make_spatial_train_step(bundle, norm, make_optimizer(params, *opt), mesh, **c["geo"])
    rng = None if c["seed"] is None else torch.Generator().manual_seed(c["seed"])
    new_state, m = step(params, state, x, y, rng)
    return dict(loss=m["loss"].item(), r2=m["r2"].item(), scores=_np(scores),
                params=[_np(t) for t in param_leaves(params)],
                grads=[_np(t.grad) for t in param_leaves(params)],
                state=[_np(t) for t in bridge.tree_leaves(new_state)])


def graph_bodies_world(rank, case):
    """The data-parallel (2,) and spatially sharded (1, 1, 2) steps as
    ``train/graph.graph_step`` builds them on the graph runner (graph.py),
    called as a user calls them and through ``.eager`` (on gloo both run
    the body): two steps each from the same weights, the lr halved between
    them.  Every rank's losses and parameters."""
    norm = Normalizer(*case["norm"])
    x, y = case["batch"]
    lr, betas = case["opt"]
    out = {}
    for name, dims in (("dp", (2,)), ("spatial", (1, 1, 2))):
        mesh = make_mesh(*dims)
        for call in ("step", "eager"):
            bundle = build_model("LSTM-t", remat=case["remat"], **case["model"])
            params = _trainable(case["params"])
            opt = make_optimizer(params, lr, betas)
            if name == "dp":
                step = make_train_step(bundle, norm, opt, mesh=mesh, **case["geo"])
                h = x.shape[0] // 2
                batch = (x[rank * h:(rank + 1) * h], y[rank * h:(rank + 1) * h])
            else:
                step = make_spatial_train_step(bundle, norm, opt, mesh, **case["geo"])
                batch = (x, y)
            fn = step if call == "step" else step.eager
            losses = []
            for s in range(2):
                if s == 1:
                    set_learning_rate(opt, lr * 0.5)
                _, m = fn(params, None, *batch)
                losses.append(m["loss"].item())
            out[(name, call)] = dict(loss=losses,
                                     params=[_np(t) for t in param_leaves(params)])
    return out
