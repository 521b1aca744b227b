#!/usr/bin/env python3
"""One process of a multi-host run of the port, the twin of
scripts/multihost_worker.py.

    python scripts/torch_multihost_worker.py --port N --rank R [--world-size 2]
        [--device cuda] [--weights DIR]

Each process is one rank of its own "host": it sets ``MASTER_ADDR``
(localhost), ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK=0`` and
``LOCAL_WORLD_SIZE=1`` and joins the process group through ``env://``
(``parallel/mesh.init_distributed``; NCCL on cuda, gloo on the CPU), as a
rank started by a cluster launcher on another machine would.  On one machine
with several cards give each process its card through
``CUDA_VISIBLE_DEVICES`` (every process takes ``cuda:0``).  Then, every
rank running the same code:

* ``run_dp_step``: one data-parallel train step on a (dp = world size,)
  mesh, each rank feeding only its own share of the global batch;
* ``run_spatial_rollout``: two chained chunks of the sharded serving
  rollout on a (1, 1, world size) mesh: the conv halos cross the process
  boundary along lon;
* ``run_feedback_rollout``: two chained chunks of the sharded closed loop
  on a (1, world size, 1) mesh: the halos and the feedback frame's gather
  cross it along lat.

The sizes are the JAX worker's: B 8, T 3, a 16 x 24 grid (padded 20 x 28 for
the rollouts), hidden (4, 4), kernels (3, 3), f32.  ``--weights DIR`` loads
the three parameter sets from ``DIR/{dp,spatial,feedback}.npz`` (one array
per leaf, keyed by its path, e.g. ``cells/0/w_x``); without it they come from
torch seeds.  Each function called with ``mesh=None`` is the single-process
counterpart: ``make_train_step`` on the global batch, ``make_rollout_fn``
over the two chunks, ``make_closed_loop_chunk`` through
``run_chunked_episode_carry``.  Rank 0 prints one JSON line with the JAX
worker's keys (loss, r2, pred_mean, pred_std, fb_mean, fb_std), the SHA-256
of the parameters after the DP step and the kernel launches of this
process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B, T, H, W = 8, 3, 16, 24
PADDED = (20, 28)
HIDDEN, KERNELS = (4, 4), (3, 3)
SEEDS = {"dp": 0, "spatial": 2, "feedback": 4}  # the JAX worker's PRNG keys


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="device type of the ranks (cuda: NCCL; cpu: gloo)")
    ap.add_argument("--weights", default=None,
                    help="directory of dp.npz, spatial.npz, feedback.npz")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                      RANK=str(args.rank), WORLD_SIZE=str(args.world_size),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    import torch
    import torch.distributed as dist

    from nasa_niswan_tpu_torch import ops
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh

    device_type = torch.device(args.device).type
    if device_type == "cpu":
        torch.set_num_threads(1)
    # f32 throughout, as the JAX worker computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = init_distributed(device_type=device_type)
    if rank != args.rank:
        raise RuntimeError(f"joined as rank {rank}, asked for {args.rank}")
    n = args.world_size
    before = ops.launch_counts()
    loss, r2, params = run_dp_step(make_mesh(dp=n), args.weights)
    pmean, pstd = run_spatial_rollout(make_mesh(1, 1, n), args.weights)
    fmean, fstd = run_feedback_rollout(make_mesh(1, n, 1), args.weights)
    launches = {k: v - before.get(k, 0) for k, v in ops.launch_counts().items()}
    if rank == 0:
        print(json.dumps({"loss": loss, "r2": r2, "pred_mean": pmean, "pred_std": pstd,
                          "fb_mean": fmean, "fb_std": fstd,
                          "dp_params_sha256": params_digest(params), "launches": launches}),
              flush=True)
    dist.destroy_process_group()


def load_params(name: str, template, weights_dir=None):
    """The parameter set ``name``: ``template`` (a tree of tensors) itself,
    or the same tree read from ``<weights_dir>/<name>.npz``; every leaf on
    the template's device, requiring grad."""
    from nasa_niswan_tpu_torch.bridge import params_from_jax, tree_leaves, tree_paths, \
        tree_unflatten

    if weights_dir is not None:
        device = tree_leaves(template)[0].device
        with np.load(os.path.join(weights_dir, f"{name}.npz")) as z:
            leaves = [z[p] for p in tree_paths(template)]
        template = params_from_jax(tree_unflatten(template, leaves), device=device)
    for t in tree_leaves(template):
        t.requires_grad_(True)
    return template


def params_digest(params) -> str:
    """SHA-256 of every parameter leaf's bytes, in ``tree_leaves`` order."""
    import hashlib

    from nasa_niswan_tpu_torch.bridge import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _device(mesh, device):
    """The mesh's device, or ``device`` (default the CPU) without a mesh."""
    import torch

    return mesh.device if mesh is not None else torch.device(device or "cpu")


def _normalizer(y_mean: float, y_std: float):
    from nasa_niswan_tpu_torch.data.dataset import Normalizer

    return Normalizer(x_mean=np.zeros(5, np.float32), x_std=np.ones(5, np.float32),
                      y_mean=y_mean, y_std=y_std)


def _mean_std(preds):
    import torch

    preds = torch.stack(preds).double()
    return float(preds.mean()), float(preds.std(correction=0))


def run_dp_step(mesh, weights_dir=None, device=None):
    """One DP train step on a (dp,) mesh, this rank feeding rows
    [k B / dp, (k + 1) B / dp) of the global batch (``make_train_step`` with
    the mesh: one all-reduce); with ``mesh`` None the same step on the whole
    batch on ``device`` (default the CPU).  Returns the loss and R^2 (floats)
    and the parameters after the update."""
    import torch

    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step

    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, 5, H, W)).astype(np.float32)
    y = rng.standard_normal((B, H, W)).astype(np.float32)
    bundle = build_model("LSTM", in_channels=5, hidden_channels=HIDDEN,
                         kernel_sizes=KERNELS, remat=False)
    dev = _device(mesh, device)
    params, state = bundle.init(torch.Generator().manual_seed(SEEDS["dp"]), dev)
    params = load_params("dp", params, weights_dir)
    opt = make_optimizer(params, 1e-3, (0.9, 0.999))
    step = make_train_step(bundle, _normalizer(0.0, 1.0), opt, padded_shape=None,
                           grid_shape=(H, W), mesh=mesh)
    if mesh is not None:
        share = B // mesh.dp
        lo = mesh.index("dp") * share
        x, y = x[lo:lo + share], y[lo:lo + share]
    _, metrics = step(params, state, x, y)
    return float(metrics["loss"]), float(metrics["r2"]), params


def run_spatial_rollout(mesh, weights_dir=None, device=None):
    """Two chained chunks of the sharded serving rollout (B 2, T 3), the
    grid cut over the mesh's lat and lon; with ``mesh`` None the same two
    chunks through ``make_rollout_fn`` on ``device``.  Returns the (mean,
    std) of the physical-unit predictions, the same on every rank."""
    import torch

    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.parallel.spatial import make_sharded_rollout_fn
    from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn

    rng = np.random.default_rng(1)
    forc = rng.standard_normal((2, T, 5, H, W)).astype(np.float32)
    cfg = ConvLSTMConfig(5, HIDDEN, KERNELS)
    dev = _device(mesh, device)
    params = load_params("spatial", convlstm_init(
        torch.Generator().manual_seed(SEEDS["spatial"]), cfg, device=dev), weights_dir)
    geo = dict(padded_shape=PADDED, grid_shape=(H, W))
    if mesh is None:
        rollout = make_rollout_fn(cfg, _normalizer(0.1, 1.5), **geo)
    else:
        rollout = make_sharded_rollout_fn(cfg, _normalizer(0.1, 1.5), mesh, **geo)
    p1, st = rollout(params, forc)
    p2, _ = rollout(params, forc, st)
    return _mean_std([p1, p2])


def run_feedback_rollout(mesh, weights_dir=None, device=None):
    """Two chained chunks (T 3 each, the same forcings) of the sharded
    closed loop of config #3, the feedback frame gathered across the tiles
    every step; with ``mesh`` None the single-device closed loop
    (``make_closed_loop_chunk``) through ``run_chunked_episode_carry``
    over the two chunks on ``device``.  Returns the (mean, std) of the
    physical-unit predictions."""
    import torch

    from nasa_niswan_tpu_torch.evalx.evaluate import (
        make_closed_loop_chunk,
        run_chunked_episode_carry,
        zero_closed_loop_state,
    )
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.parallel.spatial import make_sharded_feedback_rollout

    rng = np.random.default_rng(3)
    met = rng.standard_normal((T, 5, H, W)).astype(np.float32)
    prev0 = rng.standard_normal((1, H, W)).astype(np.float32)
    cfg = ConvLSTMConfig(6, HIDDEN, KERNELS)  # 5 forcings + the feedback channel
    dev = _device(mesh, device)
    params = load_params("feedback", convlstm_init(
        torch.Generator().manual_seed(SEEDS["feedback"]), cfg, device=dev), weights_dir)
    geo = dict(padded_shape=PADDED, grid_shape=(H, W))
    if mesh is None:
        run = make_closed_loop_chunk(cfg, _normalizer(0.1, 1.5), **geo)
        preds, _ = run_chunked_episode_carry(
            lambda st, prev, x: run(params, st, prev, x),
            [zero_closed_loop_state(cfg, PADDED, dev), torch.as_tensor(prev0, device=dev)],
            torch.as_tensor(np.concatenate([met, met]), device=dev), T)
        return _mean_std([torch.as_tensor(preds)])
    run = make_sharded_feedback_rollout(cfg, _normalizer(0.1, 1.5), mesh, **geo)
    st, prev, p1 = run(params, None, prev0, met)
    _, _, p2 = run(params, st, prev, met)  # the carry continued
    return _mean_std([p1, p2])


if __name__ == "__main__":
    main()
