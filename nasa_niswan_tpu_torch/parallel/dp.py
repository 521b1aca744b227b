"""Data-parallel training over the dp axis of a mesh (counterpart of
nasa_niswan_tpu/parallel/dp.py: ``make_dp_train_step``,
``make_dp_train_step_shardmap``, ``make_dp_eval_step`` and
``fit_data_parallel``).

There is no step of its own: ``train/loop.build_train_step_fn`` and
``rollout/seq2seq.make_seq2seq_train_step`` take a ``mesh`` and then run
the single-device step (for the ConvLSTM: the whole-scan BPTT with
``remat``, the per-cell route, the hoisted input conv; kernels B1, B2 and
B3 on the rank's card) on the rank's share of the global batch, with
``reduce_gradients`` between the backward and the Adam step.  That one
``all_reduce`` sums, in one flat f32 buffer, every parameter gradient, the
loss and the batch's R^2 sufficient statistics over every rank of the
mesh; gradients and loss are then divided by dp, which is ``pmean``
exactly, and R^2 is rebuilt from the summed statistics (the global batch's
R^2, not a mean of the ranks').  Every rank then takes the same Adam step.
On a (dp, lat, lon) mesh the spatially sharded step
(parallel/spatial.py) uses the same all-reduce: each rank's gradients are
its tile's part, summed over lat and lon.  DDP's hooks are not used: the
parameters are a functional tree, not an ``nn.Module``, and the
whole-scan BPTT makes every gradient at its end, so bucketed overlap would
buy nothing.

The single-step families train so too, as the JAX package's GSPMD step
trains them (``make_dp_train_step``, the route of its ``fit`` for a
stateful model): the UNet's BatchNorms normalize by the global batch's
statistics, all-reduced over the dp group in the forward and the backward,
so the running statistics are the same on every rank; pix2pix draws the
global batch's dropout masks on every rank and keeps its own rows
(``ModelBundle.apply``'s ``mesh``).  ``gspmd_safe_bundle`` has no
counterpart: ``cell_impl`` is a TPU setting, recorded, ignored by the
port, which picks its kernels by device.  The GAN step (train/gan.py) has
no data-parallel form, in either package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

from nasa_niswan_tpu_torch.models.registry import ModelBundle
from nasa_niswan_tpu_torch.parallel.mesh import Mesh, make_mesh
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
from nasa_niswan_tpu_torch.train.loop import fit


def reduce_gradients(params, loss: torch.Tensor, stats: torch.Tensor,
                     mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one all-reduce of a DP or spatial step, after the backward, over
    every rank of the mesh: every parameter's gradient and the loss summed
    and divided by dp (written back into ``.grad``), the statistics
    ``stats`` summed.  A rank's gradient and loss are its dp share's (for
    a spatial step its tile's part of it), so this is the sum over lat and
    lon and the mean over dp.  The buffer is f32, or f64 for a model in
    f64.  Returns (mean loss, summed stats)."""
    leaves = param_leaves(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    dtype = functools.reduce(torch.promote_types, [g.dtype for g in grads], torch.float32)
    buf = torch.cat([g.reshape(-1).to(dtype) for g in grads]
                    + [loss.detach().reshape(1).to(dtype), stats.to(dtype)])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)  # the mesh spans the default group
    n_grad = buf.numel() - 1 - stats.numel()
    buf[: n_grad + 1].div_(mesh.dp)
    offset = 0
    for p, g in zip(leaves, grads):
        g.copy_(buf[offset : offset + g.numel()].view_as(g))
        p.grad = g
        offset += g.numel()
    return buf[n_grad], buf[n_grad + 1 :]


def fit_data_parallel(bundle: ModelBundle, train_dataset, val_dataset, config, **kwargs):
    """``train/loop.fit`` over a (dp,) mesh of ``config.dp_devices`` ranks:
    called on every rank of a process group of that size
    (``launch.spawn``), each rank on its own device.  ``kwargs`` go to
    ``fit`` (``device`` is the rank's)."""
    if config.batch_size % config.dp_devices:
        raise ValueError(f"batch_size ({config.batch_size}) must be divisible by "
                         f"dp_devices ({config.dp_devices})")
    mesh = make_mesh(dp=config.dp_devices)
    kwargs["device"] = mesh.device
    return fit(bundle, train_dataset, val_dataset, config, mesh=mesh, **kwargs)
