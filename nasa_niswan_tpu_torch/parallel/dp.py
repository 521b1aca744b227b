"""Data-parallel training over the dp axis of a mesh (counterpart of the
shard_map half of nasa_niswan_tpu/parallel/dp.py:
``make_dp_train_step_shardmap`` and ``fit_data_parallel``).

There is no step of its own: ``train/loop.build_train_step_fn`` and
``rollout/seq2seq.make_seq2seq_train_step`` take a ``mesh`` and then run
the single-device step (for the ConvLSTM: the whole-scan BPTT with
``remat``, the per-cell route, the hoisted input conv; kernels B1, B2 and
B3 on the rank's card) on the rank's share of the global batch, with
``reduce_gradients`` between the backward and the Adam step.  That one
``all_reduce`` sums, in one flat f32 buffer, every parameter gradient, the
loss and the batch's R^2 sufficient statistics; gradients and loss are
then divided by dp, which is ``pmean`` exactly, and R^2 is rebuilt from
the summed statistics (the global batch's R^2, not a mean of the ranks').
Every rank then takes the same Adam step.  DDP's hooks are not used: the
parameters are a functional tree, not an ``nn.Module``, and the whole-scan
BPTT makes every gradient at its end, so bucketed overlap would buy
nothing.

Only stateless models train so: a stateful model's state (the UNet's
BatchNorm statistics) would be computed per rank, where the JAX package
trains those families through GSPMD with global-batch statistics.  Neither
that nor ``make_dp_train_step`` (GSPMD) and ``gspmd_safe_bundle`` have a
counterpart; ``cell_impl`` is a TPU setting, and the port picks its kernels
by device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from nasa_niswan_tpu_torch.models.registry import ModelBundle
from nasa_niswan_tpu_torch.parallel.mesh import Mesh, make_mesh
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
from nasa_niswan_tpu_torch.train.loop import fit


def reduce_gradients(params, loss: torch.Tensor, stats: torch.Tensor,
                     mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one all-reduce of a DP step, after the backward: every
    parameter's gradient and the loss averaged over the dp ranks (written
    back into ``.grad``), the statistics ``stats`` summed.  Returns (mean
    loss, summed stats)."""
    leaves = param_leaves(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    buf = torch.cat([g.reshape(-1).float() for g in grads]
                    + [loss.detach().reshape(1).float(), stats.float()])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.groups["dp"])
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
