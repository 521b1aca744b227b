"""Multi-step seq2seq training with teacher forcing / scheduled sampling,
config #3 (counterpart of nasa_niswan_tpu/rollout/seq2seq.py, single
device).

The training step runs the model autoregressively over a T-step chunk: the
last input channel (the previous-step concentration, the reference's
feedback channel) is, per step and sample, either the ground truth (teacher
forcing) or the model's previous prediction, chosen by a Bernoulli draw with
probability ``teacher_prob``, annealed over training (scheduled sampling,
Bengio et al. 2015).  The loss is the step-averaged MSE + L1 over the whole
chunk; gradients flow through the feedback path.

Two routes, as in the JAX package (``_make_forward_chunk``):

* ``config.remat`` set: the whole-chunk BPTT autograd Function of
  ops/seq2seq_bptt.py (B1 forward, B2 + B3 backward on the card);
* otherwise (the CLI's default): a per-step loop (the JAX package's T=1
  ``convlstm_apply`` per step), whose cells differentiate through the
  per-cell Function ``FusedCell`` (B1's emit_gates mode, then B3 and B2's
  dW kernels).  Both routes and the closed loop (evalx/evaluate.py) share
  the step ``feedback_step``.

The Bernoulli draws come from an explicit ``torch.Generator`` (uniform <
teacher_prob, as ``jax.random.bernoulli`` draws); ``external_draws=True``
takes a precomputed (T, B) matrix instead, the seam that lets two
implementations consume the same scheduled-sampling choices.  The train
step draws before its body, outside the CUDA graph it replays on a card
(train/graph.py), and hands the body the draws.

``make_seq2seq_train_step`` with a mesh (``fit_seq2seq(dp_devices=N)``) is
the counterpart of ``make_seq2seq_train_step_shardmap``: each rank of a
(dp,) mesh runs the chunk on its share of the batch and the gradients are
averaged by parallel/dp.py's one all-reduce.  The draws stay global: every
rank draws the whole batch's (T, B) matrix from the same generator and
takes its own columns, so the trajectory is the single-device one.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import pad_geo
from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.data.pipeline import async_batches
from nasa_niswan_tpu_torch.evalx.metrics import r2_from_stats, r2_stats
from nasa_niswan_tpu_torch.models.convlstm import CellFn, ConvLSTMConfig, GradsFn
from nasa_niswan_tpu_torch.ops.convgrad import cell_grads
from nasa_niswan_tpu_torch.ops.convlstm_bptt import combined_cells
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward
from nasa_niswan_tpu_torch.ops.seq2seq_bptt import feedback_step, scan_seq2seq
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves, save_checkpoint
from nasa_niswan_tpu_torch.train.graph import graph_step, to_device
from nasa_niswan_tpu_torch.train.loop import make_optimizer


def inverse_sigmoid_schedule(epoch: int, k: float = 10.0) -> float:
    """Teacher-forcing probability k/(k+exp(epoch/k)): starts near 1,
    anneals toward 0 (the classic scheduled-sampling decay)."""
    return k / (k + math.exp(epoch / k))


def _draws(gen_or_draws, teacher_prob, T, B, device, external):
    """(T, B) f32 0/1 draws: given (external), or uniform < teacher_prob
    from the generator."""
    if external:
        d = torch.as_tensor(gen_or_draws)
    else:
        d = torch.rand((T, B), generator=gen_or_draws,
                       device=gen_or_draws.device) < teacher_prob
    return d.to(device=device, dtype=torch.float32)


def _make_forward_chunk(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    external_draws: bool = False,
    cell_fn: CellFn = fused_cell_forward,
    grads_fn: GradsFn = cell_grads,
):
    """``forward_chunk(params, x, prev0, y, gen_or_draws, teacher_prob) ->
    (loss, stats)`` on device tensors, stats the normalized chunk's R^2
    statistics (``evalx/metrics.r2_stats``): x raw (B, T, C-1, H, W)
    forcings, prev0 raw (B, H, W) concentration one step before the chunk,
    y raw (B, T, H, W) targets; the fifth argument is a ``torch.Generator``
    or, with ``external_draws``, a (T, B) 0/1 matrix."""
    if config.in_channels < 2:
        raise ValueError("seq2seq feedback training needs a feedback channel")
    dt = config.torch_dtype

    def forward_chunk(params, x, prev0, y, gen_or_draws, teacher_prob):
        B, T = x.shape[:2]
        xn = normalizer.normalize_x(x)  # (B, T, C-1, h, w)
        yn = normalizer.normalize_y(y)  # (B, T, h, w)
        prev0n = normalizer.normalize_y(prev0)
        # pad the forcings of every step up front; only the feedback channel
        # changes per step and is padded in the loop
        xs = torch.movedim(pad_geo(xn, padded_shape), 2, -1).transpose(0, 1)
        ys = yn.transpose(0, 1)  # (T, B, h, w)
        draws = _draws(gen_or_draws, teacher_prob, T, B, x.device, external_draws)
        H, W = xs.shape[2:4]
        state = [
            (torch.zeros((B, H, W, hc), device=x.device),
             torch.zeros((B, H, W, hc), device=x.device))
            for hc in config.hidden_channels
        ]
        leaves = param_leaves(params)
        if (config.remat and torch.is_grad_enabled()
                and any(t.requires_grad for t in leaves)):
            _, preds = scan_seq2seq(
                params, xs.to(dt).contiguous(), prev0n, ys, draws, state, dt,
                padded_shape, grid_shape, cell_fn, grads_fn,
            )
            err = ys - preds
            # equal to the per-step mean of means below (equal-size steps)
            loss = torch.mean(err**2) + torch.mean(torch.abs(err))
            return loss, r2_stats(ys, preds)

        head_w, head_b = params["head"]["w"], params["head"]["b"]
        prev, losses, preds = prev0n, [], []
        for t in range(T):
            # the weights are combined and cast every step, as by a T=1
            # convlstm_apply: their gradients then sum over the steps in f32
            state, pred = feedback_step(
                combined_cells(params, dt), head_w, head_b, xs[t], prev, state,
                dt, padded_shape, grid_shape, cell_fn,
            )
            losses.append(torch.mean((ys[t] - pred) ** 2)
                          + torch.mean(torch.abs(ys[t] - pred)))
            # next step's feedback: scheduled sampling per (t, sample)
            prev = torch.where(draws[t][:, None, None] > 0, ys[t], pred)
            preds.append(pred)
        preds = torch.stack(preds)
        return torch.stack(losses).mean(), r2_stats(ys, preds)

    return forward_chunk


def _device_of(params) -> torch.device:
    return param_leaves(params)[0].device


def make_seq2seq_train_step(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    optimizer: torch.optim.Optimizer,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    external_draws: bool = False,
    mesh=None,
):
    """``step(params, x, prev0, y, gen_or_draws, teacher_prob) -> metrics``:
    one Adam update of ``params`` in place from a raw (x, prev0, y) batch
    (numpy or tensors, moved to the parameters' device unless already
    there); metrics are device scalars ``loss`` and ``r2``.
    ``gen_or_draws`` is a ``torch.Generator`` or, with ``external_draws``,
    a (T, B) 0/1 matrix.

    With a ``mesh`` (parallel/mesh.py, dp ranks) the batch is this rank's
    share (B / dp samples) of a global batch: the (T, B) draws are the
    whole batch's (drawn from a generator in the same state on every rank,
    or given) and this rank takes its columns; between the backward and
    the Adam step ``parallel/dp.reduce_gradients`` averages the gradients
    and the loss and sums R^2's statistics, so every rank takes the same
    step and the metrics are the global batch's.

    The draws are made before the step, outside its graph (from the
    generator in the order the step would draw them, so the sequence is
    the same); ``teacher_prob`` goes in as a device scalar.  On a card
    each call is one CUDA graph replay (train/graph.py); ``step.eager``
    runs it without one."""
    forward_chunk = _make_forward_chunk(
        config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        external_draws=True,
    )
    r, n = (0, 1) if mesh is None else (mesh.index("dp"), mesh.dp)
    if mesh is not None:
        from nasa_niswan_tpu_torch.parallel.dp import reduce_gradients

    def prepare(params, x, prev0, y, gen_or_draws, teacher_prob):
        dev = _device_of(params)
        x, prev0, y = to_device(dev, x, prev0, y)
        bl, T = x.shape[:2]
        draws = _draws(gen_or_draws, teacher_prob, T, bl * n, dev,
                       external_draws)[:, r * bl:(r + 1) * bl].contiguous()
        return x, prev0, y, draws, torch.tensor(float(teacher_prob), device=dev)

    def train_step(params, x, prev0, y, draws, teacher_prob):
        optimizer.zero_grad(set_to_none=True)
        loss, stats = forward_chunk(params, x, prev0, y, draws, teacher_prob)
        loss.backward()
        with torch.no_grad():
            if mesh is not None:
                loss, stats = reduce_gradients(params, loss, stats, mesh)
            metrics = {"loss": loss.detach(), "r2": r2_from_stats(stats)}
        optimizer.step()
        return metrics

    return graph_step(train_step, (optimizer,), prepare=prepare)


def make_seq2seq_eval_step(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
):
    """Closed-loop evaluation without grad: the whole chunk runs on the
    model's own feedback (teacher_prob = 0), the deployment condition.
    Returns ``eval_step(params, x, prev0, y) -> (loss, r2)``; on a card
    one CUDA graph replay."""
    forward_chunk = _make_forward_chunk(
        config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        external_draws=True,
    )

    def prepare(params, x, prev0, y):
        x, prev0, y = to_device(_device_of(params), x, prev0, y)
        return x, prev0, y, torch.zeros((x.shape[1], x.shape[0]), device=x.device)

    def eval_step(params, x, prev0, y, no_teacher):
        with torch.no_grad():
            loss, stats = forward_chunk(params, x, prev0, y, no_teacher, 0.0)
            return loss, r2_from_stats(stats)

    return graph_step(eval_step, writes=False, prepare=prepare)


def fit_seq2seq(
    config: ConvLSTMConfig,
    params,
    dataset,
    *,
    val_dataset=None,
    normalizer: Optional[Normalizer] = None,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    num_epochs: int = 10,
    batch_size: int = 4,
    learning_rate: float = 1e-3,
    betas: Tuple[float, float] = (0.5, 0.999),
    schedule_k: float = 10.0,
    seed: int = 0,
    verbose: bool = True,
    snapshot_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    dp_devices: int = 1,
):
    """Scheduled-sampling training over a Seq2SeqDataset, on the
    parameters' device.  Returns (params, optimizer, history).

    ``dp_devices`` > 1 trains data-parallel: called on every rank of a
    process group of that size (``parallel/launch.spawn``), the parameters
    on the rank's device, each rank takes its share of every batch
    (``make_seq2seq_train_step`` with the mesh, draws global), validation runs whole
    batches on every rank, and rank 0 alone prints and writes checkpoints.

    Batches come in ``batch_iterator``'s order (shuffled by seed and epoch,
    the JAX package's order) through ``async_batches``: a producer thread
    stacks them in pinned memory and copies them to the device on a side
    stream while the step runs.  The draws come from one generator seeded
    with ``seed``.  When ``val_dataset`` is given, each epoch also runs fully
    closed-loop chunks over it, the last batch padded with its last sample.
    ``snapshot_dir`` + ``checkpoint_every`` write the windowed trainer's
    epoch-NNN layout."""
    if len(dataset) < batch_size:
        raise ValueError(
            f"{len(dataset)} training chunks, fewer than batch_size {batch_size}: "
            "no batch to train on"
        )
    normalizer = normalizer or dataset.normalizer
    optimizer = make_optimizer(params, learning_rate, betas)
    geo = dict(padded_shape=padded_shape, grid_shape=grid_shape)
    shard, lead, mesh = (0, 1), True, None
    if dp_devices > 1:
        from nasa_niswan_tpu_torch.parallel.mesh import make_mesh

        if batch_size % dp_devices:
            raise ValueError(f"batch_size ({batch_size}) must be divisible by "
                             f"dp_devices ({dp_devices})")
        mesh = make_mesh(dp=dp_devices)
        shard, lead = (mesh.index("dp"), dp_devices), mesh.rank == 0
    step = make_seq2seq_train_step(config, normalizer, optimizer, mesh=mesh, **geo)
    eval_step = None
    if val_dataset is not None:
        eval_step = make_seq2seq_eval_step(
            config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape
        )
    gen = torch.Generator().manual_seed(seed)
    history = []
    for epoch in range(1, num_epochs + 1):
        tp = inverse_sigmoid_schedule(epoch, schedule_k)
        losses, r2s = [], []
        for x_b, p0_b, y_b in async_batches(
            dataset, batch_size, shuffle=True, seed=seed, epoch=epoch,
            device=_device_of(params), shard=shard,
        ):
            m = step(params, x_b, p0_b, y_b, gen, tp)
            losses.append(m["loss"])
            r2s.append(m["r2"])
        rec = {
            "epoch": epoch,
            "teacher_prob": tp,
            "loss": float(torch.stack(losses).mean()),
            "r2": float(torch.stack(r2s).mean()),
        }
        if eval_step is not None:
            v_r2s = []
            nv = len(val_dataset)
            for s in range(0, max(nv - nv % batch_size, 0) or nv, batch_size):
                items = [val_dataset[i] for i in range(s, min(s + batch_size, nv))]
                if len(items) < batch_size:  # pad to keep the batch shape
                    items = items + [items[-1]] * (batch_size - len(items))
                xs, p0s, ys = zip(*items)
                _, r2v = eval_step(params, np.stack(xs), np.stack(p0s), np.stack(ys))
                v_r2s.append(r2v)
            rec["r2_val"] = float(torch.stack(v_r2s).mean())
        history.append(rec)
        if verbose and lead:
            extra = f", R2V: {rec['r2_val']:.5f}" if "r2_val" in rec else ""
            print(
                f"[seq2seq] Epoch: {epoch}, tf_prob: {tp:.3f}, "
                f"Loss: {rec['loss']:.5f}, R2: {rec['r2']:.5f}{extra}"
            )
        if lead and snapshot_dir and checkpoint_every and epoch % checkpoint_every == 0:
            save_checkpoint(
                os.path.join(snapshot_dir, f"epoch-{epoch:03d}"),
                params, optimizer, learning_rate=learning_rate, epoch=epoch,
            )
    return params, optimizer, history
