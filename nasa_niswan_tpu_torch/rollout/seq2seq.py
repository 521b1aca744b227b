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
implementations consume the same scheduled-sampling choices.  The mesh and
shard_map steps are not ported yet.
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
from nasa_niswan_tpu_torch.models.convlstm import CellFn, ConvLSTMConfig, GradsFn
from nasa_niswan_tpu_torch.ops.convgrad import cell_grads
from nasa_niswan_tpu_torch.ops.convlstm_bptt import combined_cells
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward
from nasa_niswan_tpu_torch.ops.seq2seq_bptt import feedback_step, scan_seq2seq
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves, save_checkpoint
from nasa_niswan_tpu_torch.train.loop import make_optimizer


def inverse_sigmoid_schedule(epoch: int, k: float = 10.0) -> float:
    """Teacher-forcing probability k/(k+exp(epoch/k)): starts near 1,
    anneals toward 0 (the classic scheduled-sampling decay)."""
    return k / (k + math.exp(epoch / k))


def _r2_from_stats(stats):
    """Chunk R^2 from the sufficient statistics ``(ss_res, s_y, s_y2, n)``."""
    ss_res, s_y, s_y2, n = stats
    return 1.0 - ss_res / (s_y2 - s_y * s_y / n)


def _chunk_stats(ys, preds):
    """Chunk-level R^2 sufficient statistics in normalized space (f32)."""
    flat_y, flat_p = ys.reshape(-1), preds.reshape(-1)
    return (
        torch.sum((flat_y - flat_p) ** 2),
        torch.sum(flat_y),
        torch.sum(flat_y * flat_y),
        torch.tensor(float(flat_y.numel()), device=ys.device),
    )


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
    (loss, (ss_res, s_y, s_y2, n))`` on device tensors: x raw (B, T, C-1,
    H, W) forcings, prev0 raw (B, H, W) concentration one step before the
    chunk, y raw (B, T, H, W) targets; the fifth argument is a
    ``torch.Generator`` or, with ``external_draws``, a (T, B) 0/1 matrix."""
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
            return loss, _chunk_stats(ys, preds)

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
        return torch.stack(losses).mean(), _chunk_stats(ys, preds)

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
):
    """``step(params, x, prev0, y, gen_or_draws, teacher_prob) -> metrics``:
    one Adam update of ``params`` in place from a raw (x, prev0, y) batch
    (numpy or tensors, moved to the parameters' device unless already
    there); metrics are device scalars ``loss`` and ``r2``.
    ``gen_or_draws`` is a ``torch.Generator`` or, with ``external_draws``,
    a (T, B) 0/1 matrix."""
    forward_chunk = _make_forward_chunk(
        config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        external_draws=external_draws,
    )

    def train_step(params, x, prev0, y, gen_or_draws, teacher_prob):
        dev = _device_of(params)
        x, prev0, y = (torch.as_tensor(a, device=dev) for a in (x, prev0, y))
        optimizer.zero_grad(set_to_none=True)
        loss, stats = forward_chunk(params, x, prev0, y, gen_or_draws, teacher_prob)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            return {"loss": loss.detach(), "r2": _r2_from_stats(stats)}

    return train_step


def make_seq2seq_eval_step(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
):
    """Closed-loop evaluation without grad: the whole chunk runs on the
    model's own feedback (teacher_prob = 0), the deployment condition.
    Returns ``eval_step(params, x, prev0, y) -> (loss, r2)``."""
    forward_chunk = _make_forward_chunk(
        config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        external_draws=True,
    )

    def eval_step(params, x, prev0, y):
        dev = _device_of(params)
        x, prev0, y = (torch.as_tensor(a, device=dev) for a in (x, prev0, y))
        with torch.no_grad():
            no_teacher = torch.zeros(x.shape[1], x.shape[0])
            loss, stats = forward_chunk(params, x, prev0, y, no_teacher, 0.0)
            return loss, _r2_from_stats(stats)

    return eval_step


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
):
    """Scheduled-sampling training over a Seq2SeqDataset, on the
    parameters' device.  Returns (params, optimizer, history).

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
    step = make_seq2seq_train_step(
        config, normalizer, optimizer, padded_shape=padded_shape,
        grid_shape=grid_shape,
    )
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
            device=_device_of(params),
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
        if verbose:
            extra = f", R2V: {rec['r2_val']:.5f}" if "r2_val" in rec else ""
            print(
                f"[seq2seq] Epoch: {epoch}, tf_prob: {tp:.3f}, "
                f"Loss: {rec['loss']:.5f}, R2: {rec['r2']:.5f}{extra}"
            )
        if snapshot_dir and checkpoint_every and epoch % checkpoint_every == 0:
            save_checkpoint(
                os.path.join(snapshot_dir, f"epoch-{epoch:03d}"),
                params, optimizer, learning_rate=learning_rate, epoch=epoch,
            )
    return params, optimizer, history
