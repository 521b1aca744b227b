"""Faults planted underneath the timed path, to show that ``correct`` sees
them (the tests at a tiny size, ``calibrate.py`` at a cell's own size).

Serving (the rollout's cells, ``rollout.autoregressive.convlstm_apply``):
``state_unchanged`` hands the carry on as it came in; ``answer_altered``
scales the last prediction of each call by 1.5 where the tap produces it.
Training (``train.loop.make_loss_fn``, the optimizer): ``state_unchanged``
takes no optimizer step; ``half_batch`` takes the loss over the first half
of each batch alone; ``answer_altered`` scales the loss by 1.1;
``grad_altered_late`` scales the gradients that Adam reads by 1.1 from the
second step on, so that on a card only the replays of the step's CUDA
graph carry it (the first step runs eagerly, the capture follows it).  One
chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import nasa_niswan_tpu_torch.rollout.autoregressive as autoregressive
import nasa_niswan_tpu_torch.train.loop as train_loop
from niswan_bench.lib import training

SERVING = ("state_unchanged", "answer_altered")
TRAINING = ("state_unchanged", "half_batch", "answer_altered", "grad_altered_late")


def _serving(kind):
    real = autoregressive.convlstm_apply

    def broken(params, x, config, *, initial_state=None, **kw):
        pred, taps, state = real(params, x, config, initial_state=initial_state, **kw)
        if kind == "state_unchanged":
            state = [(h.clone(), c.clone()) for h, c in initial_state]
        else:
            taps = taps.clone()
            taps[:, -1] *= 1.5
        return pred, taps, state

    return broken


def _loss(kind):
    real = train_loop.make_loss_fn

    def make(bundle, grid_shape, mesh=None):
        loss_fn = real(bundle, grid_shape, mesh)

        def broken(params, state, x, y, rng=None):
            loss, aux = loss_fn(params, state, x, y, rng)
            if kind == "half_batch":
                half = x.shape[0] // 2
                return loss_fn(params, state, x[:half], y[:half], rng)[0], aux
            return loss * 1.1, aux

        return broken

    return make


def _stuck_optimizer(*args, **kw):
    opt = train_loop.make_optimizer(*args, **kw)
    opt.step = lambda *a, **k: None
    return opt


def _late_grad_optimizer(*args, **kw):
    opt = train_loop.make_optimizer(*args, **kw)
    real, calls = opt.step, [0]

    def step(*a, **k):
        calls[0] += 1
        if calls[0] > 1:  # the capture and every replay, not the eager first step
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.mul_(1.1)
        return real(*a, **k)

    opt.step = step
    return opt


@contextlib.contextmanager
def planted(kind: str, runner_kind: str):
    """Plant fault ``kind`` for a runner of ``runner_kind`` while the block runs."""
    serving = runner_kind.startswith("serve")
    if kind not in (SERVING if serving else TRAINING):
        raise ValueError(f"no fault {kind!r} for {runner_kind}")
    if serving:
        target, name, value = autoregressive, "convlstm_apply", _serving(kind)
    elif kind in ("state_unchanged", "grad_altered_late"):
        target, name = training, "make_optimizer"
        value = _stuck_optimizer if kind == "state_unchanged" else _late_grad_optimizer
    else:
        target, name, value = train_loop, "make_loss_fn", _loss(kind)
    saved = getattr(target, name)
    setattr(target, name, value)
    try:
        yield
    finally:
        setattr(target, name, saved)
