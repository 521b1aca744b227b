"""Training and evaluation steps as CUDA graph replays: the steps of
train/loop.py, rollout/seq2seq.py, train/gan.py and parallel/spatial.py
through ``graph.Graphed`` (whose notes say what a replay keeps true).

Under a profiler a step of ``graph_step`` is a span ``niswan.train.step``
holding ``niswan.train.upload`` (its ``prepare``) and, on a card, the
runner's ``niswan.graph.*`` spans.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Sequence

import torch

from nasa_niswan_tpu_torch.graph import Graphed
from nasa_niswan_tpu_torch.utils.profiling import span


def graph_step(body: Callable, optimizers: Sequence[torch.optim.Optimizer] = (), *,
               writes: bool = True, prepare: Optional[Callable] = None) -> Callable:
    """``step(params, *args, rng=None)``: ``prepare(params, *args)`` (moves
    host batches to the device, outside any graph; identity when None),
    then ``body(params, *args[, rng=rng])`` through a ``Graphed`` runner
    keyed on ``optimizers``, with ``writes`` for a training step.  With
    ``prepare``, one argument more than it takes is the rng, given by
    position.  ``step.eager`` runs the same with the body eager,
    ``step.runner`` is the runner."""
    runner = Graphed(body, optimizers, writes=writes)
    prep = prepare or (lambda params, *args: args)
    n_args = (len(inspect.signature(prepare).parameters) - 1) if prepare else None

    def split(args, rng):
        if n_args is not None and len(args) == n_args + 1:
            return args[:-1], args[-1]
        return args, rng

    def step(params, *args, rng=None):
        with span("niswan.train.step"):
            args, rng = split(args, rng)
            with span("niswan.train.upload"):
                args = prep(params, *args)
            return runner(params, *args, rng=rng)

    def eager(params, *args, rng=None):
        args, rng = split(args, rng)
        return runner.eager(params, *prep(params, *args), rng=rng)

    step.eager, step.runner, step.body = eager, runner, body
    return step


def to_device(device: torch.device, *xs: Any) -> tuple:
    """Each of ``xs`` (numpy, tensor or None) on ``device``; an int64 index
    vector stays int64."""
    return tuple(None if x is None else torch.as_tensor(x, device=device) for x in xs)
