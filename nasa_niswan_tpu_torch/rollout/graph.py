"""Serving loops replayed as CUDA graphs (the counterpart of ``jax.jit``
over the rollout's ``lax.scan`` in nasa_niswan_tpu/rollout/autoregressive.py).

A serving chunk is a few dozen small launches per step (the cells, the
concatenations, head, crop and unnormalize).  Dispatched one by one from
Python they cost more host time than the card spends on them, so on a CUDA
device a chunk is captured once per input signature (shapes, dtypes and
device of its tensors) and then replayed as one graph.  ``GraphRunner``
does that for every serving loop of the port: the open-loop rollout and its
streaming step, the closed-loop chunk and the multi-tracer rollouts.

What it keeps true:

* the weights a replay reads are made before the capture, by the caller's
  ``prepare(params)`` (the combined kernels and their packed images), so a
  replay runs only the per-step work and the capture makes no weight
  copy, pack or host-to-device copy;
* parameters are arguments, as under ``jax.jit``: a graph is keyed on the
  identity, storage and version of every parameter leaf
  (``params_key``), and a change of any (an in-place optimizer step, a new
  parameter tree) recaptures it; the entry holds the leaves, so no other
  tensor can take a leaf's identity and storage while the graph lives.  An
  in-place change that bypasses the version counter (a write through
  ``.data``) is not seen;
* the outputs handed back are copies, which the next replay does not touch;
* the kernel wrappers count launches in Python, which a replay does not
  run: the launches counted while capturing (every counter of
  ``ops.launch_counts``) are taken back and added once per replay, so the
  counters read what the card ran;
* the warm-up before a capture (library handles and workspaces are made
  there, not while capturing) runs the body on a short slice of the inputs
  when the caller gives ``warm``: one step of the chunk, not the chunk;
* a capture that fails raises.  There is no eager fallback; the eager body
  is the function that is captured, the CPU path, and the oracle of the
  card tests.

Under a profiler each call is a span ``niswan.graph.run``, holding
``niswan.graph.stage`` (the copies into the static buffers) and
``niswan.graph.replay`` (with its device time), or ``niswan.graph.capture``
(also counted, always, in ``utils/profiling.counters()``).  These spans and
``replay`` are shared with the training steps' ``train/graph.StepGraph``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from nasa_niswan_tpu_torch import ops
from nasa_niswan_tpu_torch.bridge import tree_leaves
from nasa_niswan_tpu_torch.utils.profiling import span


def params_key(params) -> Tuple[Tuple[int, int, int], ...]:
    """Per parameter leaf: (identity, data pointer, version).  An inference
    tensor has no version counter and counts as version 0."""
    return tuple(
        (id(t), t.data_ptr(), 0 if t.is_inference() else t._version)
        for t in tree_leaves(params)
    )


def replay(graph, static_in: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
           launches, device: torch.device) -> None:
    """One replay of a captured graph: each input copied into its static
    buffer (unless it is that buffer), the replay on the current stream,
    and the launches counted while capturing added as run."""
    with span("niswan.graph.stage"):
        for s, x in zip(static_in, inputs):
            if s is not x:
                s.copy_(x)
    with span("niswan.graph.replay", device=device):
        graph.replay()
    ops.add_launch_counts(launches)


def signature(inputs: Sequence[torch.Tensor]) -> tuple:
    """What one graph is captured for: each input's shape, dtype and device."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)


class _Entry:
    __slots__ = ("graph", "static_in", "static_out", "launches", "pkey", "leaves",
                 "weights")


class GraphRunner:
    """Runs ``body(params, weights, *inputs) -> tuple of tensors`` as a CUDA
    graph.

    ``prepare(params) -> weights`` is called outside the capture; ``body``
    must do only device work on its arguments (no host copies, no
    synchronisation).  ``warm(inputs) -> inputs``, when given, cuts the
    inputs the warm-up runs on (for a step loop: to one step).
    ``runner(params, inputs)`` copies the inputs into the
    graph's static buffers, replays, and returns copies of the outputs.
    ``captures`` counts the captures made.  ``capture_error_mode`` is
    ``torch.cuda.graph``'s: "global" (the default) fails a capture on an
    unsafe CUDA call from any thread, "thread_local" only from the
    capturing one (a sharded chunk: NCCL's watchdog thread polls its
    work's events while the capture runs).
    """

    def __init__(self, body: Callable, prepare: Callable,
                 warm: Optional[Callable] = None, capture_error_mode: str = "global"):
        self.body = body
        self.prepare = prepare
        self.warm = warm
        self.capture_error_mode = capture_error_mode
        self.captures = 0
        self._entries = {}
        self._stream = None
        self.last_inputs: List[torch.Tensor] = []

    def _capture(self, params, inputs, pkey) -> _Entry:
        device = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        e = _Entry()
        e.pkey, e.leaves = pkey, tree_leaves(params)
        e.weights = self.prepare(params)
        e.static_in = [x.clone() for x in inputs]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # a warm-up run on the capture stream: library loads, handles and
            # workspaces are made here, not while capturing (its launches ran
            # and stay counted)
            warm_in = e.static_in if self.warm is None else self.warm(e.static_in)
            self.body(params, e.weights, *warm_in)
        stream.synchronize()
        e.graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        try:
            with torch.cuda.graph(e.graph, stream=stream,
                                  capture_error_mode=self.capture_error_mode):
                e.static_out = tuple(self.body(params, e.weights, *e.static_in))
        finally:
            e.launches = {k: n - before.get(k, 0)
                          for k, n in ops.launch_counts().items() if n != before.get(k, 0)}
            ops.add_launch_counts(e.launches, -1)  # captured, not run
        torch.cuda.current_stream(device).wait_stream(stream)
        self.captures += 1
        return e

    def __call__(self, params, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        with span("niswan.graph.run"):
            key = signature(inputs)
            pkey = params_key(params)
            e = self._entries.get(key)
            if e is None or e.pkey != pkey:
                self._entries.pop(key, None)  # free the stale graph's pool first
                with span("niswan.graph.capture", counter="graph.capture_s"):
                    e = self._entries[key] = self._capture(params, inputs, pkey)
            replay(e.graph, e.static_in, inputs, e.launches, inputs[0].device)
            self.last_inputs = e.static_in
            return tuple(o.clone() for o in e.static_out)
