"""Calls replayed as CUDA graphs: every serving chunk, in-line step,
training and evaluation step of the port (the counterpart of ``jax.jit``
over the JAX package's rollout scans and steps, with ``(params,
opt_state)`` donated where a step trains).  Dispatched one launch at a
time from Python, a chunk's few dozen launches a step and a training
step's thousands cost more host time than the card spends on them, so on
a CUDA device ``Graphed`` captures a call once per signature and replays
it.  What it keeps true:

* the key: the argument tree's structure and every tensor's shape, dtype
  and device pick the graph; the identity and data pointer of every
  parameter and optimizer-state leaf, the lrs that are floats (a graph
  bakes them in) and the generator must match, or the call recaptures.
  The entry holds the leaves, so no other tensor can take a leaf's
  identity and storage while the graph lives.  A tensor lr
  (``train/loop.make_optimizer``) is read by the graph, so StepLR's
  ``fill_`` between replays takes effect;
* the weights: with a ``weights(params)`` hook (serving: the combined
  kernels and their packed images) what a replay reads is made before the
  capture, so each leaf's version keys the graph too and an in-place
  change recaptures (a write through ``.data`` is not seen; an inference
  tensor counts as version 0).  Without it the graph reads the parameters
  live and packs every cell kernel inside the capture
  (``convlstm_cell.capture_scope``); no version keys it, since a
  capture's Python ops bump them;
* the first call: with ``warm`` (a serving chunk) a throwaway eager run on
  ``warm(inputs)`` (one step), the capture, and a replay; without it the
  call's own eager run on the static buffers is its result (a training
  step makes Adam's state there, and takes no extra step), then the
  capture.  Library handles, workspaces and NCCL communicators are made by
  those eager runs, on the capture stream, not while capturing;
* the inputs are copied into the graph's static buffers (an input that is
  its buffer is not), which stay readable after the call (``last_inputs``:
  the in-line step's carry lives there); the outputs come back as copies;
* with ``writes`` (a training step) every parameter and optimizer-state
  leaf's version is bumped after a replay, which updated them without
  Python (caches keyed on versions see the update), and every
  parameter's ``.grad`` is the graph's gradient buffer, into which the
  first call copies its eager step's;
* a generator on the device is registered with the graph, so each replay
  draws what the eager sequence would;
* the launches the kernel wrappers count while capturing are taken back
  and added once per replay, which runs no Python;
* the capture is "thread_local": other threads' CUDA calls do not
  invalidate it (NCCL's watchdog; the pinned copies of
  ``data/pipeline.async_batches``' producer);
* a capture that fails raises; there is no eager fallback.  ``.eager`` is
  the body without a graph: the CPU path and the card tests' oracle.

Under a profiler each call on a card is a span ``niswan.graph.run``
holding ``niswan.graph.stage`` (the copies into the static buffers) and
``niswan.graph.replay`` (with its device time), after
``niswan.graph.capture`` on a signature's first call (also counted,
always, in ``utils/profiling.counters()["graph.capture_s"]``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch

from nasa_niswan_tpu_torch import ops
from nasa_niswan_tpu_torch.bridge import tree_leaves, tree_map, tree_paths, tree_unflatten
from nasa_niswan_tpu_torch.ops.convlstm_cell import capture_scope
from nasa_niswan_tpu_torch.utils.profiling import span


def on_card(device: torch.device) -> bool:
    """Whether calls on ``device`` replay as graphs (a CUDA device)."""
    return device.type == "cuda"


def optimizer_leaves(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor of the optimizer's state, by parameter in its groups'
    order (Adam: step, exp_avg, exp_avg_sq), and a tensor lr."""
    out = []
    for group in optimizer.param_groups:
        if isinstance(group.get("lr"), torch.Tensor):
            out.append(group["lr"])
        for p in group["params"]:
            out.extend(v for _, v in sorted(optimizer.state.get(p, {}).items())
                       if isinstance(v, torch.Tensor))
    return out


def signature(args: tuple):
    """The tensors of an argument tree and the graph they pick: each
    tensor's shape, dtype and device, after the tree's paths unless every
    argument is a tensor (a serving chunk)."""
    sig = [(a.shape, a.dtype, a.device) if isinstance(a, torch.Tensor) else None for a in args]
    if None not in sig:
        return args, tuple(sig)
    flat = tree_leaves(args)
    return flat, (tuple(tree_paths(args)), *[(t.shape, t.dtype, t.device) for t in flat])


class CudaGraph:
    """What ``Graphed`` needs of a CUDA graph on ``device``: ``eager(fn)``
    runs ``fn`` on the capture stream (the current stream waits for it),
    ``capture(fn)`` records it and returns its outputs (recorded, not run),
    ``replay()``.  ``generator``, a CUDA ``torch.Generator``, is registered
    with the graph."""

    def __init__(self, device: torch.device, generator=None):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None and generator.device.type == "cuda":
            self.graph.register_generator_state(generator)

    def eager(self, fn: Callable):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        for t in tree_leaves(out):
            t.record_stream(current)  # made on the capture stream, read on this one
        return out

    def capture(self, fn: Callable):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        # (graph, pool, stream, error mode): the module's "thread_local" capture
        with torch.cuda.graph(self.graph, None, self.stream, "thread_local"):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def replay(self) -> None:
        self.graph.replay()


class _Entry:
    __slots__ = ("graph", "key", "leaves", "weights", "static_in", "static_out", "out_template",
                 "launches", "params", "grads")


class Graphed:
    """Runs ``body(params, [weights,] *args[, rng=rng]) -> tree of tensors``
    as a CUDA graph when the arguments are on a card, eagerly elsewhere.

    ``args`` is a tree (``bridge.tree_leaves``: tensors, tuples, lists,
    dicts, None) of device tensors; ``params`` the parameter tree (a tuple
    of trees for two networks).  ``optimizers`` are those the body steps;
    ``weights(params)`` makes what ``body`` reads of the parameters,
    passed after them; ``warm(inputs) -> inputs`` cuts the flat inputs a
    first call warms up on; ``writes`` marks a training step (the module's
    notes).  ``rng``, a ``torch.Generator``, is passed as keyword ``rng``
    when given.  ``captures`` counts the captures; ``graph_class`` is
    ``CudaGraph`` (a stand-in replaces it in the CPU tests)."""

    graph_class = CudaGraph

    def __init__(self, body: Callable, optimizers: Sequence[torch.optim.Optimizer] = (), *,
                 weights: Optional[Callable] = None, warm: Optional[Callable] = None,
                 writes: bool = False):
        self.body = body
        self.optimizers = tuple(optimizers)
        self.weights = weights
        self.warm = warm
        self.writes = writes
        self.captures = 0
        self.last_inputs: List[torch.Tensor] = []
        self._entries = {}

    def _apply(self, params, weights, args, rng):
        head = (params,) if self.weights is None else (params, weights)
        return self.body(*head, *args, **({} if rng is None else {"rng": rng}))

    def eager(self, params, *args, rng=None):
        weights = None if self.weights is None else self.weights(params)
        return self._apply(params, weights, args, rng)

    def _leaves(self, params) -> List[torch.Tensor]:
        leaves = tree_leaves(params)
        for o in self.optimizers:
            leaves += optimizer_leaves(o)
        return leaves

    def key(self, params, rng=None) -> tuple:
        """What a graph replays only while it holds: per parameter and
        optimizer-state leaf its identity and data pointer (and its version
        with a ``weights`` hook), the lrs that are floats, the generator."""
        leaves = self._leaves(params)
        if self.weights is None:
            ids = tuple((id(t), t.data_ptr()) for t in leaves)
        else:
            ids = tuple((id(t), t.data_ptr(), 0 if t.is_inference() else t._version)
                        for t in leaves)
        lrs = tuple(g["lr"] for o in self.optimizers for g in o.param_groups
                    if not isinstance(g.get("lr"), torch.Tensor))
        return ids, lrs, id(rng)

    def __call__(self, params, *args, rng=None):
        lead = args[0] if isinstance(args[0], torch.Tensor) else tree_leaves(args)[0]
        if not on_card(lead.device):
            return self.eager(params, *args, rng=rng)
        with span("niswan.graph.run"):
            flat, sig = signature(args)
            device = flat[0].device
            e = self._entries.get(sig)
            if e is None or e.key != self.key(params, rng):
                self._entries.pop(sig, None)  # free the stale graph's pool first
                with span("niswan.graph.capture", counter="graph.capture_s"):
                    e, out = self._first_call(params, args, flat, device, rng)
                self._entries[sig] = e
                if self.warm is None:
                    self.last_inputs = e.static_in
                    return out
            with span("niswan.graph.stage"):
                for s, x in zip(e.static_in, flat):
                    if s is not x:
                        s.copy_(x)
            with span("niswan.graph.replay", device=device):
                e.graph.replay()
            ops.add_launch_counts(e.launches)
            if self.writes:
                torch.autograd.graph.increment_version(e.leaves)
                for p, g in zip(e.params, e.grads):
                    p.grad = g
            self.last_inputs = e.static_in
            return tree_unflatten(e.out_template, [o.clone() for o in e.static_out])

    def _first_call(self, params, args, flat, device, rng):
        """The eager run (the call's own, or a warm-up on ``warm``'s cut),
        then the capture; returns the entry and the call's own result."""
        e = _Entry()
        e.graph = self.graph_class(device, rng)
        e.weights = None if self.weights is None else self.weights(params)
        e.static_in = [x.clone() for x in flat]
        template = tree_map(lambda t: 0, args)  # the tree without its tensors

        def run(xs=e.static_in):
            return self._apply(params, e.weights, tree_unflatten(template, xs), rng)

        if self.warm is None:
            out = e.graph.eager(run)
        else:
            out = None  # the warm-up's result is thrown away
            e.graph.eager(lambda: run(self.warm(e.static_in)))
        e.params = tree_leaves(params) if self.writes else []
        eager_grads = [p.grad for p in e.params]
        # after the eager run, which made the optimizer's state
        e.leaves, e.key = self._leaves(params), self.key(params, rng)
        before = ops.launch_counts()
        try:
            with capture_scope() if self.weights is None else contextlib.nullcontext():
                captured = e.graph.capture(run)
        finally:
            e.launches = {k: n - before.get(k, 0)
                          for k, n in ops.launch_counts().items() if n != before.get(k, 0)}
            ops.add_launch_counts(e.launches, -1)  # captured, not run
        e.out_template, e.static_out = captured, tree_leaves(captured)
        e.grads = [p.grad for p in e.params]  # the buffers a replay writes
        with torch.no_grad():
            for p, g in zip(e.params, eager_grads):
                if p.grad is not None and g is not None:
                    p.grad.copy_(g)
                else:
                    p.grad = g
        self.captures += 1
        return e, out
