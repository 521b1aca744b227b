"""Training and evaluation steps replayed as CUDA graphs (the counterpart of
``jax.jit`` with ``(params, opt_state)`` donated over the train and eval
steps of nasa_niswan_tpu/train/loop.py, rollout/seq2seq.py, train/gan.py
and parallel/spatial.py).

A training step of the port is thousands of launches (the per-cell routes
~2,600), dispatched one by one from Python.  On a CUDA device
``StepGraph`` captures the whole step (preprocessing, forward, backward,
the gradient all-reduce of a mesh, the optimizer update and the metrics)
once per input signature and replays it.  What it keeps true:

* the first call of a signature is that call's step, run eagerly on the
  capture stream: Adam's state, the library handles and the NCCL
  communicators are made there.  The graph is captured after it, which
  runs nothing, and the call returns the eager step's results: no extra
  optimizer step, unlike a serving chunk's warm-up (rollout/graph.py);
* the inputs (batches, window starts, lr-independent scalars, draws, the
  model state) are copied into the graph's static buffers; the outputs
  (metrics, the new model state) come back as copies;
* the graph is keyed on the input signature (shapes, dtypes, devices and
  the tree structure of the arguments), on the identity and data pointer
  of every parameter and optimizer-state leaf, the optimizer's lr and
  the dropout generator; not on versions, which the Python ops of a
  capture bump.  A new leaf (a restored optimizer state, a new parameter
  tree) recaptures; the entry holds the leaves, so no other tensor can
  take one's identity and storage while the graph lives.  The lr is a
  device tensor (``train/loop.make_optimizer``) that the graph reads, so
  StepLR's ``fill_`` between replays takes effect;
* a replay updates the parameters and the optimizer's state in place
  without Python, so after each replay of a training step the version of
  every leaf it writes is bumped
  (``torch.autograd.graph.increment_version``): caches keyed on versions
  (a serving graph's key, ``ops/convlstm_cell.packed_weights``) see the
  update;
* ``packed_weights`` packs every cell kernel inside the capture
  (``convlstm_cell.capture_scope``), so each replay packs the weights it
  updated, never reading a pack made before the capture;
* the kernel wrappers count launches in Python: the launches counted
  while capturing are taken back and added once per replay;
* after a call every parameter's ``.grad`` holds that call's gradients,
  as after an eager step: the graph's gradient buffers, into which the
  first call copies its eager step's;
* a dropout generator on the device is registered with the graph, so each
  replay draws the masks the eager sequence would;
* the capture runs in "thread_local" mode: other threads' CUDA calls do
  not invalidate it (NCCL's watchdog polls its events, and the producer
  thread of ``data/pipeline.async_batches`` allocates pinned memory and
  copies the next batches, while a step of ``fit`` is captured);
* a capture that fails raises; there is no eager fallback.  ``.eager`` of
  every graphed step is the body without a graph, the oracle of the card
  checks.  On the CPU the body runs eagerly.

Under a profiler a step of ``graph_step`` is a span ``niswan.train.step``
holding ``niswan.train.upload`` (its ``prepare``) and, on a card, the
runner's ``niswan.graph.*`` spans (rollout/graph.py, whose ``replay`` both
runners share).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, List, Optional, Sequence

import torch

from nasa_niswan_tpu_torch import ops
from nasa_niswan_tpu_torch.bridge import tree_leaves, tree_paths, tree_unflatten
from nasa_niswan_tpu_torch.rollout.graph import replay
from nasa_niswan_tpu_torch.utils.profiling import span


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


def _float_lrs(optimizers) -> tuple:
    """The lrs that are floats: a graph bakes them in, so they key it."""
    return tuple(g["lr"] for o in optimizers for g in o.param_groups
                 if not isinstance(g.get("lr"), torch.Tensor))


def on_card(device: torch.device) -> bool:
    """Whether steps on ``device`` replay as graphs (a CUDA device)."""
    return device.type == "cuda"


class CudaGraph:
    """What ``StepGraph`` needs of a CUDA graph on ``device``: ``eager(fn)``
    runs ``fn`` on the capture stream (the current stream waits for it),
    ``capture(fn)`` records it and returns its outputs (recorded, not run),
    ``replay()``.  ``generator``, a CUDA ``torch.Generator``, is registered
    with the graph.  The capture is "thread_local" (the module's notes)."""

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
        with torch.cuda.graph(self.graph, stream=self.stream, capture_error_mode="thread_local"):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def replay(self) -> None:
        self.graph.replay()


class _Entry:
    __slots__ = ("graph", "key", "leaves", "static_in", "args_template", "static_out",
                 "out_template", "launches", "rng", "params", "grads")


class StepGraph:
    """Runs ``body(params, *args[, rng=rng]) -> tree of tensors`` as a CUDA
    graph when the arguments are on a card, eagerly elsewhere.

    ``args`` is a tree (``bridge.tree_leaves``: tensors, tuples, lists,
    dicts, None) of device tensors; ``params`` is the parameter tree
    (a tuple of trees for two networks).  ``optimizers`` are the
    optimizers the body steps: their state and the parameters are the
    leaves the graph is keyed on, and with ``writes`` (a training step)
    every such leaf's version is bumped after each replay.  ``rng``, a
    ``torch.Generator`` the body draws from, is passed as keyword ``rng``
    when given.  ``captures`` counts the captures; ``.eager`` runs the
    body.  ``graph_class`` is ``CudaGraph`` (a stand-in replaces it in the
    CPU tests)."""

    graph_class = CudaGraph

    def __init__(self, body: Callable, optimizers: Sequence[torch.optim.Optimizer] = (),
                 *, writes: bool = True):
        self.body = body
        self.optimizers = tuple(optimizers)
        self.writes = writes
        self.captures = 0
        self._entries = {}

    def eager(self, params, *args, rng=None):
        return self.body(params, *args, **({} if rng is None else {"rng": rng}))

    def _leaves(self, params) -> List[torch.Tensor]:
        return tree_leaves(params) + [t for o in self.optimizers for t in optimizer_leaves(o)]

    def _key(self, leaves, rng) -> tuple:
        return (tuple((id(t), t.data_ptr()) for t in leaves), _float_lrs(self.optimizers),
                id(rng))

    def __call__(self, params, *args, rng=None):
        flat = tree_leaves(args)
        device = flat[0].device
        if not on_card(device):
            return self.eager(params, *args, rng=rng)
        with span("niswan.graph.run"):
            sig = (tuple(tree_paths(args)),
                   tuple((tuple(t.shape), t.dtype, t.device) for t in flat))
            leaves = self._leaves(params)
            e = self._entries.get(sig)
            if e is None or e.key != self._key(leaves, rng):
                self._entries.pop(sig, None)  # free the stale graph's pool first
                with span("niswan.graph.capture", counter="graph.capture_s"):
                    out, self._entries[sig] = self._first_call(params, args, flat, device, rng)
                return out
            replay(e.graph, e.static_in, flat, e.launches, device)
            if self.writes:
                torch.autograd.graph.increment_version(e.leaves)
                for p, g in zip(e.params, e.grads):
                    p.grad = g
            return tree_unflatten(e.out_template, [o.clone() for o in e.static_out])

    def _first_call(self, params, args, flat, device, rng):
        """The call's own step, eager on the capture stream, then the capture."""
        from nasa_niswan_tpu_torch.ops.convlstm_cell import capture_scope

        e = _Entry()
        e.graph = self.graph_class(device, rng)
        e.rng = rng
        e.static_in = [x.clone() for x in flat]
        e.args_template = args

        def run():
            return self.eager(params, *tree_unflatten(e.args_template, e.static_in), rng=rng)

        out = e.graph.eager(run)
        e.params = tree_leaves(params) if self.writes else []
        eager_grads = [p.grad for p in e.params]
        # the step made the optimizer's state: key on the leaves as they are now
        e.leaves = self._leaves(params)
        e.key = self._key(e.leaves, rng)
        before = ops.launch_counts()
        try:
            with capture_scope():
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
        return out, e


def graph_step(body: Callable, optimizers: Sequence[torch.optim.Optimizer] = (), *,
               writes: bool = True, prepare: Optional[Callable] = None) -> Callable:
    """``step(params, *args, rng=None)``: ``prepare(params, *args)`` (moves
    host batches to the device, outside any graph; identity when None),
    then ``body`` through a ``StepGraph``.  With ``prepare``, one argument
    more than it takes is the rng, given by position.  ``step.eager`` runs
    the same with the body eager, ``step.runner`` is the ``StepGraph``."""
    runner = StepGraph(body, optimizers, writes=writes)
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
