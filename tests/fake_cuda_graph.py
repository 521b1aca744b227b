"""A CPU stand-in for the CUDA graph behind ``graph.Graphed``, so that the
runner's capture logic (keys, first calls, static buffers, launch counts,
versions and gradients) runs without a card.

``install(monkeypatch)`` gives every runner ``FakeGraph`` for its graph and
counts every device as a card (``graph.on_card``).  It returns a
``Tracked`` record: ``graphs`` lists the graphs made, and ``params`` (a
parameter tree the test sets, or None) names the gradients a replay hands
back.  ``FakeGraph`` keeps what a CUDA graph keeps true:

* ``eager(fn)`` runs fn;
* ``capture(fn)`` runs fn and then puts back every tensor it wrote in place
  and the generator's state, as a capture runs nothing (the versions stay
  as the capture's Python ops bumped them); it keeps fn and its outputs;
* ``replay()`` runs the kept fn on the static buffers, copies its outputs
  into the captured ones and the parameters' new gradients into the
  captured gradient buffers, and sets back each parameter's ``.grad``,
  the version of every tensor it wrote and the launch counters, as a
  replay runs no Python.

A write is an op whose schema marks an argument as written (``a!``), seen
through a ``TorchDispatchMode``.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nasa_niswan_tpu_torch import bridge, ops
from nasa_niswan_tpu_torch import graph as cuda_graph

_set_versions = torch._C._autograd._unsafe_set_version_counter


def _version(t):
    return None if t.is_inference() else t._version


def _reset_versions(pairs):
    pairs = [(t, v) for t, v in pairs if v is not None]
    if pairs:
        _set_versions(tuple(t for t, _ in pairs), tuple(v for _, v in pairs))


class _Writes(TorchDispatchMode):
    """Records, in order, each tensor an op writes in place, with its value
    and version before its first write."""

    def __init__(self):
        super().__init__()
        self.first = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(t, torch.Tensor) and id(t) not in self.first:
                    self.first[id(t)] = (t, t.clone(), _version(t))
        return func(*args, **kwargs)


class Tracked:
    def __init__(self):
        self.params, self.graphs = None, []

    def param_leaves(self):
        return [] if self.params is None else bridge.tree_leaves(self.params)


def install(monkeypatch) -> Tracked:
    tracked = Tracked()

    class FakeGraph:
        def __init__(self, device, generator=None):
            self.generator = generator
            tracked.graphs.append(self)

        def eager(self, fn):
            return fn()

        def capture(self, fn):
            rng = None if self.generator is None else self.generator.get_state()
            with _Writes() as writes:
                out = fn()
            written = list(writes.first.values())
            after = [(t, _version(t)) for t, _, _ in written]
            with torch.inference_mode():
                for t, before, _ in reversed(written):
                    t.copy_(before)
            _reset_versions(after)
            if rng is not None:
                self.generator.set_state(rng)
            self.fn, self.out = fn, bridge.tree_leaves(out)
            self.params = tracked.param_leaves()
            self.grads = [p.grad for p in self.params]
            return out

        def replay(self):
            counted, held = ops.launch_counts(), [p.grad for p in self.params]
            with _Writes() as writes:
                out = bridge.tree_leaves(self.fn())
            ops.add_launch_counts({k: n - counted.get(k, 0)
                                   for k, n in ops.launch_counts().items()}, -1)
            with torch.inference_mode():
                for o, n in zip(self.out, out):
                    o.copy_(n)
                for g, p, h in zip(self.grads, self.params, held):
                    if g is not None:
                        g.copy_(p.grad)
                    p.grad = h
            # views share their base's counter: the earliest reading wins
            _reset_versions((t, v) for t, _, v in reversed(writes.first.values()))

    monkeypatch.setattr(cuda_graph.Graphed, "graph_class", FakeGraph)
    monkeypatch.setattr(cuda_graph, "on_card", lambda device: True)
    return tracked
