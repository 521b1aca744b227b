"""Host batching and device prefetch (counterpart of
nasa_niswan_tpu/data/pipeline.py: ``batch_iterator``, ``device_prefetch``,
``async_batches`` and ``ChunkDrain``), written for CUDA.

* ``batch_iterator`` stacks numpy batches on the host, in the JAX package's
  order, so both packages draw the same batches.
* ``async_batches`` runs ``__getitem__`` and the stacking in a producer
  thread, up to ``prefetch`` batches ahead of the consumer.  On a CUDA
  device it stacks each batch straight into pinned host buffers and issues
  the host-to-device copies ``non_blocking`` on a side stream of its own,
  recording an event that the consumer's stream waits on before it uses
  the batch; so batch assembly and the copies overlap the step's kernels.
  On the CPU the same code runs without streams and yields tensors;
  ``to_device=False`` yields the numpy batches.
* ``device_prefetch`` does the staging alone, without a thread, for an
  iterator of numpy batches.
* ``ChunkDrain`` fetches device chunks one dispatch behind: each push
  starts its chunk's device-to-host copy into pinned memory, and completes
  the previous one.

``h2d_copies``, ``h2d_pinned`` and ``h2d_side_stream`` count the batch
tensors copied to a CUDA device, those copied from pinned host memory and
those whose copies were issued on a stream other than the one the consumer
uses them on (compared where the consumer takes the batch), so a run can
show where its copies went.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

h2d_copies = 0
h2d_pinned = 0
h2d_side_stream = 0
_count_lock = threading.Lock()


def _count(n: int, pinned: int, side: int) -> None:
    global h2d_copies, h2d_pinned, h2d_side_stream
    with _count_lock:
        h2d_copies += n
        h2d_pinned += pinned
        h2d_side_stream += side


def batch_indices(n: int, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                  drop_last: bool = True, epoch: int = 0) -> Iterator[np.ndarray]:
    """The sample indices of each batch of ``n`` samples: a shuffle by
    ``default_rng(uint32(seed) + uint32(epoch))``; ``drop_last`` keeps every
    batch the same shape."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(np.uint32(seed) + np.uint32(epoch)).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for start in range(0, stop, batch_size):
        yield order[start : start + batch_size]


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epoch: int = 0,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield stacked numpy batches from any dataset with __len__/__getitem__.

    Samples may be any fixed-arity tuple, (X, y) pairs or the (X, prev0, y)
    triplets of Seq2SeqDataset; each position is stacked.
    """
    for idx in batch_indices(len(dataset), batch_size, shuffle=shuffle, seed=seed,
                              drop_last=drop_last, epoch=epoch):
        cols = zip(*(dataset[int(i)] for i in idx))
        yield tuple(np.stack(col) for col in cols)


class _Stager:
    """Host buffers and host-to-device copies for one consumer.

    On a CUDA device it makes a side stream for the copies."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)

    def host(self, cols: Sequence[Sequence[np.ndarray]]) -> Tuple[torch.Tensor, ...]:
        """Stack each column of samples into one host tensor, pinned when
        the device is a CUDA device."""
        out = []
        for col in cols:
            first = np.asarray(col[0])
            buf = torch.empty((len(col), *first.shape),
                              dtype=torch.from_numpy(np.empty(0, first.dtype)).dtype,
                              pin_memory=self.cuda)
            np.stack(col, out=buf.numpy())
            out.append(buf)
        return tuple(out)

    def put(self, host: Tuple[torch.Tensor, ...]):
        """Start the copies of a host batch; returns (tensors, event, the
        stream the copies were issued on), the last two None on the CPU."""
        if not self.cuda:
            return host, None, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            copy_stream = torch.cuda.current_stream(self.device)
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(copy_stream)
        _count(len(host), sum(bool(h.is_pinned()) for h in host), 0)
        return dev, event, copy_stream

    def ready(self, item) -> Tuple[torch.Tensor, ...]:
        """The batch of ``put``, usable on the consumer's current stream.
        Its tensors count as copied on a side stream when the stream their
        copies were issued on is not the one that uses them."""
        dev, event, copy_stream = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in dev:
                t.record_stream(cur)  # allocated on the side stream
            _count(0, 0, len(dev) * (copy_stream != cur))
        return dev


def device_prefetch(iterator: Iterator, *, size: int = 2, device="cuda") -> Iterator:
    """Move numpy batches to ``device`` ``size`` batches ahead of their
    use: each is copied into pinned memory and sent on a side stream while
    the steps before it run."""
    stager = _Stager(device)
    pending = []
    for batch in iterator:
        pending.append(stager.put(stager.host([[np.asarray(a)] for a in batch])))
        if len(pending) >= size:
            yield tuple(t[0] for t in stager.ready(pending.pop(0)))
    while pending:
        yield tuple(t[0] for t in stager.ready(pending.pop(0)))


class _Stop:
    pass


_STOP = _Stop()


def async_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epoch: int = 0,
    prefetch: int = 2,
    device="cuda",
    to_device: bool = True,
) -> Iterator:
    """Background-thread batch pipeline in ``batch_iterator``'s order.

    A producer thread runs ``__getitem__``, stacks the batch (into pinned
    buffers for a CUDA device) and starts its copy to ``device`` on a side
    stream, up to ``prefetch`` batches ahead; numpy's stacking and the
    copies release the GIL, so one producer thread suffices.  The queue is
    bounded, so at most ``prefetch`` assembled batches are alive.  Producer
    exceptions are raised in the consumer; the generator's ``close()``
    (``break``, garbage collection) shuts the producer down.

    Yields tuples of tensors on ``device`` (usable on the consumer's stream
    without further waiting), or of numpy arrays with ``to_device=False``.
    """
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    stager = _Stager(device) if to_device else None

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for idx in batch_indices(len(dataset), batch_size, shuffle=shuffle,
                                      seed=seed, drop_last=drop_last, epoch=epoch):
                if stop.is_set():
                    return
                cols = list(zip(*(dataset[int(i)] for i in idx)))
                if stager is None:
                    item = tuple(np.stack(col) for col in cols)
                else:
                    item = stager.put(stager.host(cols))
                if not offer(item):
                    return
            offer(_STOP)
        except BaseException as e:  # raised in the consumer
            offer(e)

    t = threading.Thread(target=producer, daemon=True, name="batch-producer")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            yield item if stager is None else stager.ready(item)
    finally:
        stop.set()
        t.join(timeout=10.0)


class ChunkDrain:
    """Fetch device chunks one dispatch behind the serving loop.

    ``push`` a chunk each iteration: its device-to-host copy into pinned
    memory is enqueued at once (``non_blocking``, after the kernels that
    produce it), and the previous chunk's copy is waited for and handed to
    its ``fetch``, while the chunk dispatched just before runs.  ``finish``
    drains the last one.  ``fetch`` takes the host numpy array (default:
    the array itself).
    """

    def __init__(self):
        self._pending = None
        self._out = []
        self._closed = False

    @staticmethod
    def _start(chunk):
        """(host array or tensor, event or None) for a chunk."""
        if isinstance(chunk, torch.Tensor) and chunk.is_cuda:
            host = torch.empty(chunk.shape, dtype=chunk.dtype, pin_memory=True)
            host.copy_(chunk.detach(), non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(chunk.device))
            return host, event
        if isinstance(chunk, torch.Tensor):
            return chunk.detach().clone(), None
        return np.asarray(chunk), None

    def _complete(self) -> None:
        (host, event), fetch = self._pending
        if event is not None:
            event.synchronize()
        if isinstance(host, torch.Tensor):
            host = host.numpy()
        self._out.append(fetch(host))
        self._pending = None

    def push(self, device_chunk, fetch=np.asarray):
        if self._closed:
            raise RuntimeError("ChunkDrain already finished; make a new one")
        started = self._start(device_chunk)
        if self._pending is not None:
            self._complete()
        self._pending = (started, fetch)

    def finish(self) -> list:
        """Drain the pending chunk and hand the fetched list to the caller
        (the drain keeps no reference and refuses further pushes)."""
        if self._pending is not None:
            self._complete()
        self._closed = True
        out, self._out = self._out, []
        return out
