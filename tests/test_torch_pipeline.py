"""The port's host batch pipeline (nasa_niswan_tpu_torch/data/pipeline.py)
against the JAX package's: the batch order of ``batch_iterator`` and
``async_batches``, producer errors raised in the consumer, an early
``break`` that shuts the producer down, and
``ChunkDrain`` (one dispatch behind, closed after ``finish``).  These
mirror tests/test_pipeline.py on the CPU; the card's pinned buffers and
side stream are held by tests/test_torch_cuda.py.

Each test runs its body in a thread under a time limit, so a hung
producer fails its test instead of stalling the run."""

import functools
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import pipeline as jpipe  # noqa: E402
from nasa_niswan_tpu_torch.data import pipeline  # noqa: E402
from nasa_niswan_tpu_torch.data.pipeline import (  # noqa: E402
    ChunkDrain,
    async_batches,
    batch_iterator,
)

LIMIT_S = 60.0


def within(seconds=LIMIT_S):
    """Run the test in a daemon thread; fail when it takes longer than
    ``seconds`` (a producer that never finishes cannot stall the run)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # re-raised in the test's thread
                    out["error"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            assert not t.is_alive(), f"{fn.__name__} did not finish in {seconds} s"
            if "error" in out:
                raise out["error"]

        return wrapper

    return deco


class _ArrayDataset:
    def __init__(self, n=13, shape=(3, 4, 5)):
        rng = np.random.default_rng(7)
        self.x = rng.standard_normal((n, *shape)).astype(np.float32)
        self.y = rng.standard_normal((n, 4, 5)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class _Triplets(_ArrayDataset):
    def __getitem__(self, i):
        return self.x[i], self.y[i, 0], self.y[i]


def _producers_alive():
    return [t for t in threading.enumerate() if t.name == "batch-producer" and t.is_alive()]


@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 2), (2**32 - 1, 5)])
@pytest.mark.parametrize("drop_last", [True, False])
@within()
def test_batch_iterator_matches_jax(seed, epoch, drop_last):
    ds = _Triplets()
    want = list(jpipe.batch_iterator(ds, 4, shuffle=True, seed=seed, epoch=epoch,
                                     drop_last=drop_last))
    got = list(batch_iterator(ds, 4, shuffle=True, seed=seed, epoch=epoch,
                              drop_last=drop_last))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == 3
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("to_device", [False, True])
@within()
def test_async_batches_match_sync_iterator(drop_last, to_device):
    """The same batches in the same order: numpy with to_device=False,
    CPU tensors of the same values on the CPU device."""
    ds = _ArrayDataset()
    want = list(batch_iterator(ds, 4, shuffle=True, seed=3, epoch=2, drop_last=drop_last))
    got = list(async_batches(ds, 4, shuffle=True, seed=3, epoch=2, drop_last=drop_last,
                             device="cpu", to_device=to_device))
    assert len(got) == len(want) == (3 if drop_last else 4)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if to_device:
                assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
                a = a.numpy()
            else:
                assert isinstance(a, np.ndarray)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@within()
def test_async_batches_propagates_producer_error():
    class Broken(_ArrayDataset):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad sample")
            return super().__getitem__(i)

    with pytest.raises(ValueError, match="bad sample"):
        list(async_batches(Broken(), 4, shuffle=False, device="cpu"))
    with pytest.raises(ValueError, match="bad sample"):
        list(async_batches(Broken(), 4, shuffle=False, to_device=False))


@within()
def test_async_batches_early_break_shuts_down():
    ds = _ArrayDataset(n=64)
    before = len(_producers_alive())
    it = async_batches(ds, 4, shuffle=False, device="cpu", prefetch=2)
    next(it)
    it.close()  # must not hang on the bounded queue
    assert len(_producers_alive()) == before
    for batch in async_batches(ds, 4, shuffle=False, device="cpu", prefetch=1):
        break
    import gc

    gc.collect()
    assert len(_producers_alive()) == before


@within()
def test_async_batches_bounded_prefetch_under_thread_switching():
    """Many small batches, a queue of one and a very short switch interval:
    every batch arrives once, in order."""
    ds = _ArrayDataset(n=200, shape=(2,))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [b[0] for b in async_batches(ds, 3, shuffle=True, seed=1, prefetch=1,
                                           device="cpu")]
    finally:
        sys.setswitchinterval(old)
    want = [b[0] for b in batch_iterator(ds, 3, shuffle=True, seed=1)]
    assert len(got) == len(want) == 66
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@within()
def test_cpu_batches_count_no_device_copies():
    before = (pipeline.h2d_copies, pipeline.h2d_pinned, pipeline.h2d_side_stream)
    list(async_batches(_ArrayDataset(), 4, device="cpu"))
    assert (pipeline.h2d_copies, pipeline.h2d_pinned, pipeline.h2d_side_stream) == before


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@within()
def test_chunk_drain_one_behind_order_and_fetchers(kind):
    """ChunkDrain fetches exactly one push behind, keeps the order, and
    applies each chunk's own fetcher."""
    fetched = []

    def make_fetch(tag, n):
        def fetch(x):
            fetched.append(tag)
            return np.asarray(x)[:n]
        return fetch

    wrap = (lambda a: a) if kind == "numpy" else torch.as_tensor
    drain = ChunkDrain()
    first = wrap(np.arange(4))
    drain.push(first, make_fetch("a", 4))
    assert fetched == []  # nothing fetched until the next push
    if kind == "tensor":
        first += 100  # the drain holds its own copy
    drain.push(wrap(np.arange(10, 14)), make_fetch("b", 2))
    assert fetched == ["a"]
    out = drain.finish()
    assert fetched == ["a", "b"]
    np.testing.assert_array_equal(np.concatenate(out), [0, 1, 2, 3, 10, 11])
    assert drain.finish() == []  # ownership transferred; nothing retained
    with pytest.raises(RuntimeError, match="finished"):
        drain.push(wrap(np.arange(2)))


@within()
def test_chunk_drain_matches_jax():
    chunks = [np.random.default_rng(i).standard_normal((2, 3)) for i in range(4)]
    port, ref = ChunkDrain(), jpipe.ChunkDrain()
    for c in chunks:
        port.push(torch.as_tensor(c))
        ref.push(c)
    for a, b in zip(port.finish(), ref.finish()):
        np.testing.assert_array_equal(a, b)
