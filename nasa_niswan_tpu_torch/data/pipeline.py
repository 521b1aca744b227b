"""Host batching (counterpart of ``batch_iterator`` in
nasa_niswan_tpu/data/pipeline.py, a numpy-only copy, so both packages draw
the same batches in the same order).

The double-buffered device prefetch (``async_batches``, ``device_prefetch``)
is not ported yet: the seq2seq trainer moves each numpy batch to the device
as it comes.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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

    Samples may be any fixed-arity tuple — (X, y) pairs or the (X, prev0, y)
    triplets of Seq2SeqDataset; each position is stacked.  The order is a
    shuffle by ``default_rng(uint32(seed) + uint32(epoch))``; ``drop_last``
    keeps every batch the same shape.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(np.uint32(seed) + np.uint32(epoch)).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for start in range(0, stop, batch_size):
        idx = order[start : start + batch_size]
        cols = zip(*(dataset[int(i)] for i in idx))
        yield tuple(np.stack(col) for col in cols)
