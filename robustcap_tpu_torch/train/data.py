r"""Training data pipeline: sequence chunking, shuffling, padded batching
(the port's own copy of ``robustcap_tpu/train/data.py``, numpy only).

Sequences are chunked to ``split_size`` frames, optionally augmented per
draw, and collated into padded [T, B, D] arrays with a ``lengths`` vector,
which ``nn.rnn.rnn_forward_padded`` packs. One ``np.random.RandomState``
gives the same batches in the same order as the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["SeqDataset", "padded_batches"]


class SeqDataset:
    r"""Chunked sequence dataset (rnn.py:26-77).

    data[i] [T_i, D], label[i] [T_i, L]. ``split_size > 0`` splits sequences
    into chunks of at most that many frames. ``augment_fn(rng, x) -> x``
    runs at batch-assembly time. ``with_init`` marks RNNWithInit-style
    datasets whose first label seeds the hidden state (rnn.py:80-89).
    """

    def __init__(self, data: Sequence[np.ndarray], label: Sequence[np.ndarray],
                 split_size: int = -1,
                 augment_fn: Optional[Callable] = None,
                 with_init: bool = False):
        assert len(data) == len(label) and len(data) > 0
        if split_size > 0:
            self.data, self.label = [], []
            for d, l in zip(data, label):
                for s in range(0, len(d), split_size):
                    self.data.append(np.asarray(d[s:s + split_size], np.float32))
                    self.label.append(np.asarray(l[s:s + split_size], np.float32))
        else:
            self.data = [np.asarray(d, np.float32) for d in data]
            self.label = [np.asarray(l, np.float32) for l in label]
        self.augment_fn = augment_fn
        self.with_init = with_init

    def __len__(self):
        return len(self.data)


def padded_batches(dataset: SeqDataset, batch_size: int, rng=None,
                   shuffle: bool = True, drop_last: bool = False,
                   pad_to: int = 0):
    r"""Yield (xs [T, B, D], labels [T, B, L], lengths [B], init [B, L]|None).

    Pads to the batch max length (or ``pad_to`` when given — e.g. the global
    max, so every batch shares one compiled shape); ``init`` is each chunk's
    first label for RNNWithInit datasets.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)
    for s in range(0, n, batch_size):
        idx = order[s:s + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        datas = []
        for i in idx:
            d = dataset.data[i]
            if dataset.augment_fn is not None:
                d = dataset.augment_fn(rng or np.random, d)
            datas.append(d)
        labels = [dataset.label[i] for i in idx]
        lengths = np.asarray([len(d) for d in datas], np.int32)
        T = max(int(lengths.max()), pad_to)
        B = len(idx)
        xs = np.zeros((T, B, datas[0].shape[-1]), np.float32)
        ys = np.zeros((T, B, labels[0].shape[-1]), np.float32)
        for b, (d, l) in enumerate(zip(datas, labels)):
            xs[:len(d), b] = d
            ys[:len(l), b] = l
        init = (np.stack([l[0] for l in labels]).astype(np.float32)
                if dataset.with_init else None)
        yield xs, ys, lengths, init
