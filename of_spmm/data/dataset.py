"""Datasets + DataLoader — the reference's data pipeline, host-side.

Mirrors oneflow/user/data/ (C++ datasets: GPT token binary gpt_dataset.cpp,
shard-aware distributed_training_dataset.h, batch/shuffle decorators) and
python/oneflow/utils/data (torch-derived DataLoader). Accelerator training wants
the host to produce ready numpy batches that jit consumes; worker
processes are replaced by a prefetch thread (the GIL is released inside
numpy/np.load slicing, and batch assembly is memory-bound).

- ``Dataset``: map-style protocol (__len__/__getitem__).
- ``TensorDataset``, ``TokenDataset`` (memory-mapped token binary with
  window slicing — the GPT dataset), ``GraphNodeDataset`` (node-id batches
  for sampled GNN training).
- ``shard_dataset``: rank-sliced view (distributed_training_dataset.h's
  shard-aware iteration).
- ``DataLoader``: batching + seeded shuffle + drop_last + prefetch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Any:
        raise NotImplementedError


class TensorDataset(Dataset):
    """Tuple-of-arrays dataset (rows are examples)."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("need at least one array")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the leading dim")
        self.arrays = arrays

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)


class TokenDataset(Dataset):
    """GPT-style token-binary dataset: fixed-length windows over a flat
    token array (reference: oneflow/user/data/gpt_dataset.cpp reads
    seq_len+1 token windows for input/label shifting).

    ``source`` is a path to a .npy/.bin file (memory-mapped) or an array.
    Item i is tokens[i*stride : i*stride + seq_len + 1].
    """

    def __init__(self, source, seq_len: int, stride: Optional[int] = None,
                 dtype=np.int32):
        if isinstance(source, str):
            if source.endswith(".npy"):
                self.tokens = np.load(source, mmap_mode="r")
            else:
                self.tokens = np.memmap(source, dtype=dtype, mode="r")
        else:
            self.tokens = np.asarray(source)
        self.seq_len = seq_len
        self.stride = stride or seq_len
        n = self.tokens.shape[0]
        self._len = max(0, (n - seq_len - 1) // self.stride + 1)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx):
        if idx < 0 or idx >= self._len:
            raise IndexError(idx)
        s = idx * self.stride
        w = np.asarray(self.tokens[s : s + self.seq_len + 1], dtype=np.int64)
        return w[:-1], w[1:]  # (input, label)


@dataclasses.dataclass
class ShardedDataset(Dataset):
    """Rank-sliced strided view: element i of shard r is base[r + i*world].

    The reference's distributed dataset iterates shard-aware with each
    rank touching only its stride (user/data/distributed_training_dataset.h).
    """

    base: Dataset
    rank: int
    world: int

    def __post_init__(self):
        if not (0 <= self.rank < self.world):
            raise ValueError(f"rank {self.rank} outside world {self.world}")

    def __len__(self) -> int:
        n = len(self.base)
        return (n - self.rank + self.world - 1) // self.world

    def __getitem__(self, idx):
        return self.base[self.rank + idx * self.world]


def shard_dataset(ds: Dataset, rank: int, world: int) -> ShardedDataset:
    return ShardedDataset(ds, rank, world)


def _default_collate(items: Sequence[Any]):
    first = items[0]
    if isinstance(first, tuple):
        return tuple(np.stack([it[k] for it in items]) for k in range(len(first)))
    return np.stack(items)


class DataLoader:
    """Batching + seeded shuffle + optional background prefetch.

    Deterministic per (seed, epoch): call ``set_epoch`` like the reference
    sampler to reshuffle between epochs.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        collate_fn: Callable = _default_collate,
        prefetch: int = 2,
        num_workers: int = 0,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            return rng.permutation(n)
        return np.arange(n)

    def _make_batches(self) -> Iterator[Any]:
        order = self._index_order()
        n = order.shape[0]
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            idx = order[s : s + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])

    def _iter_multiprocess(self) -> Iterator[Any]:
        """Multi-worker batch assembly (reference: utils/data multiprocess
        DataLoader / oneflow.multiprocessing workers).

        Worker i builds batches i, i+W, i+2W, ...; the parent reassembles
        them in order, keeping at most ``prefetch`` finished batches per
        worker in flight. fork start method: the dataset is inherited, not
        pickled per item (matches the reference's worker model).
        """
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        n_batches = len(self)
        order = self._index_order()
        stop = n_batches * self.batch_size if self.drop_last else len(order)
        W = self.num_workers
        out_qs = [ctx.Queue(maxsize=max(self.prefetch, 1)) for _ in range(W)]

        def worker(wid: int):
            try:
                for b in range(wid, n_batches, W):
                    s = b * self.batch_size
                    idx = order[s : min(s + self.batch_size, stop)]
                    out_qs[wid].put(
                        (b, self.collate_fn([self.dataset[int(i)] for i in idx]))
                    )
                out_qs[wid].put((None, None))
            except BaseException as e:  # noqa: BLE001
                out_qs[wid].put((-1, repr(e)))

        procs = [ctx.Process(target=worker, args=(w,), daemon=True)
                 for w in range(W)]
        for p in procs:
            p.start()
        try:
            done = [False] * W
            nxt = 0
            while nxt < n_batches:
                wid = nxt % W
                if done[wid]:
                    break
                b, payload = out_qs[wid].get()
                if b == -1:
                    raise RuntimeError(f"DataLoader worker failed: {payload}")
                if b is None:
                    done[wid] = True
                    continue
                assert b == nxt, f"out-of-order batch {b} != {nxt}"
                nxt += 1
                yield payload
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()

    def __iter__(self) -> Iterator[Any]:
        if self.num_workers > 0:
            yield from self._iter_multiprocess()
            return
        if self.prefetch <= 0:
            yield from self._make_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()
        err: list = []

        def worker():
            try:
                for b in self._make_batches():
                    q.put(b)
            except BaseException as e:  # surface loader errors to consumer
                err.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is _END:
                break
            yield b
        t.join()
        if err:
            raise err[0]
