"""DataSet and MiniBatch — the port of the in-memory half of
``bigdl_tpu.data.dataset`` (numpy only, copied so that the port imports
nothing of the JAX package).

The batch plan is the JAX package's, index for index: one shared
permutation per (seed, epoch), each process takes its stride slice, the
step count comes from global sizes, and short tails are cyclic-padded
with a ``weight`` row mask.  The port's Optimizer runs one process, but the
plan keeps the multi-process arguments so the two packages stay
comparable batch for batch."""

import math
from typing import Iterator

import numpy as np


class MiniBatch(dict):
    """Batch dict with 'input' / 'target' arrays."""

    @property
    def input(self):
        return self["input"]

    @property
    def target(self):
        return self.get("target")


class DataSet:
    """Base dataset: sized and epoch-iterable."""

    def size(self) -> int:
        raise NotImplementedError

    def batches(self, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, drop_last: bool = True,
                process_id: int = 0, process_count: int = 1
                ) -> Iterator[MiniBatch]:
        raise NotImplementedError

    @staticmethod
    def array(data, labels=None) -> "ArrayDataSet":
        return ArrayDataSet(data, labels)


def _per_host_batch(batch_size: int, process_count: int) -> int:
    """Every process feeds ``batch_size / process_count`` rows a step."""
    process_count = max(process_count, 1)
    if batch_size % process_count != 0:
        raise ValueError(
            f"global batch {batch_size} not divisible by "
            f"{process_count} hosts")
    return batch_size // process_count


def _epoch_permutation(n: int, shuffle: bool, seed: int,
                       epoch: int) -> np.ndarray:
    """The shared global permutation of one (seed, epoch)."""
    idx = np.arange(n)
    if shuffle:
        rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2 ** 31))
        rng.shuffle(idx)
    return idx


def batch_index_plan(n: int, batch_size: int, *, shuffle=True, seed=0,
                     epoch=0, drop_last=True, process_id=0, process_count=1):
    """Yield ``(sel, n_real)`` index batches: the shared permutation's
    stride slice of this process, cut into per-process batches; a short
    tail (``drop_last=False``) is cyclic-padded to the full batch and
    ``n_real`` says how many rows are genuine."""
    idx = _epoch_permutation(n, shuffle, seed, epoch)
    local = idx[process_id::process_count]
    per_host = _per_host_batch(batch_size, process_count)
    min_local = n // process_count
    max_local = min_local + (1 if n % process_count else 0)
    n_batches = (min_local // per_host if drop_last
                 else math.ceil(max_local / per_host))
    filler = local if len(local) else idx[:1]
    for b in range(n_batches):
        sel = local[b * per_host:(b + 1) * per_host]
        n_real = len(sel)
        if n_real < per_host:
            sel = np.concatenate([sel, np.resize(filler, per_host - n_real)])
        yield sel, n_real


class ArrayDataSet(DataSet):
    """In-memory dataset over a numpy array and its labels."""

    def __init__(self, data, labels=None):
        self.data = np.asarray(data)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != self.size():
            raise ValueError(f"data/labels length mismatch: {self.size()} "
                             f"vs {len(self.labels)}")

    def size(self) -> int:
        return len(self.data)

    def batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                drop_last=True, process_id=0, process_count=1):
        plan = batch_index_plan(
            self.size(), batch_size, shuffle=shuffle, seed=seed,
            epoch=epoch, drop_last=drop_last, process_id=process_id,
            process_count=process_count)
        for sel, n_real in plan:
            mb = MiniBatch(input=self.data[sel])
            if self.labels is not None:
                mb["target"] = self.labels[sel]
            if len(sel) != n_real:
                # padded rows carry weight 0
                w = np.zeros(len(sel), np.float32)
                w[:n_real] = 1.0
                mb["weight"] = w
            yield mb
