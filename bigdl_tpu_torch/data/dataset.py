"""DataSet, Sample and MiniBatch — the port of ``bigdl_tpu.data.dataset``
(numpy only, copied so that the port imports nothing of the JAX
package).

The batch plan is the JAX package's, index for index: one shared
permutation per (seed, epoch), each process takes its stride slice, the
step count comes from global sizes, and short tails are cyclic-padded
with a ``weight`` row mask.  Across processes the port's Optimizer
reads rank ``r``'s plan (``process_id=r``); ``resharded_batch_index_plan``
is the elastic mid-epoch resume plan it runs after a checkpoint of
another process count."""

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np


class Sample:
    """One training example: feature and label arrays."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = np.asarray(feature)
        self.label = None if label is None else np.asarray(label)

    def __repr__(self):
        ls = None if self.label is None else self.label.shape
        return f"Sample(feature={self.feature.shape}, label={ls})"


class MiniBatch(dict):
    """Batch dict with 'input' / 'target' arrays."""

    @property
    def input(self):
        return self["input"]

    @property
    def target(self):
        return self.get("target")

    def size(self) -> int:
        x = self["input"]
        return x[0].shape[0] if isinstance(x, (tuple, list)) else x.shape[0]


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

    @staticmethod
    def from_samples(samples: Sequence[Sample]) -> "ArrayDataSet":
        feats = np.stack([s.feature for s in samples])
        labels = (np.stack([s.label for s in samples])
                  if samples and samples[0].label is not None else None)
        return ArrayDataSet(feats, labels)


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
    n_batches = steps_in_epoch(n, batch_size, process_count, drop_last)
    filler = local if len(local) else idx[:1]
    for b in range(n_batches):
        sel = local[b * per_host:(b + 1) * per_host]
        n_real = len(sel)
        if n_real < per_host:
            sel = np.concatenate([sel, np.resize(filler, per_host - n_real)])
        yield sel, n_real


def resharded_batch_index_plan(n: int, batch_size: int, *,
                               trained_batches: int,
                               old_process_count: int, shuffle=True,
                               seed=0, epoch=0, drop_last=True,
                               process_id=0, process_count=1):
    """The elastic mid-epoch resume plan: after a ``process_count``
    change, finish the epoch on its remaining examples instead of
    replaying it.  Each old process trained the first ``trained_batches *
    per_host_old`` entries of its stride slice of the shared permutation;
    those positions are excluded, and the rest keeps permutation order
    and re-strides over the new process set with the same contract as
    :func:`batch_index_plan` (step count from global sizes, cyclic-padded
    tails).  Every remaining example is yielded exactly once across
    processes."""
    idx = _epoch_permutation(n, shuffle, seed, epoch)
    old_per_host = _per_host_batch(batch_size, old_process_count)
    take = max(0, int(trained_batches)) * old_per_host
    done = np.zeros(n, bool)  # over PERMUTATION POSITIONS
    for p in range(old_process_count):
        done[np.arange(p, n, old_process_count)[:take]] = True
    remaining = idx[~done]
    local = remaining[process_id::process_count]
    per_host = _per_host_batch(batch_size, process_count)
    n_batches = steps_in_epoch(len(remaining), batch_size, process_count,
                               drop_last)
    filler = local if len(local) else idx[:1]
    for b in range(n_batches):
        sel = local[b * per_host:(b + 1) * per_host]
        n_real = len(sel)
        if n_real < per_host:
            sel = np.concatenate([sel, np.resize(filler, per_host - n_real)])
        yield sel, n_real


def steps_in_epoch(n: int, batch_size: int, process_count: int = 1,
                   drop_last: bool = True) -> int:
    """Batches one process takes from an epoch of ``n`` rows."""
    per_host = _per_host_batch(batch_size, process_count)
    min_local = n // process_count
    max_local = min_local + (1 if n % process_count else 0)
    return (min_local // per_host if drop_last
            else math.ceil(max_local / per_host))


class ArrayDataSet(DataSet):
    """In-memory dataset over a numpy array and its labels.  As in the
    JAX package, a pair ``(data, labels)`` given without labels is read
    as the two; otherwise a tuple of arrays (one a model input, equal
    lengths) is a multi-input dataset, whose batches' ``input`` is the
    tuple of their rows, and a list keeps its meaning of a list of
    samples, one stacked array."""

    def __init__(self, data, labels=None):
        if isinstance(data, (tuple, list)) and labels is None \
                and len(data) == 2:
            data, labels = data
        self.multi = isinstance(data, tuple)
        if self.multi:
            self.data = tuple(np.asarray(a) for a in data)
            if len({len(a) for a in self.data}) > 1:
                raise ValueError("multi-input arrays differ in length: "
                                 f"{[len(a) for a in self.data]}")
        else:
            self.data = np.asarray(data)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != self.size():
            raise ValueError(f"data/labels length mismatch: {self.size()} "
                             f"vs {len(self.labels)}")

    def size(self) -> int:
        return len(self.data[0]) if self.multi else len(self.data)

    def batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                drop_last=True, process_id=0, process_count=1):
        return self._emit(batch_index_plan(
            self.size(), batch_size, shuffle=shuffle, seed=seed,
            epoch=epoch, drop_last=drop_last, process_id=process_id,
            process_count=process_count))

    def resharded_batches(self, batch_size, *, trained_batches,
                          old_process_count, shuffle=True, seed=0, epoch=0,
                          drop_last=True, process_id=0, process_count=1):
        """Finish an epoch interrupted under another process count
        (:func:`resharded_batch_index_plan`)."""
        return self._emit(resharded_batch_index_plan(
            self.size(), batch_size, trained_batches=trained_batches,
            old_process_count=old_process_count, shuffle=shuffle,
            seed=seed, epoch=epoch, drop_last=drop_last,
            process_id=process_id, process_count=process_count))

    def steps_per_epoch(self, batch_size: int, process_count: int = 1,
                        drop_last: bool = True) -> int:
        return steps_in_epoch(self.size(), batch_size, process_count,
                              drop_last)

    def _emit(self, plan):
        for sel, n_real in plan:
            mb = MiniBatch(input=tuple(a[sel] for a in self.data)
                           if self.multi else self.data[sel])
            if self.labels is not None:
                mb["target"] = self.labels[sel]
            if len(sel) != n_real:
                # padded rows carry weight 0
                w = np.zeros(len(sel), np.float32)
                w[:n_real] = 1.0
                mb["weight"] = w
            yield mb


class SampleToMiniBatch:
    """Batches an iterator of Samples; the last batch may be short."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    def __call__(self, samples: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in samples:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._make(buf)
                buf = []
        if buf:
            yield self._make(buf)

    @staticmethod
    def _make(buf: List[Sample]) -> MiniBatch:
        mb = MiniBatch(input=np.stack([s.feature for s in buf]))
        if buf[0].label is not None:
            mb["target"] = np.stack([s.label for s in buf])
        return mb


class ProcessLocalDataSet(DataSet):
    """A dataset whose rows are already this process's disjoint share
    (``XShards.owned_concat``), so the driver's ``process_id`` /
    ``process_count`` must not slice it again.  Every process takes the
    same number of steps an epoch: the batch count comes from the least
    local size over the processes, gathered once through
    ``torch.distributed`` when it is initialised."""

    def __init__(self, local: DataSet):
        self.local = local
        self._global_min: Optional[int] = None

    def size(self) -> int:
        return self.local.size()

    def _agreed_size(self) -> int:
        if self._global_min is None:
            import torch.distributed as dist

            n = self.local.size()
            if dist.is_available() and dist.is_initialized() \
                    and dist.get_world_size() > 1:
                sizes = [None] * dist.get_world_size()
                dist.all_gather_object(sizes, n)
                n = min(sizes)
            self._global_min = n
        return self._global_min

    def batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                drop_last=True, process_id=0, process_count=1):
        per_host = _per_host_batch(batch_size, process_count)
        agreed = self._agreed_size()
        n_batches = (agreed // per_host if drop_last
                     else math.ceil(agreed / per_host))
        it = self.local.batches(per_host, shuffle=shuffle, seed=seed,
                                epoch=epoch, drop_last=False,
                                process_id=0, process_count=1)
        for b, mb in enumerate(it):
            if b >= n_batches:
                break
            yield mb
