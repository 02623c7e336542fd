"""XShards — partitioned data collections, the port of
``bigdl_tpu.data.shards``.

A shard list owned by the local process.  In a multi-process job each
process builds the SAME global shard index and reads only its own slice
(``owned()``).  The process rank and count come from ``torch.distributed``
when it is initialised (else 0 and 1), and the default shard count is the
larger of the process count and the local CUDA device count (at least 1).
"""

import glob as _glob
import os
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from bigdl_tpu_torch.utils import storage


def _process_index_count():
    """(rank, world size) from ``torch.distributed``; (0, 1) without an
    initialised process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_device_count() -> int:
    import torch

    return max(1, torch.cuda.device_count())


def _split_obj(obj, n: int) -> List[Any]:
    """Split a numpy array / dict of arrays / tuple / pandas DataFrame into n
    roughly equal shards along axis 0."""
    if isinstance(obj, dict):
        parts = {k: _split_obj(v, n) for k, v in obj.items()}
        return [{k: parts[k][i] for k in obj} for i in range(n)]
    if isinstance(obj, (tuple, list)):
        parts = [_split_obj(v, n) for v in obj]
        return [type(obj)(p[i] for p in parts) for i in range(n)]
    if hasattr(obj, "iloc"):  # pandas
        idx = np.array_split(np.arange(len(obj)), n)
        return [obj.iloc[i] for i in idx]
    arr = np.asarray(obj)
    return np.array_split(arr, n)


def _concat_objs(objs: Sequence[Any]):
    first = objs[0]
    if isinstance(first, dict):
        return {k: _concat_objs([o[k] for o in objs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            _concat_objs([o[i] for o in objs]) for i in range(len(first)))
    if hasattr(first, "iloc"):
        import pandas as pd

        return pd.concat(list(objs), axis=0)
    return np.concatenate([np.asarray(o) for o in objs], axis=0)


class XShards:
    """A globally-indexed list of data shards; each process owns a slice.

    ``process_local=True`` marks a collection that ALREADY holds only this
    process's disjoint share (the sharded-read loaders) — ``owned()`` then
    returns everything local instead of slicing again."""

    def __init__(self, shards: List[Any], process_local: bool = False):
        self._shards = list(shards)
        self._process_local = process_local

    # -- construction -------------------------------------------------------
    @staticmethod
    def partition(data: Any, num_shards: Optional[int] = None) -> "XShards":
        """Split in-memory data (numpy / dict / tuple / DataFrame) into
        shards — reference ``XShards.partition``."""
        if num_shards is None:
            num_shards = max(_process_index_count()[1],
                             _local_device_count())
        return XShards(_split_obj(data, num_shards))

    # -- RDD-like ops -------------------------------------------------------
    def transform_shard(self, fn: Callable, *args) -> "XShards":
        # process_local MUST propagate: a sharded read followed by the normal
        # preprocess chain (transform_shard(...).owned()) would otherwise
        # re-slice [p::n] over already-disjoint LOCAL shards and silently
        # drop (n-1)/n of each process's data in multihost jobs.
        return XShards([fn(s, *args) for s in self._shards],
                       process_local=self._process_local)

    def num_partitions(self) -> int:
        return len(self._shards)

    def repartition(self, n: int) -> "XShards":
        """Concat + re-split into n shards.  On a process-local collection
        this reshapes ONLY the local share (there is no cross-process
        shuffle by design — same stance as the sharded-read loaders), so the
        result stays process-local."""
        return XShards(_split_obj(_concat_objs(self._shards), n),
                       process_local=self._process_local)

    def collect(self) -> List[Any]:
        return list(self._shards)

    def concat(self):
        """Materialize the full (process-local) dataset."""
        return _concat_objs(self._shards)

    def owned(self) -> List[Any]:
        """Shards owned by this process (multi-controller input sharding)."""
        if self._process_local:
            return list(self._shards)
        p, n = _process_index_count()
        return self._shards[p::n]

    def owned_concat(self):
        return _concat_objs(self.owned())

    def __len__(self):
        return len(self._shards)

    def __iter__(self):
        return iter(self._shards)


# ---------------------------------------------------------------------------
# loaders — reference orca.data.pandas.read_csv / read_parquet
# ---------------------------------------------------------------------------

def _owned_files(files: List[str], process_id: Optional[int],
                 process_count: Optional[int]) -> List[str]:
    """Round-robin file ownership for multi-process sharded reads: every
    process derives the same global file index and reads a DISJOINT
    slice of it."""
    rank, world = _process_index_count()
    pid = rank if process_id is None else process_id
    pcount = world if process_count is None else process_count
    owned = files[pid::pcount]
    if not owned:
        raise ValueError(
            f"sharded read: process {pid} of {pcount} owns no files "
            f"({len(files)} files total) — write at least one file per "
            "process, or read unsharded and repartition")
    return owned


def _expand(path: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(path, (list, tuple)):
        out: List[str] = []
        for p in path:
            out.extend(_expand(p))
        return out
    if storage.is_remote(path):
        # gs://bucket/dir, gs://bucket/part-*.csv, … read straight from
        # object storage; pandas/numpy open the returned URIs through
        # fsspec
        if storage.isdir(path):
            return [storage.join(path, n)
                    for n in storage.list_files(path)]
        matches = storage.glob(path)
        return matches or [path]
    if os.path.isdir(path):
        return sorted(
            p for p in _glob.glob(os.path.join(path, "*"))
            if os.path.isfile(p))
    matches = sorted(_glob.glob(path))
    return matches or [path]


def _read_files(path, loader, num_shards, sharded, process_id,
                process_count) -> XShards:
    files = _expand(path)
    if sharded or process_id is not None or process_count is not None:
        files = _owned_files(files, process_id, process_count)
        xs = XShards([loader(f) for f in files], process_local=True)
        # repartition stays process-local: it only reshapes the local share
        if num_shards:
            xs = XShards(_split_obj(_concat_objs(xs._shards), num_shards),
                         process_local=True)
        return xs
    xs = XShards([loader(f) for f in files])
    return xs.repartition(num_shards) if num_shards else xs


def read_csv(path, num_shards: Optional[int] = None, sharded: bool = False,
             process_id: Optional[int] = None,
             process_count: Optional[int] = None, **kwargs) -> XShards:
    """One shard per file (repartitioned if num_shards given).

    ``sharded=True`` (or explicit process_id/process_count): each process
    reads ONLY its round-robin slice of the file list — the multihost
    input path (no full-dataset read per host)."""
    import pandas as pd

    return _read_files(path, lambda f: pd.read_csv(f, **kwargs), num_shards,
                       sharded, process_id, process_count)


def read_parquet(path, num_shards: Optional[int] = None,
                 sharded: bool = False, process_id: Optional[int] = None,
                 process_count: Optional[int] = None, **kwargs) -> XShards:
    import pandas as pd

    return _read_files(path, lambda f: pd.read_parquet(f, **kwargs),
                       num_shards, sharded, process_id, process_count)


def read_npy(path, num_shards: Optional[int] = None, sharded: bool = False,
             process_id: Optional[int] = None,
             process_count: Optional[int] = None) -> XShards:
    return _read_files(path, np.load, num_shards, sharded, process_id,
                       process_count)
