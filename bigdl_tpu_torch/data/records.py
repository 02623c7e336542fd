"""Fixed-size record files — the port of ``bigdl_tpu.data.records``.

A memory-mapped fixed-record file per host: the C++ reader
(``bigdl_tpu_torch/native/bigdl_tpu_io.cpp``, ``btio_records_*``) mmaps
it and gathers shuffled batches with worker threads (the OS page cache
is the block store), so an epoch never has to fit in the process's RAM
and batch assembly runs no Python per row.  The file format is the JAX
package's, byte for byte: a file written by either package reads in the
other.

Format: 24-byte header (magic ``BTRECv1\\0``, u64 record_bytes, u64
n_records) + contiguous records; a JSON sidecar (``<path>.json``) carries
the field manifest (names, dtypes, shapes) so records decode to numpy
views without any per-field parsing.
"""

import json
import os
import struct
from typing import Dict, Optional

import numpy as np

from bigdl_tpu_torch.data.dataset import (
    DataSet, MiniBatch, _per_host_batch, batch_index_plan,
    resharded_batch_index_plan, steps_in_epoch,
)
from bigdl_tpu_torch.utils import storage

_MAGIC = b"BTRECv1\x00"


def write_records(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write arrays (same leading dim) as one record file + manifest.

    ``fields``: name -> (n, ...) array; each record is the concatenation of
    the fields' per-sample bytes (C order)."""
    names = list(fields)
    arrays = [np.ascontiguousarray(fields[k]) for k in names]
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("fields differ in leading dim: "
                         + str({k: len(a) for k, a in zip(names, arrays)}))
    record_bytes = sum(a.nbytes // n for a in arrays)
    if record_bytes == 0:
        # the native reader rejects rb==0 headers (overflow guard); refuse
        # to produce a file the two read paths would treat differently
        raise ValueError("records must be at least one byte wide")
    manifest = {
        "record_bytes": record_bytes,
        "n_records": n,
        "fields": [{"name": k, "dtype": str(a.dtype),
                    "shape": list(a.shape[1:])}
                   for k, a in zip(names, arrays)],
    }
    # data first, sidecar last: on object stores (no atomic rename) the
    # sidecar's presence marks the record file complete
    with storage.open_file(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<QQ", record_bytes, n))
        # interleave per record so one record is one contiguous read
        packed = np.concatenate(
            [a.reshape(n, -1).view(np.uint8) for a in arrays], axis=1)
        f.write(np.ascontiguousarray(packed).tobytes())
    storage.write_json(path + ".json", manifest)


def _remote_pair_fingerprint(path: str):
    """Fingerprints of the (data, sidecar) remote pair; None entries mean
    the backend cannot stat (freshness then unverifiable — keep cache)."""
    return {"data": storage.fingerprint(path),
            "sidecar": storage.fingerprint(path + ".json")}


def _ensure_local(path: str) -> str:
    """Remote record URIs (``gs://…``) download into a local cache — the
    mmap/native read path needs random access a remote object can't give.
    Cache dir: ``$BIGDL_TPU_RECORD_CACHE`` (default under the system
    tempdir); keyed by URI hash so distinct sources never collide.

    Freshness: the remote pair's size/etag/mtime fingerprints are stored
    beside the cache (``<local>.src.json``); a later call re-checks them
    and re-fetches when the remote object changed (overwritten dataset) —
    no manual ``BIGDL_TPU_RECORD_CACHE_REFRESH=1`` needed, though it still
    forces a re-download.

    Atomicity: data AND sidecar download to a tmp pair first, then land
    via back-to-back ``os.replace`` (data first, fingerprint record last),
    so a crash can never pair a stale data file with a newer sidecar.
    Per-process tmp names keep racing processes from truncating each
    other; whichever replace lands last wins with a complete, matched
    pair."""
    if not storage.is_remote(path):
        return path
    import hashlib
    import shutil
    import tempfile

    cache_root = os.environ.get(
        "BIGDL_TPU_RECORD_CACHE",
        os.path.join(tempfile.gettempdir(), "bigdl_tpu_records"))
    os.makedirs(cache_root, exist_ok=True)
    key = hashlib.sha1(path.encode()).hexdigest()[:16]
    local = os.path.join(cache_root, key + "_" + storage.basename(path))
    meta = local + ".src.json"

    need = os.environ.get("BIGDL_TPU_RECORD_CACHE_REFRESH") == "1" \
        or not (os.path.exists(local) and os.path.exists(local + ".json"))
    fp = None
    if not need:
        fp = _remote_pair_fingerprint(path)
        try:
            with open(meta) as f:
                cached = json.load(f)
        except (OSError, ValueError):
            cached = None  # pre-fingerprint cache or torn write: re-verify
        # either half changing invalidates the pair: a re-uploaded sidecar
        # (metadata fix) without new data must refetch just the same
        if cached is None or any(
                fp[k] is not None and fp[k] != cached.get(k)
                for k in ("data", "sidecar")):
            need = True
            if cached is not None:
                import logging

                logging.getLogger("bigdl_tpu_torch.records").info(
                    "remote records changed under cache key %s; "
                    "re-fetching %s", key, path)
    if not need:
        return local

    # fingerprint BEFORE downloading: if the remote changes mid-download
    # the recorded (older) fingerprint won't match next check and the
    # pair re-fetches, instead of a newer fingerprint masking the skew
    if fp is None:
        fp = _remote_pair_fingerprint(path)
    tmps = {}
    try:
        for src, dst in ((path, local), (path + ".json", local + ".json")):
            tmp = tmps[dst] = f"{dst}.part.{os.getpid()}"
            with storage.open_file(src, "rb") as fi, open(tmp, "wb") as fo:
                shutil.copyfileobj(fi, fo, 1 << 20)
        # both halves complete: land them back-to-back, data first; the
        # fingerprint record lands LAST so a crash anywhere earlier just
        # re-fetches next time
        os.replace(tmps[local], local)
        os.replace(tmps[local + ".json"], local + ".json")
        tmp = f"{meta}.part.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(fp, f)
        os.replace(tmp, meta)
    finally:
        for tmp in list(tmps.values()) + [f"{meta}.part.{os.getpid()}"]:
            if os.path.exists(tmp):
                os.remove(tmp)
    return local


class RecordDataSet(DataSet):
    """Train straight from a record file: batches gather through the
    native mmap reader (threaded memcpy; numpy ``memmap`` fallback when the
    native lib is unavailable) and decode to per-field numpy arrays.

    ``feature``/``label``: which manifest fields feed ``input``/``target``
    (defaults: first field / second field if present).  ``feature`` may be
    a LIST of field names — the batch input is then a tuple, the
    framework's multi-input pack convention (e.g. Seq2Seq src + tgt_in)."""

    def __init__(self, path: str, feature=None, label: Optional[str] = None,
                 pipeline=None):
        path = _ensure_local(path)  # gs://… downloads once to local cache
        with open(path + ".json") as f:
            self.manifest = json.load(f)
        self.path = path
        self._fields = self.manifest["fields"]
        names = [f["name"] for f in self._fields]
        self.feature = feature if feature is not None else names[0]
        used = (list(self.feature)
                if isinstance(self.feature, (list, tuple))
                else [self.feature])
        self.label = label if label is not None else next(
            (n for n in names if n not in used), None)
        for want in filter(None, used + [self.label]):
            if want not in names:
                raise ValueError(f"field {want!r} not in manifest {names}")

        from bigdl_tpu_torch.native import lib as nat

        # The gather path drives indices/strides from the JSON sidecar; a
        # stale sidecar paired with a different record file would walk out
        # of bounds (native memcpy) or decode garbage (memmap), so
        # cross-check sidecar vs the file's own header before either path.
        n = int(self.manifest["n_records"])
        rb = int(self.manifest["record_bytes"])
        with open(path, "rb") as f:
            hdr = f.read(24)
        if len(hdr) < 24 or hdr[:8] != b"BTRECv1\0":
            raise ValueError(f"not a BTRECv1 record file: {path}")
        h_rb, h_n = struct.unpack("<QQ", hdr[8:24])
        if (h_n, h_rb) != (n, rb):
            raise ValueError(
                f"sidecar {path}.json does not match record header: "
                f"manifest n={n} rb={rb}, header n={h_n} rb={h_rb}")

        self._reader = None
        self._slot_cache: Dict = {}    # ring buffers reused across epochs
        self._staging_cache: Dict = {}
        if nat.available():
            self._reader = nat.RecordReader(path, pipeline=pipeline)
        else:  # pure-numpy fallback: memmap over the record region
            self._mm = np.memmap(path, np.uint8, "r", offset=24,
                                 shape=(n, rb))

        # per-field byte offsets within a record
        self._offsets = {}
        off = 0
        for fld in self._fields:
            nbytes = int(np.dtype(fld["dtype"]).itemsize
                         * int(np.prod(fld["shape"], initial=1)))
            self._offsets[fld["name"]] = (off, nbytes)
            off += nbytes
        if off != self.manifest["record_bytes"]:
            raise ValueError("manifest does not match record size")

    def size(self) -> int:
        return int(self.manifest["n_records"])

    def _gather(self, sel: np.ndarray) -> np.ndarray:
        if self._reader is not None:
            return self._reader.gather(sel)
        return np.asarray(self._mm[sel])

    def _gather_into(self, sel: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Gather into a preallocated staging buffer (the streaming read
        stage's no-allocation path)."""
        if self._reader is not None:
            return self._reader.gather(sel, out=out)
        return np.take(self._mm, sel, axis=0, out=out)

    def _decode(self, raw: np.ndarray, name: str) -> np.ndarray:
        fld = next(f for f in self._fields if f["name"] == name)
        off, nbytes = self._offsets[name]
        block = raw[:, off:off + nbytes]
        return np.ascontiguousarray(block).view(
            np.dtype(fld["dtype"])).reshape([len(raw)] + fld["shape"])

    def _emit(self, plan):
        """Assemble MiniBatches serially from an index plan of ``(sel,
        n_real)`` pairs — shared by the normal and resharded epoch
        paths."""
        for sel, n_real in plan:
            raw = self._gather(np.asarray(sel, np.int64))
            if isinstance(self.feature, (list, tuple)):
                x = tuple(self._decode(raw, f) for f in self.feature)
            else:
                x = self._decode(raw, self.feature)
            mb = MiniBatch(input=x)
            if self.label is not None:
                mb["target"] = self._decode(raw, self.label)
            if len(sel) != n_real:
                w = np.zeros(len(sel), np.float32)
                w[:n_real] = 1.0
                mb["weight"] = w
            yield mb

    def batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                drop_last=True, process_id=0, process_count=1):
        return self._emit(batch_index_plan(
            self.size(), batch_size, shuffle=shuffle, seed=seed,
            epoch=epoch, drop_last=drop_last, process_id=process_id,
            process_count=process_count))

    def resharded_batches(self, batch_size, *, trained_batches,
                          old_process_count, shuffle=True, seed=0, epoch=0,
                          drop_last=True, process_id=0, process_count=1):
        """Finish an epoch interrupted under a different process count:
        batches over the epoch's remaining examples, re-strided over the
        new process set (the elastic mid-epoch resume plan)."""
        return self._emit(resharded_batch_index_plan(
            self.size(), batch_size, trained_batches=trained_batches,
            old_process_count=old_process_count, shuffle=shuffle,
            seed=seed, epoch=epoch, drop_last=drop_last,
            process_id=process_id, process_count=process_count))

    def _probe_rates(self, per_host, out_fields):
        """Measure one batch's gather and field-decode cost (cached per
        geometry — only the first epoch pays): the stage-rate inputs for
        worker autosizing and queue-depth tuning."""
        key = ("probe", per_host)
        hit = self._staging_cache.get(key)
        if hit is None:
            import time as _time

            probe_sel = np.arange(min(per_host, self.size()),
                                  dtype=np.int64)
            t0 = _time.perf_counter()
            raw = self._gather(probe_sel)
            t_read = max(_time.perf_counter() - t0, 1e-9)
            t0 = _time.perf_counter()
            for name in out_fields:
                self._decode(raw, name)
            t_dec = max(_time.perf_counter() - t0, 1e-9)
            hit = self._staging_cache[key] = (t_read, t_dec)
        return hit

    def stream_batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                       drop_last=True, process_id=0, process_count=1,
                       workers=None, parts_per_batch=None,
                       raw_depth=None, ring_depth=None, metrics=None):
        """Stage-parallel variant of :meth:`batches`: the mmap gather
        runs on a read thread into per-slot staging buffers, a worker
        pool decodes fields into a preallocated buffer ring, and batches
        come out strictly in plan order — byte-identical to
        :meth:`batches` for any worker count AND any ``process_id``/
        ``process_count`` sharding (each host reads and decodes ONLY its
        stride slice of the shared epoch permutation).  Yields
        :class:`~bigdl_tpu_torch.data.pipeline.RingBatch` (slot views; the
        driver's device feed releases slots after the device copy).

        ``workers`` defaults to
        :func:`~bigdl_tpu_torch.data.pipeline.autotune_workers` over stage
        rates probed on one real batch; ``raw_depth``/``ring_depth``
        default to :func:`~bigdl_tpu_torch.data.pipeline.autotune_depths`
        over the same probe.  Ring/staging buffers are cached on the dataset
        and reused across epochs (no per-epoch reallocation), so at most
        one stream from a given dataset may be live at a time — the
        optimizer's one-epoch-at-a-time loop satisfies this."""
        per_host = _per_host_batch(batch_size, process_count)
        plan = ((np.asarray(sel, np.int64), n_real)
                for sel, n_real in batch_index_plan(
                    self.size(), batch_size, shuffle=shuffle, seed=seed,
                    epoch=epoch, drop_last=drop_last, process_id=process_id,
                    process_count=process_count))
        return self._stream(plan, per_host, workers, parts_per_batch,
                            raw_depth, ring_depth, metrics)

    def resharded_stream_batches(self, batch_size, *, trained_batches,
                                 old_process_count, shuffle=True, seed=0,
                                 epoch=0, drop_last=True, process_id=0,
                                 process_count=1, workers=None,
                                 parts_per_batch=None, raw_depth=None,
                                 ring_depth=None, metrics=None):
        """:meth:`resharded_batches` through the streaming pipeline — an
        elastic mid-epoch resume keeps the stage-parallel feed instead of
        dropping to the serial path for the remainder epoch.  Ownership
        math is :func:`~bigdl_tpu_torch.data.dataset.resharded_batch_index_plan`
        — plan-order-deterministic across restarts from (seed, epoch,
        old_process_count) alone."""
        per_host = _per_host_batch(batch_size, process_count)
        plan = ((np.asarray(sel, np.int64), n_real)
                for sel, n_real in resharded_batch_index_plan(
                    self.size(), batch_size,
                    trained_batches=trained_batches,
                    old_process_count=old_process_count, shuffle=shuffle,
                    seed=seed, epoch=epoch, drop_last=drop_last,
                    process_id=process_id, process_count=process_count))
        return self._stream(plan, per_host, workers, parts_per_batch,
                            raw_depth, ring_depth, metrics)

    def _stream(self, plan, per_host, workers, parts_per_batch,
                raw_depth, ring_depth, metrics):
        from bigdl_tpu_torch.data.pipeline import (
            StreamingPipeline, autotune_depths, autotune_workers,
            cached_slots, fill_pad_weights,
        )

        rb = int(self.manifest["record_bytes"])
        used = (list(self.feature)
                if isinstance(self.feature, (list, tuple))
                else [self.feature])
        out_fields = used + ([self.label] if self.label is not None else [])
        spec = {}
        for name in out_fields:
            fld = next(f for f in self._fields if f["name"] == name)
            spec["f:" + name] = (tuple([per_host] + fld["shape"]),
                                 np.dtype(fld["dtype"]))
        spec["weight"] = ((per_host,), np.float32)

        if workers is None or raw_depth is None or ring_depth is None:
            t_read, t_dec = self._probe_rates(per_host, out_fields)
            if workers is None:
                # enough decode workers to keep up with the (probed) read
                # stage — field decode is a memcpy, so this is usually
                # small; the vision adapters are where the pool widens
                workers = autotune_workers(decode_rate=1.0 / t_dec,
                                           target_rate=1.0 / t_read)
            if raw_depth is None or ring_depth is None:
                tuned = autotune_depths(1.0 / t_read, 1.0 / t_dec, workers,
                                        parts_per_batch=parts_per_batch)
                raw_depth = raw_depth or tuned["raw_depth"]
                ring_depth = ring_depth or tuned["ring_depth"]
        slots = cached_slots(self._slot_cache, spec, ring_depth)
        staging = self._staging_cache

        def fetch(item, slot):
            sel, _ = item
            buf = staging.get(slot)
            if buf is None or len(buf) != len(sel):
                buf = staging[slot] = np.empty((len(sel), rb), np.uint8)
            return self._gather_into(sel, buf)

        offsets = self._offsets

        def decode(item, raw, buffers, lo, hi, slot):
            sel, n_real = item
            for name in out_fields:
                off, nbytes = offsets[name]
                dst = buffers["f:" + name][lo:hi]
                np.copyto(dst.view(np.uint8).reshape(hi - lo, nbytes),
                          raw[lo:hi, off:off + nbytes])
            fill_pad_weights(buffers["weight"], n_real, lo, hi)
            return {"n": len(sel), "n_real": n_real}

        def finalize(buffers, meta):
            if isinstance(self.feature, (list, tuple)):
                x = tuple(buffers["f:" + f] for f in self.feature)
            else:
                x = buffers["f:" + self.feature]
            fields = {"input": x}
            if self.label is not None:
                fields["target"] = buffers["f:" + self.label]
            if meta["n_real"] < meta["n"]:
                fields["weight"] = buffers["weight"]
            return fields

        return StreamingPipeline(
            plan, fetch, decode, spec, rows=per_host, workers=workers,
            parts_per_batch=parts_per_batch, raw_depth=raw_depth,
            ring_depth=ring_depth, slots=slots, finalize=finalize,
            metrics=metrics)

    def steps_per_epoch(self, batch_size: int, process_count: int = 1,
                        drop_last: bool = True) -> int:
        return steps_in_epoch(self.size(), batch_size, process_count,
                              drop_last)

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None
