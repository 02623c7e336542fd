"""Checkpoints — the port of ``bigdl_tpu.optim.checkpoint``.

A checkpoint is the directory ``<path>/ckpt-<step>`` with

- ``params.npz``: ``flat``, the parameters raveled in the order of
  ``jax.flatten_util.ravel_pytree`` over the JAX params tree
  (``utils.convert.flat_order``);
- ``ema.npz``: ``flat``, the EMA of the parameters, when the run keeps
  one;
- ``opt_state.npz``: the optimizer's slots under the JAX key names: an
  elementwise method's slot is one vector in the ``flat`` order (the key
  is the slot, e.g. ``m``), a per-tensor slot of ``LarsSGD`` / ``LBFGS``
  is keyed ``<slot>/<JAX path>``, and a tensor slot (``rho``, ``count``)
  by its name;
- or, written by a ZeRO-1 run across processes (``opt_shards``), one
  ``opt_state.shard<k>-of-<n>[.<attempt>].npz`` a process instead: its
  slice of each slot under the slot's key, the slice's offset in the
  flat vector under ``<key>@offset`` (:func:`local_opt_shards`), and the
  tensor slots whole;
- ``model_state.npz``: the BatchNorm running buffers under their JAX
  paths (``1_BatchNorm/running_mean``);
- ``manifest.json``: the step and the training loop's state (with
  ``opt_shards`` and ``opt_shards_attempt`` for a sharded write),
  written last.

So either package resumes from the other's checkpoint, sharded or not,
at any process count: the shards are merged back into whole vectors
(:func:`merge_flat_shards`), and a JAX vector padded to its mesh
(``n_pad``) is read up to the reader's length.  ``path`` is local or a
``utils.storage`` URI.  A local single-writer save goes into
``ckpt-<step>.tmp`` and is renamed when complete; a sharded or remote
one writes under the final name, removes a stale manifest first and
writes the manifest last, so a directory without one is no checkpoint;
a reader also requires every shard of the manifest's attempt.  This
module works on host numpy arrays: the caller snapshots its tensors at
the trigger.  ``checkpoint_write_fail`` (``resilience.faults``) fires
after the blobs and before the manifest, the worst place to crash.
``mirror`` copies every completed save to a second root
(``storage.mirror_tree``), kept to ``keep_last`` like the primary; a
mirror that fails after its retries is logged, the primary stands."""

import logging
import os
import shutil
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.retry import RetryPolicy
from bigdl_tpu_torch.utils import storage

log = logging.getLogger("bigdl_tpu_torch.checkpoint")

Arrays = Dict[str, np.ndarray]

# a manifest read during a scan rides out a storage blip: two quick
# retries, then the checkpoint is skipped for this scan, visibly
_MANIFEST_RETRY = RetryPolicy(max_retries=2, base_s=0.05, max_s=0.2,
                              jitter=0.0)


def jsonable_state(driver_state: Optional[Dict[str, Any]]
                   ) -> Dict[str, Any]:
    """The JSON-safe part of a training-state dict: scalars, and dicts and
    lists of them."""
    def ok(v):
        if isinstance(v, (int, float, str, bool)) or v is None:
            return True
        if isinstance(v, dict):
            return all(ok(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(ok(x) for x in v)
        return False

    return {k: v for k, v in (driver_state or {}).items() if ok(v)}


def local_opt_shards(shards: Arrays, offset: int,
                     whole: Optional[Arrays] = None) -> Arrays:
    """One process's part of a ZeRO-1 optimizer state as a shard file
    holds it: each 1-D slice under its key with ``<key>@offset``, the
    replicated leaves (``whole``) as they are."""
    out = {k: np.asarray(v) for k, v in (whole or {}).items()}
    for key, arr in shards.items():
        out[key] = np.asarray(arr)
        out[key + "@offset"] = np.asarray(offset, np.int64)
    return out


def _shard_name(i: int, n: int, attempt: Optional[str]) -> str:
    tok = f".{attempt}" if attempt else ""
    return f"opt_state.shard{i:05d}-of-{n:05d}{tok}.npz"


def save_checkpoint(path: str, step: int, **kwargs) -> str:
    """Write ``<path>/ckpt-<step>`` and return it (a ``checkpoint/save``
    span); the arguments are :func:`_save_checkpoint`'s."""
    with trace.span("checkpoint/save", step=step,
                    sharded=kwargs.get("opt_shards") is not None):
        return _save_checkpoint(path, step, **kwargs)


def _save_checkpoint(path: str, step: int, *, flat_params=None,
                    opt_state: Optional[Arrays] = None,
                    model_state: Optional[Arrays] = None,
                    driver_state: Optional[Dict[str, Any]] = None,
                    keep_last: int = 3, ema_flat=None,
                    opt_shards: Optional[Arrays] = None,
                    shard_index: int = 0, shard_count: int = 1,
                    barrier: Optional[Callable[[], None]] = None,
                    attempt: Optional[str] = None,
                    mirror: Optional[str] = None) -> str:
    """Write ``<path>/ckpt-<step>`` and return it; then keep only the
    newest ``keep_last`` complete checkpoints (0: all).

    Single writer (``opt_shards=None``): the caller writes everything.
    Sharded (``opt_shards`` from :func:`local_opt_shards`): every process
    calls this with its ``shard_index`` of ``shard_count`` and writes its
    shard file; the process of index 0 then writes the parameters, EMA,
    buffers and, last, the manifest.  ``barrier`` (a synchronous save)
    runs after the stale manifest is gone and after the shards are
    written, so the manifest certifies every shard; ``attempt``, one
    token every writer of a save shares, names the shard files, so a
    manifest never certifies a shard of an earlier crashed attempt."""
    sharded = opt_shards is not None
    d = storage.join(path, f"ckpt-{step}")
    direct = sharded or storage.is_remote(path)
    tmp = d if direct else d + ".tmp"
    if direct and shard_index == 0 and storage.exists(
            storage.join(d, "manifest.json")):
        # re-reaching a step: the old manifest goes first, or a crash
        # mid-rewrite leaves new blobs certified by the stale manifest
        storage.remove_tree(storage.join(d, "manifest.json"),
                            ignore_errors=False)
    if sharded and barrier is not None:
        barrier()
    if not direct and os.path.exists(tmp):
        shutil.rmtree(tmp)
    storage.makedirs(tmp)

    def savez(name, **arrs):
        with storage.open_file(storage.join(tmp, name), "wb") as f:
            np.savez(f, **arrs)

    if sharded:
        savez(_shard_name(shard_index, shard_count, attempt), **opt_shards)
        if barrier is not None:
            barrier()
        if shard_index != 0:
            return d
    savez("params.npz", flat=np.asarray(flat_params))
    if ema_flat is not None:
        savez("ema.npz", flat=np.asarray(ema_flat))
    if not sharded:
        savez("opt_state.npz", **(opt_state or {}))
    savez("model_state.npz", **(model_state or {}))
    manifest = {"step": step, "driver_state": jsonable_state(driver_state)}
    if sharded:
        manifest["opt_shards"] = shard_count
        if attempt is not None:
            manifest["opt_shards_attempt"] = attempt
    faults.fire("checkpoint_write_fail", step=step)
    storage.write_json(storage.join(tmp, "manifest.json"), manifest)
    if tmp != d:
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
    _gc(path, keep_last)
    if mirror:
        target = storage.join(mirror, f"ckpt-{step}")
        try:
            n = storage.mirror_tree(d, target)
            log.info("checkpoint mirrored to %s (%d bytes)", target, n)
            _gc(mirror, keep_last)
        except Exception as e:           # the primary stands
            log.warning("checkpoint mirror to %r FAILED after retries "
                        "(%s: %s); the primary checkpoint at %s is intact",
                        mirror, type(e).__name__, e, d)
    return d


def _scan_checkpoints(path: str) -> List[Tuple[int, str, bool,
                                               Optional[bool]]]:
    """(step, name, has_manifest, complete) of every ``ckpt-<step>``:
    complete when the manifest exists and, for a sharded write, every
    shard of its attempt is there; None when the manifest could not be
    read this scan (neither offered to a reader nor collected)."""
    if not storage.isdir(path):
        return []
    out = []
    for name in storage.listdir(path):
        if not name.startswith("ckpt-") or name.endswith(".tmp"):
            continue
        try:
            step = int(name.split("-")[1])
        except ValueError:
            continue
        mpath = storage.join(path, name, "manifest.json")
        if not storage.exists(mpath):
            out.append((step, name, False, False))
            continue
        try:
            manifest = _MANIFEST_RETRY.call(
                storage.read_json, mpath, describe=f"manifest read {mpath}")
        except (OSError, ValueError) as e:
            log.warning("could not read %s (%s); skipping this checkpoint "
                        "for now", mpath, e)
            out.append((step, name, True, None))
            continue
        n = int(manifest.get("opt_shards") or 0)
        tok = manifest.get("opt_shards_attempt")
        complete = not n or all(storage.exists(storage.join(
            path, name, _shard_name(i, n, tok))) for i in range(n))
        out.append((step, name, True, complete))
    return out


def latest_checkpoint(path: str) -> Optional[str]:
    """The newest complete checkpoint under ``path``, or None."""
    steps = [(s, n) for s, n, _m, complete in _scan_checkpoints(path)
             if complete is True]
    return storage.join(path, max(steps)[1]) if steps else None


def merge_flat_shards(shard_dicts: Iterable[Arrays]) -> Arrays:
    """Whole arrays from :func:`local_opt_shards` dicts of any process
    count: each offset-keyed slice lands at its offset (the vector as
    long as the shards reach), a replicated leaf passes through."""
    parts: Dict[str, List[Tuple[int, np.ndarray]]] = {}
    full: Arrays = {}
    for shard in shard_dicts:
        for key, arr in shard.items():
            if key.endswith("@offset"):
                continue
            if key + "@offset" in shard:
                parts.setdefault(key, []).append(
                    (int(shard[key + "@offset"]), np.asarray(arr)))
            else:
                full.setdefault(key, np.asarray(arr))
    for key, pieces in parts.items():
        out = np.zeros(max(o + len(a) for o, a in pieces),
                       pieces[0][1].dtype)
        for off, arr in pieces:
            out[off:off + len(arr)] = arr
        full[key] = out
    return full


def load_checkpoint(ckpt_dir: str):
    """(flat params, opt-state arrays, model-state arrays, loop state,
    EMA flat or None) of one checkpoint directory, sharded or not (a
    ``checkpoint/restore`` span)."""
    with trace.span("checkpoint/restore", ckpt_dir=ckpt_dir):
        return _load_checkpoint(ckpt_dir)


def _load_checkpoint(ckpt_dir: str) -> Tuple[np.ndarray, Arrays, Arrays,
                                            Dict[str, Any],
                                            Optional[np.ndarray]]:
    """(flat params, opt-state arrays, model-state arrays, loop state,
    EMA flat or None) of one checkpoint directory, sharded or not."""
    manifest = storage.read_json(storage.join(ckpt_dir, "manifest.json"))
    flat = storage.load_npz(storage.join(ckpt_dir, "params.npz"))["flat"]
    ema_path = storage.join(ckpt_dir, "ema.npz")
    ema = (storage.load_npz(ema_path)["flat"]
           if storage.exists(ema_path) else None)
    n = manifest.get("opt_shards")
    if n:
        tok = manifest.get("opt_shards_attempt")
        opt = merge_flat_shards(
            storage.load_npz(storage.join(ckpt_dir, _shard_name(i, int(n),
                                                                tok)))
            for i in range(int(n)))
    else:
        opt = storage.load_npz(storage.join(ckpt_dir, "opt_state.npz"))
    return (flat, opt,
            storage.load_npz(storage.join(ckpt_dir, "model_state.npz")),
            manifest["driver_state"], ema)


# shard-incomplete directories a scan of this process has seen once:
# only one seen incomplete by two scans is collected (an object store's
# listing may lag a write)
_gc_incomplete_seen: Dict[str, int] = {}


def _gc(path: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` complete checkpoints (the newest one
    always); remove older complete ones, shard-incomplete ones older
    than the newest complete one (after a second scan), and directories
    without a manifest older than it (a crash mid-write).  A checkpoint
    whose manifest could not be read is left alone."""
    scan = _scan_checkpoints(path)
    valid = [(s, n) for s, n, _m, complete in scan if complete is True]
    if not valid:
        return
    newest = max(valid)[0]
    if keep_last > 0:
        keep = {name for _, name in sorted(valid)[-keep_last:]}
        keep.add(max(valid)[1])
        for step, name, has_manifest, complete in scan:
            full = storage.join(path, name)
            if complete is True:
                _gc_incomplete_seen.pop(full, None)
            if (name in keep or not has_manifest or complete is None
                    or step >= newest):
                continue
            if complete is False and full not in _gc_incomplete_seen:
                _gc_incomplete_seen[full] = step
                continue
            _gc_incomplete_seen.pop(full, None)
            storage.remove_tree(full, ignore_errors=True)
    for step, name, has_manifest, _complete in scan:
        if not has_manifest and step < newest:
            storage.remove_tree(storage.join(path, name), ignore_errors=True)


class AsyncCheckpointer:
    """Writes checkpoints on a background thread, one in flight; the
    caller hands it host arrays snapshotted at the trigger.  ``submit``
    first joins the previous write and only logs its failure, but after
    ``escalate_after`` failures in a row it raises; ``wait()`` joins the
    write in flight and raises its error."""

    def __init__(self, escalate_after: int = 3):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_error: Optional[BaseException] = None
        self.escalate_after = escalate_after
        self.consecutive_failures = 0

    def submit(self, path: str, step: int, **host_kw) -> None:
        self.wait(raise_error=False)
        if self.consecutive_failures >= self.escalate_after:
            err, self._last_error = self._last_error, None
            self.consecutive_failures = 0
            raise RuntimeError(
                f"async checkpoint writes failed {self.escalate_after} "
                "times in a row") from err

        def run():
            try:
                save_checkpoint(path, step, **host_kw)
                self.consecutive_failures = 0
            except Exception as e:       # handed to wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="bigdl-ckpt",
                                        daemon=True)
        self._thread.start()

    def wait(self, raise_error: bool = True) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self.consecutive_failures += 1
            self._last_error = err
            if raise_error:
                raise err
