"""Checkpoints — the port of the single-writer format of
``bigdl_tpu.optim.checkpoint``.

A checkpoint is the directory ``<path>/ckpt-<step>``, written into
``ckpt-<step>.tmp`` and renamed when complete, with

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
- ``model_state.npz``: the BatchNorm running buffers under their JAX
  paths (``1_BatchNorm/running_mean``);
- ``manifest.json``: the step and the training loop's state, written last.

So either package resumes from the other's checkpoint; a JAX vector
padded to its mesh (``n_pad``) is read up to the port's length.  This
module works on host numpy arrays: the caller snapshots its tensors at
the trigger.  Not ported: the sharded ZeRO-1 shards and remote storage
(with multi-device training), and mirrors and fault hooks (with the
retry loop)."""

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Arrays = Dict[str, np.ndarray]


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


def save_checkpoint(path: str, step: int, *, flat_params: np.ndarray,
                    opt_state: Arrays, model_state: Arrays,
                    driver_state: Optional[Dict[str, Any]] = None,
                    keep_last: int = 3,
                    ema_flat: Optional[np.ndarray] = None) -> str:
    """Write ``<path>/ckpt-<step>`` and return it; then keep only the
    newest ``keep_last`` checkpoints (0: all)."""
    d = os.path.join(path, f"ckpt-{step}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    def savez(name, **arrs):
        with open(os.path.join(tmp, name), "wb") as f:
            np.savez(f, **arrs)

    savez("params.npz", flat=np.asarray(flat_params))
    if ema_flat is not None:
        savez("ema.npz", flat=np.asarray(ema_flat))
    savez("opt_state.npz", **opt_state)
    savez("model_state.npz", **model_state)
    manifest = {"step": step, "driver_state": jsonable_state(driver_state)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    _gc(path, keep_last)
    return d


def _scan(path: str) -> List[Tuple[int, str, bool]]:
    """(step, name, has_manifest) of every ``ckpt-<step>`` directory."""
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        if not name.startswith("ckpt-") or name.endswith(".tmp"):
            continue
        try:
            step = int(name.split("-")[1])
        except ValueError:
            continue
        out.append((step, name, os.path.exists(
            os.path.join(path, name, "manifest.json"))))
    return out


def latest_checkpoint(path: str) -> Optional[str]:
    """The newest complete checkpoint under ``path``, or None."""
    steps = [(s, n) for s, n, complete in _scan(path) if complete]
    return os.path.join(path, max(steps)[1]) if steps else None


def _load_npz(p: str) -> Arrays:
    with np.load(p) as z:
        return {k: z[k] for k in z.files}


def load_checkpoint(ckpt_dir: str) -> Tuple[np.ndarray, Arrays, Arrays,
                                            Dict[str, Any],
                                            Optional[np.ndarray]]:
    """(flat params, opt-state arrays, model-state arrays, loop state,
    EMA flat or None) of one checkpoint directory."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _load_npz(os.path.join(ckpt_dir, "params.npz"))["flat"]
    ema_path = os.path.join(ckpt_dir, "ema.npz")
    ema = _load_npz(ema_path)["flat"] if os.path.exists(ema_path) else None
    return (flat, _load_npz(os.path.join(ckpt_dir, "opt_state.npz")),
            _load_npz(os.path.join(ckpt_dir, "model_state.npz")),
            manifest["driver_state"], ema)


def _gc(path: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` complete checkpoints; remove older
    ones, and directories without a manifest older than the newest
    complete one (a crash mid-write)."""
    scan = _scan(path)
    valid = sorted((s, n) for s, n, complete in scan if complete)
    if not valid:
        return
    newest = valid[-1][0]
    keep = {n for _, n in valid[-keep_last:]} if keep_last > 0 else None
    for step, name, complete in scan:
        stale = (keep is not None and complete and name not in keep) or (
            not complete and step < newest)
        if stale:
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)


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
