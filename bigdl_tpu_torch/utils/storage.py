"""Local-or-remote filesystem seam for record files, summaries and
checkpoints — the port of ``bigdl_tpu.utils.storage``.

Every path-taking function dispatches on the URI scheme: plain paths and
``file://`` use ``os``/``open`` with no dependency; any other scheme
(``gs://``, ``s3://``, ``memory://``) goes through ``fsspec`` when it is
installed and raises one actionable error when it is not.  ``memory://``
gives tests a remote-semantics filesystem with no network.

Remote "directories" follow object-store semantics: they exist only as
key prefixes, creation is a no-op, and there is no atomic rename, so
writers order their files (data first, sidecar or manifest last).

``open_file`` is the fault-injection seam (``storage_io_fail``,
``resilience.faults``); ``mirror_tree`` copies a checkpoint to its
mirror."""

import json
import logging
import os
import posixpath
import shutil
from typing import IO, List, Optional

from bigdl_tpu_torch.resilience import faults

log = logging.getLogger("bigdl_tpu_torch.storage")

__all__ = [
    "is_remote", "join", "basename", "open_file", "exists", "isdir",
    "isfile", "listdir", "list_files", "makedirs", "remove_tree",
    "read_json", "write_json", "load_npz", "glob", "fingerprint",
    "mirror_tree",
]


def is_remote(path: str) -> bool:
    """True for scheme'd URIs (``gs://…``, ``s3://…``, ``memory://…``)
    other than ``file://``."""
    if "://" not in path:
        return False
    return path.split("://", 1)[0] != "file"


def _strip_file_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def _fs(path: str):
    """The fsspec filesystem of a remote URI, with an actionable error
    when the optional dependency is missing."""
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"path {path!r} needs the optional 'fsspec' dependency for "
            "remote filesystems (plus gcsfs for gs:// or s3fs for s3://). "
            "Local paths work without it.") from e
    try:
        fs, _ = fsspec.core.url_to_fs(path)
    except (ImportError, ValueError) as e:
        scheme = path.split("://", 1)[0]
        extra = {"gs": "gcsfs", "gcs": "gcsfs", "s3": "s3fs"}.get(
            scheme, f"an fsspec backend for {scheme}://")
        raise ImportError(
            f"fsspec has no handler for {path!r}; install {extra}") from e
    return fs


def _fs_path(path: str):
    """(fs, path without scheme), stripped the way the backend wants."""
    fs = _fs(path)
    return fs, fs._strip_protocol(path)


def join(path: str, *parts: str) -> str:
    if is_remote(path):
        return posixpath.join(path, *parts)
    return os.path.join(_strip_file_scheme(path), *parts)


def basename(path: str) -> str:
    if is_remote(path):
        return posixpath.basename(path.rstrip("/"))
    return os.path.basename(_strip_file_scheme(path))


def open_file(path: str, mode: str = "rb") -> IO:
    faults.fire("storage_io_fail")  # the one seam every byte crosses
    if is_remote(path):
        fs, p = _fs_path(path)
        return fs.open(p, mode)
    return open(_strip_file_scheme(path), mode)


def exists(path: str) -> bool:
    if is_remote(path):
        fs, p = _fs_path(path)
        return fs.exists(p)
    return os.path.exists(_strip_file_scheme(path))


def isdir(path: str) -> bool:
    if is_remote(path):
        fs, p = _fs_path(path)
        return fs.isdir(p)
    return os.path.isdir(_strip_file_scheme(path))


def isfile(path: str) -> bool:
    if is_remote(path):
        fs, p = _fs_path(path)
        return fs.isfile(p)
    return os.path.isfile(_strip_file_scheme(path))


def glob(pattern: str) -> List[str]:
    """Sorted matches; remote results keep the full URI scheme."""
    if not is_remote(pattern):
        import glob as _glob
        return sorted(_glob.glob(_strip_file_scheme(pattern)))
    fs, p = _fs_path(pattern)
    return [fs.unstrip_protocol(str(m)) for m in sorted(fs.glob(p))]


def list_files(path: str) -> List[str]:
    """Child FILE names of a directory, from one listing call (no stat
    round trip per child on an object store)."""
    if is_remote(path):
        fs, p = _fs_path(path)
        try:
            infos = fs.ls(p, detail=True)
        except FileNotFoundError:
            return []
        base = p.rstrip("/")
        out = []
        for info in infos:
            full = str(info.get("name", "")).rstrip("/")
            name = posixpath.basename(full)
            if name and full != base and info.get("type") == "file":
                out.append(name)
        return sorted(out)
    path = _strip_file_scheme(path)
    return sorted(n for n in os.listdir(path)
                  if os.path.isfile(os.path.join(path, n)))


def listdir(path: str) -> List[str]:
    """Child NAMES (not full paths); [] for a missing remote prefix."""
    if is_remote(path):
        fs, p = _fs_path(path)
        try:
            infos = fs.ls(p, detail=False)
        except FileNotFoundError:
            return []
        base = p.rstrip("/")
        out = []
        for child in infos:
            name = posixpath.basename(str(child).rstrip("/"))
            if name and str(child).rstrip("/") != base:
                out.append(name)
        return out
    return os.listdir(_strip_file_scheme(path))


def makedirs(path: str) -> None:
    """No-op on object stores (prefixes need no creation)."""
    if is_remote(path):
        return
    os.makedirs(_strip_file_scheme(path), exist_ok=True)


def remove_tree(path: str, ignore_errors: bool = True) -> None:
    if is_remote(path):
        fs, p = _fs_path(path)
        try:
            fs.rm(p, recursive=True)
        except FileNotFoundError:
            if not ignore_errors:
                raise
        except Exception as e:
            if not ignore_errors:
                raise
            # swallowed by contract (clean-up must not stop training), but
            # not silently: storage is not being reclaimed
            log.warning("remote remove_tree(%s) failed (%s: %s); "
                        "continuing, but storage is NOT being reclaimed",
                        path, type(e).__name__, e)
        return
    path = _strip_file_scheme(path)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=ignore_errors)
    elif os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            if not ignore_errors:
                raise
    elif not ignore_errors:
        raise FileNotFoundError(path)


def load_npz(path: str) -> dict:
    """An npz as a plain dict, every array read before the file closes
    (``np.load`` over an fsspec file is lazy)."""
    import numpy as np

    with open_file(path, "rb") as f:
        with np.load(f) as z:
            return {k: z[k] for k in z.files}


def fingerprint(path: str) -> Optional[dict]:
    """Change-detection identity of a file: whichever of size / etag /
    mtime / checksum the backend exposes, as strings.  None when the file
    is missing or cannot be stat'ed; callers read None as "cannot
    verify", not as a failure."""
    try:
        if is_remote(path):
            fs, p = _fs_path(path)
            info = fs.info(p)
            out = {k: str(info[k])
                   for k in ("size", "etag", "ETag", "mtime", "checksum",
                             "md5Hash", "LastModified")
                   if info.get(k) is not None}
            return out or None
        st = os.stat(_strip_file_scheme(path))
        return {"size": str(st.st_size), "mtime": str(st.st_mtime)}
    except (OSError, ImportError, KeyError):
        return None


def mirror_tree(src: str, dst: str, policy=None, metrics=None,
                sleep=None) -> int:
    """Copy every file under ``src`` (recursively) to ``dst``, the
    checkpoint's mirror, and return the bytes copied.  Each file gets a
    bounded retry with backoff (``policy``: 3 retries from 0.2 s by
    default), every retry counted as ``retries_by_cause.
    transient_storage`` in ``metrics`` (the process registry by
    default); exhausted retries raise and the caller decides.  A
    ``manifest.json`` is copied last, so a mirror cut short is no
    checkpoint to a reader."""
    import time

    from bigdl_tpu_torch.optim.metrics import global_metrics
    from bigdl_tpu_torch.resilience.retry import RetryPolicy

    policy = policy or RetryPolicy(max_retries=3, base_s=0.2, max_s=5.0)
    metrics = metrics if metrics is not None else global_metrics()
    sleep = sleep or time.sleep

    def walk(rel: str):
        base = join(src, rel) if rel else src
        for name in listdir(base):
            p = f"{rel}/{name}" if rel else name
            if isdir(join(src, p)):
                yield from walk(p)
            else:
                yield p

    files = sorted(walk(""),
                   key=lambda p: (p.split("/")[-1] == "manifest.json", p))
    makedirs(dst)
    total = 0
    for p in files:
        target = join(dst, *p.split("/"))
        if "/" in p:
            makedirs(join(dst, *p.split("/")[:-1]))
        attempt = 0
        while True:
            try:
                with open_file(join(src, *p.split("/")), "rb") as f:
                    data = f.read()
                with open_file(target, "wb") as g:
                    g.write(data)
                total += len(data)
                break
            except Exception as e:       # storage errors of any backend
                attempt += 1
                if attempt > policy.max_retries:
                    raise
                metrics.inc("retries_by_cause.transient_storage")
                delay = policy.backoff(attempt)
                log.warning("mirror %s -> %s failed (%s: %s); retry %d/%d "
                            "in %.2fs", p, dst, type(e).__name__, e,
                            attempt, policy.max_retries, delay)
                sleep(delay)
    return total


def read_json(path: str):
    with open_file(path, "r") as f:
        return json.load(f)


def write_json(path: str, obj, indent: Optional[int] = None) -> None:
    with open_file(path, "w") as f:
        json.dump(obj, f, indent=indent)
