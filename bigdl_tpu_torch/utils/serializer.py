"""Durable model format — the port of ``bigdl_tpu.utils.serializer``.

A saved model is a directory with

- ``manifest.json``: the format version, the model's class and repr, and
  every tensor's shape and dtype;
- ``weights.npz``: the variables as a flat map from the JAX package's
  key paths (``jax.tree_util.keystr``: ``"['params']['block_0']['w']"``)
  to numpy arrays, in the order JAX flattens the tree (sorted keys).

The format is the JAX package's, so a directory saved by either package
loads in the other.  ``path`` may be local or a ``utils.storage`` URI;
the weights are written first and the manifest last, so a manifest
certifies complete weights.  Across processes only rank 0 writes
(``torch.distributed``); every process can read."""

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.utils import storage

FORMAT_VERSION = 1


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in ``jax.tree_util`` order: a dict's keys
    sorted, a list's or tuple's items in order; an empty container has
    no leaves."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _as_numpy(v) for k, v in _walk(tree)}


def _unflatten_like(template, flat: Dict[str, np.ndarray], prefix=""):
    """``template``'s structure with every leaf from ``flat``, shapes
    checked and each leaf cast to the template leaf's dtype."""
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat, f"{prefix}[{k!r}]")
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, flat, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing tensor {prefix}")
    arr = flat[prefix]
    leaf = _as_numpy(template)
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"shape mismatch for {prefix}: saved {arr.shape}, "
                         f"model {tuple(leaf.shape)}")
    return arr.astype(leaf.dtype)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def save_model(path: str, model, variables: Dict[str, Any],
               overwrite: bool = True) -> None:
    """Write ``variables`` (nested dicts of numpy arrays or tensors)
    under ``path`` (``Module.saveModule(path, overWrite)``)."""
    if storage.exists(storage.join(path, "manifest.json")) and not overwrite:
        raise FileExistsError(f"{path} exists and overwrite=False")
    if _rank() != 0:
        return
    storage.makedirs(path)
    flat = _flatten(variables)
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_class": type(model).__name__ if model is not None else None,
        "model_repr": repr(model) if model is not None else None,
        "tensors": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in flat.items()},
    }
    # weights first, manifest last; when overwriting a remote directory
    # the old manifest goes first, so it never certifies half-written
    # weights
    manifest_path = storage.join(path, "manifest.json")
    if storage.is_remote(path) and storage.exists(manifest_path):
        storage.remove_tree(manifest_path, ignore_errors=False)
    with storage.open_file(storage.join(path, "weights.npz"), "wb") as f:
        np.savez(f, **flat)
    storage.write_json(manifest_path, manifest, indent=1)


def load_model(path: str, model=None,
               template: Dict[str, Any] = None) -> Dict[str, Any]:
    """The variables saved by ``save_model``: with a ``template`` tree
    its structure, shapes checked and dtypes kept; otherwise nested dicts
    rebuilt from the key paths."""
    manifest = storage.read_json(storage.join(path, "manifest.json"))
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{manifest['format_version']} is newer than "
            f"this library (v{FORMAT_VERSION})")
    flat = storage.load_npz(storage.join(path, "weights.npz"))
    if template is not None:
        return _unflatten_like(template, flat)
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = [p.strip("[]'\"") for p in key.split("][")]
        parts = [p.replace("['", "").replace("']", "") for p in parts]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root
