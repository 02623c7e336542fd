"""Weight bridge between the JAX package's params trees and the port's
modules.

A JAX params tree is nested dicts of arrays whose keys are the port's
attribute names, except ``dec{i}``, which is ``decoder[i]``::

    {"embedding", "dec0": {"ln1": {"weight", "bias"}, "ln2": ...,
     "attn": {"wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"},
     "ffn": {"l1": {"weight", "bias"}, "l2": ...}}, ..., "ln_out": ...}

Both packages store Linear weights (in, out), so values copy as they
are.  The same walk applies to any sub-module (a ``TransformerLayer``
with its own ``{"attn", "ln1", ...}`` tree)."""

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

_DEC = re.compile(r"dec(\d+)$")


def _child(module: nn.Module, key: str):
    m = _DEC.match(key)
    if m:
        return module.decoder[int(m.group(1))]
    if not hasattr(module, key):
        raise KeyError(f"{type(module).__name__} has no {key!r}")
    return getattr(module, key)


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy ``params`` (nested dicts of numpy or JAX arrays) into
    ``model``'s parameters in place; every leaf must match a parameter
    of the same shape.  Returns ``model``."""
    with torch.no_grad():
        for key, val in params.items():
            target = _child(model, key)
            if isinstance(val, dict):
                load_jax_params(target, val)
                continue
            arr = np.array(val, dtype=np.float32)   # a writable copy
            if tuple(target.shape) != arr.shape:
                raise ValueError(f"{key}: shape {arr.shape} does not match "
                                 f"the port's {tuple(target.shape)}")
            target.copy_(torch.from_numpy(arr))
    return model


def export_params(model: nn.Module) -> Dict[str, Any]:
    """The params tree of ``model`` as nested dicts of float32 numpy
    arrays, keyed as the JAX package keys it."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "decoder":
            parts = [f"dec{parts[1]}"] + parts[2:]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p.detach().cpu().numpy().astype(np.float32)
    return tree
