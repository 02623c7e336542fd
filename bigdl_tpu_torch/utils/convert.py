"""Weight bridge between the JAX package's variables trees and the port's
modules.

A JAX params (or state) tree is nested dicts of arrays whose keys are the
port's attribute names, except ``dec{i}``, which is ``decoder[i]`` of the
Transformer::

    {"embedding", "dec0": {"ln1": {"weight", "bias"}, "ln2": ...,
     "attn": {"wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"},
     "ffn": {"l1": {"weight", "bias"}, "l2": ...}}, ..., "ln_out": ...}

A translation Transformer's ``enc{i}`` is ``encoder[i]``.  A wrapper
whose JAX variables are its wrapped layer's own (``TimeDistributed``,
``Recurrent``, the QAT and LoRA twins of ``nn/qat.py`` and
``nn/lora.py``) holds that layer as its child ``inlined``, a name the
JAX paths leave out, so a JAX QAT model's ``act_amax`` state and a JAX
LoRA model's ``lora_a`` / ``lora_b`` sit beside the wrapped layer's
``weight`` and ``bias`` in both trees.

A container's child is the key ``f"{i}_{name}"`` in both packages, and
BatchNorm's running statistics are the ``state`` tree's leaves and the
port's buffers::

    params {"0_Conv2D": {"weight"}, "1__BN": {"weight", "bias"},
            "4_Bottleneck": {"body": {"0_Conv2D": ...}, "proj": ...}}
    state  {"1__BN": {"running_mean", "running_var"}, ...}

Both packages store Linear weights (in, out) and conv kernels HWIO, so
values copy as they are.  A checkpoint's ``flat`` vector is the params
tree raveled as ``jax.flatten_util.ravel_pytree`` ravels it
(:func:`flat_order`, :func:`ravel`, :func:`unravel_into`).  The same walk
applies to any sub-module.  A
keras graph's variables are keyed by node names, which differ between
the packages: :func:`load_jax_keras_variables` pairs the nodes by their
place in the two graphs instead."""

import re
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.ops.common import is_dtensor

_LISTS = {"dec": "decoder", "enc": "encoder"}
_LISTED = re.compile(r"(dec|enc)(\d+)$")
# the child of a wrapper whose JAX variables are that child's own
INLINED = "inlined"


def _child(module: nn.Module, key: str):
    m = _LISTED.match(key)
    if m and hasattr(module, _LISTS[m.group(1)]):
        return getattr(module, _LISTS[m.group(1)])[int(m.group(2))]
    if not hasattr(module, key) and hasattr(module, INLINED):
        return _child(getattr(module, INLINED), key)
    if not hasattr(module, key):
        raise KeyError(f"{type(module).__name__} has no {key!r}")
    return getattr(module, key)


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy ``params`` (nested dicts of numpy or JAX arrays) into
    ``model``'s parameters (or, for a state tree, its buffers) in place;
    every leaf must match a tensor of the same shape.  Returns
    ``model``."""
    with torch.no_grad():
        for key, val in params.items():
            target = _child(model, key)
            if isinstance(val, dict):
                load_jax_params(target, val)
                continue
            if not isinstance(target, torch.Tensor):
                raise KeyError(f"{key}: the port's {type(target).__name__} "
                               f"is not a tensor")
            arr = np.array(val, dtype=np.float32)   # a writable copy
            if tuple(target.shape) != arr.shape:
                raise ValueError(f"{key}: shape {arr.shape} does not match "
                                 f"the port's {tuple(target.shape)}")
            target.copy_(_placed_like(target, torch.from_numpy(arr)))
    return model


def _placed_like(target: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (the whole tensor, the same on every rank) placed as
    ``target``: its own local shard of a layout's DTensor, else itself."""
    if not is_dtensor(target):
        return value
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(target.device), target.device_mesh,
                             target.placements, src_data_rank=None)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's whole value on the host as float32 (a layout's DTensor
    gathered first: a collective every rank of its mesh calls)."""
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().numpy().astype(np.float32)


def load_jax_variables(model: nn.Module,
                       variables: Dict[str, Any]) -> nn.Module:
    """Copy a JAX ``{"params", "state"}`` tree into ``model``: params into
    its parameters, state into its buffers.  Returns ``model``."""
    load_jax_params(model, variables.get("params", {}))
    load_jax_params(model, variables.get("state", {}))
    return model


def jax_path(name: str) -> Tuple[str, ...]:
    """The JAX tree path of the port's dotted parameter or buffer
    name."""
    parts = [p for p in name.split(".") if p != INLINED]
    if parts[0] in ("decoder", "encoder"):
        parts = [f"{parts[0][:3]}{parts[1]}"] + parts[2:]
    return tuple(parts)


def nest(named, leaf: Callable = lambda v: v) -> Dict[str, Any]:
    """Nested dicts keyed as the JAX package keys them, from (dotted
    name, value) pairs, each value passed through ``leaf``."""
    tree: Dict[str, Any] = {}
    for name, v in named:
        parts = jax_path(name)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf(v)
    return tree


def _tree(named) -> Dict[str, Any]:
    return nest(named, _host)


def flat_order(names: Sequence[str]) -> List[int]:
    """Indices of ``names`` in the order of ``jax.flatten_util.
    ravel_pytree`` over the JAX tree: its leaves under sorted keys, i.e.
    the JAX paths in lexicographic order ("10_..." before "2_...")."""
    return sorted(range(len(names)), key=lambda i: jax_path(names[i]))


def ravel(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One float32 vector of ``tensors``, each flattened, in order."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


@torch.no_grad()
def unravel_into(flat, tensors: Sequence[torch.Tensor]) -> None:
    """Copy consecutive slices of the vector ``flat`` into ``tensors``;
    ``flat`` may be longer (a JAX vector padded to the mesh), never
    shorter."""
    flat = torch.as_tensor(np.asarray(flat, np.float32))
    need = sum(t.numel() for t in tensors)
    if flat.numel() < need:
        raise ValueError(f"a flat vector of {flat.numel()} elements for "
                         f"{need} parameters")
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].reshape(t.shape))
        off += n


def export_params(model: nn.Module) -> Dict[str, Any]:
    """The params tree of ``model`` as nested dicts of float32 numpy
    arrays, keyed as the JAX package keys it."""
    return _tree(model.named_parameters())


def export_variables(model: nn.Module) -> Dict[str, Any]:
    """``{"params": ..., "state": ...}`` of ``model`` as the JAX package
    keys them: the parameters, and the persistent buffers (BatchNorm's
    running statistics)."""
    persistent = set(model.state_dict().keys())
    return {"params": export_params(model),
            "state": _tree((n, b) for n, b in model.named_buffers()
                           if n in persistent)}


def _leaves(tree, prefix=()):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _same_tree(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return (len(la) == len(lb)
            and all(ka == kb and np.array_equal(va, vb)
                    for (ka, va), (kb, vb) in zip(la, lb)))


def export_keras_variables(model: nn.Module) -> Dict[str, Any]:
    """``{"params", "state"}`` of a keras ``Model`` keyed by its node
    names, as the JAX package keys a keras model's variables: each node
    that holds a layer with tensors gets that layer's tree (a layer at
    two nodes, the same tree under both names)."""
    out: Dict[str, Any] = {"params": {}, "state": {}}
    for node in model.order:
        if node.layer is None:
            continue
        tree = export_variables(node.layer)
        for kind in ("params", "state"):
            if tree[kind]:
                out[kind][node.name] = tree[kind]
    return out


def load_keras_variables(model: nn.Module,
                         variables: Dict[str, Any]) -> nn.Module:
    """Copy a node-keyed ``{"params", "state"}`` (the keys of
    :func:`export_keras_variables`) into a keras ``Model``.  A layer
    used at two nodes has one set of weights here, so the variables of
    its nodes must be equal (ROADMAP C.7); a layer with parameters whose
    node has none in ``variables`` raises.  Returns ``model``."""
    params = variables.get("params", {}) or {}
    state = variables.get("state", {}) or {}
    loaded: Dict[int, Dict[str, Any]] = {}
    for i, node in enumerate(model.order):
        if node.layer is None:
            continue
        tree = {"params": params.get(node.name, {}),
                "state": state.get(node.name, {})}
        if not tree["params"] and any(True for _ in
                                      node.layer.parameters()):
            raise KeyError(f"node {node.name}: no variables for its "
                           f"{type(node.layer).__name__}")
        seen = loaded.get(id(node.layer))
        if seen is not None:
            if not _same_tree(seen, tree):
                raise ValueError(f"node {i} ({node.name}): its layer is "
                                 f"shared with an earlier node, whose "
                                 f"variables differ from this one's")
            continue
        load_jax_variables(node.layer, tree)
        loaded[id(node.layer)] = tree
    return model


def load_jax_keras_variables(model: nn.Module, jax_model,
                             variables: Dict[str, Any]) -> nn.Module:
    """Copy the ``{"params", "state"}`` of a JAX keras ``Model`` (or keras
    ``Sequential``) into the port's keras ``model`` of the same graph.

    The JAX package keys a node's variables by its name, which comes from
    a global counter, so the names differ between the packages.  The two
    graphs' topological orders are walked together instead: each pair of
    nodes must hold the same layer type and read the same positions, and
    the JAX node's variables go into the port node's layer
    (:func:`load_keras_variables` under the port's names).  Returns
    ``model``."""
    jorder, porder = list(jax_model.order), list(model.order)
    if len(jorder) != len(porder):
        raise ValueError(f"the JAX graph has {len(jorder)} nodes, the "
                         f"port's {len(porder)}")
    jpos = {n.id: i for i, n in enumerate(jorder)}
    ppos = {n.id: i for i, n in enumerate(porder)}
    renamed: Dict[str, Any] = {"params": {}, "state": {}}
    for i, (jn, pn) in enumerate(zip(jorder, porder)):
        jt = "Input" if jn.layer is None else type(jn.layer).__name__
        pt = "Input" if pn.layer is None else type(pn.layer).__name__
        if jt != pt:
            raise ValueError(f"node {i}: the JAX graph has {jt}, the "
                             f"port's {pt}")
        if ([jpos[p.id] for p in jn.parents]
                != [ppos[p.id] for p in pn.parents]):
            raise ValueError(f"node {i} ({pt}) reads other nodes in the "
                             f"two graphs")
        for kind in ("params", "state"):
            tree = (variables.get(kind) or {}).get(jn.name)
            if tree:
                renamed[kind][pn.name] = tree
    return load_keras_variables(model, renamed)
