"""Module base and containers — the port of ``bigdl_tpu.nn.module``.

The JAX package's modules are stateless descriptions with an explicit
``{"params", "state"}`` tree; here they are ``torch.nn.Module``s that
own their parameters (and BatchNorm's running statistics as buffers).
A container registers its ``i``-th child under the JAX key
``f"{i}_{child.name}"``, so ``named_parameters()`` and
``named_buffers()`` spell the JAX ``params`` and ``state`` trees and
``utils.convert`` copies variables across one to one.  The JAX
``training=`` argument is the module's ``train()`` / ``eval()`` mode, and
its ``rng=`` the optional ``key`` of a forward: a container hands child
``i`` ``prng.fold_in(key, i)``, as the JAX containers fold theirs."""

import inspect
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from bigdl_tpu_torch.utils import prng


_TAKES_KEY: Dict[type, bool] = {}


def _takes_key(layer: nn.Module) -> bool:
    """Whether ``layer``'s forward accepts a ``key`` keyword."""
    cls = type(layer)
    if cls not in _TAKES_KEY:
        params = inspect.signature(cls.forward).parameters.values()
        _TAKES_KEY[cls] = any(p.name == "key" or p.kind is p.VAR_KEYWORD
                              for p in params)
    return _TAKES_KEY[cls]


def _is_node(v) -> bool:
    # the sentinel of keras.engine.Node: nn never imports the keras package
    return getattr(v, "_graph_node", False)


class Module(nn.Module):
    """Base of the port's layers: a ``name`` (default: the class name),
    which a container uses in its child's key.

    Called on a keras graph ``Node`` (or a list of nodes), a layer
    returns a new ``Node`` with this layer and those parents, as
    ``layer(node)`` builds a functional model in the JAX package;
    called on tensors it runs ``forward``."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__

    def __call__(self, *args, **kwargs):
        if args and (_is_node(args[0]) or (
                isinstance(args[0], (list, tuple)) and args[0]
                and all(_is_node(v) for v in args[0]))):
            from bigdl_tpu_torch.keras.engine import Node

            parents = ([args[0]] if _is_node(args[0]) else list(args[0]))
            parents += [a for a in args[1:] if _is_node(a)]
            return Node(self, parents)
        return super().__call__(*args, **kwargs)

    @staticmethod
    def call_child(layer: nn.Module, i: int, *xs, key=None):
        """``layer(*xs)``, handing it ``prng.fold_in(key, i)`` when a key
        is given and its forward takes one (the JAX ``_fold(rng, i)``);
        a child whose forward takes no key gets none."""
        if key is None or not _takes_key(layer):
            return layer(*xs)
        return layer(*xs, key=prng.fold_in(key, i))


class Container(Module):
    """Module with sub-modules, keyed ``f"{i}_{name}"``."""

    def __init__(self, layers: Sequence[nn.Module] = (),
                 name: Optional[str] = None):
        super().__init__(name)
        for layer in layers:
            self.add(layer)

    def add(self, layer: nn.Module) -> "Container":
        name = getattr(layer, "name", type(layer).__name__)
        self.add_module(f"{len(self._modules)}_{name}", layer)
        return self

    @property
    def layers(self):
        return list(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i: int) -> nn.Module:
        return self.layers[i]


def _as_tuple(y):
    return y if isinstance(y, tuple) else (y,)


class Sequential(Container):
    """Feed-forward chain; a child that returns a tuple feeds its
    elements to the next child as separate inputs."""

    def forward(self, *xs, key=None):
        for i, layer in enumerate(self._modules.values()):
            xs = _as_tuple(self.call_child(layer, i, *xs, key=key))
        return xs[0] if len(xs) == 1 else xs


class Concat(Container):
    """Runs every child on the same input and concatenates the outputs
    along ``dim`` (default -1, the NHWC channel axis)."""

    def __init__(self, layers=(), dim: int = -1, name=None):
        super().__init__(layers, name)
        self.dim = dim

    def forward(self, *xs, key=None):
        return torch.cat([self.call_child(m, i, *xs, key=key)
                          for i, m in enumerate(self._modules.values())],
                         dim=self.dim)


class ConcatTable(Container):
    """Runs every child on the same input; returns the tuple of
    outputs."""

    def forward(self, *xs, key=None):
        return tuple(self.call_child(m, i, *xs, key=key)
                     for i, m in enumerate(self._modules.values()))


def _table(xs):
    """Varargs, or one tuple/list, as a tuple."""
    if len(xs) == 1 and isinstance(xs[0], (tuple, list)):
        return tuple(xs[0])
    return xs


class ParallelTable(Container):
    """The i-th child consumes the i-th input."""

    def forward(self, *xs, key=None):
        xs = _table(xs)
        return tuple(self.call_child(m, i, x, key=key)
                     for i, (m, x) in enumerate(zip(self._modules.values(),
                                                    xs)))


class Identity(Module):
    def forward(self, x):
        return x


class Lambda(Module):
    """A pure function of the inputs as a module."""

    def __init__(self, fn: Callable, name=None):
        super().__init__(name or getattr(fn, "__name__", "Lambda"))
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


class CAddTable(Module):
    """Elementwise sum of a table input."""

    def forward(self, *xs):
        xs = _table(xs)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class CMulTable(Module):
    """Elementwise product of a table input."""

    def forward(self, *xs):
        xs = _table(xs)
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out


class JoinTable(Module):
    """Concatenates a table input along ``dim``."""

    def __init__(self, dim: int = -1, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, *xs):
        return torch.cat(list(_table(xs)), dim=self.dim)


class SelectTable(Module):
    def __init__(self, index: int, name=None):
        super().__init__(name)
        self.index = index

    def forward(self, *xs):
        return _table(xs)[self.index]
