"""Keras-style functional models — the port of ``bigdl_tpu.keras.engine``:
symbolic ``Node``s, ``Input``, ``Model(inputs, outputs)`` and keras
``Sequential``.

Calling any layer of the port on a ``Node`` (or a list of nodes)
returns a new ``Node`` (``nn.module.Module.__call__``), so a model is
written as in the JAX package::

    tok = Input((128,), dtype=np.int32)
    x = LayerNorm(768)(Embedding(30522, 768)(tok))
    model = Model(tok, x)

A ``Model`` is a ``torch.nn.Module`` that registers each node's layer
as a child under the node's name, so ``.to()``, ``.eval()`` and
``named_parameters()`` cover the graph, and whose ``forward`` runs the
nodes in topological order.  The JAX package keys each node's variables
by the node's name; here the layer owns its weights, so a layer used at
two nodes is one module with one set of weights at both.  The keras
training surface (``compile`` / ``fit`` / ``evaluate`` / ``predict`` /
``set_weights``) is not ported yet."""

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from torch import nn

from bigdl_tpu_torch.nn.module import Module

_node_counter = [0]


class Node:
    """Symbolic tensor in the layer graph: the layer that makes it (None
    for an input) and the nodes it reads."""

    _graph_node = True   # the sentinel nn.module.Module.__call__ checks

    def __init__(self, layer: Optional[nn.Module], parents: Sequence["Node"],
                 shape: Optional[Tuple[int, ...]] = None):
        _node_counter[0] += 1
        self.id = _node_counter[0]
        self.layer = layer
        self.parents = list(parents)
        self.shape = shape   # only set for Input nodes
        lname = (getattr(layer, "name", type(layer).__name__)
                 if layer is not None else "input")
        self.name = f"{lname}_{self.id}"

    def __repr__(self):
        return f"Node({self.name})"


def Input(shape: Optional[Tuple[int, ...]], dtype=np.float32) -> Node:
    """Symbolic input; ``shape`` excludes the batch dim."""
    n = Node(None, [], shape=None if shape is None else tuple(shape))
    n.dtype = dtype
    return n


def _topo_order(outputs: List[Node]) -> List[Node]:
    order, seen = [], set()

    def visit(n: Node):
        if n.id in seen:
            return
        seen.add(n.id)
        for p in n.parents:
            visit(p)
        order.append(n)

    for o in outputs:
        visit(o)
    return order


class Model(Module):
    """Functional graph model over ``inputs`` and ``outputs``; returns
    one tensor, or a tuple for several outputs."""

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]], name=None):
        super().__init__(name or "Model")
        self.inputs = [inputs] if isinstance(inputs, Node) else list(inputs)
        self.outputs = ([outputs] if isinstance(outputs, Node)
                        else list(outputs))
        self._set_order(_topo_order(self.outputs))

    def _set_order(self, order: List[Node]) -> None:
        self.order = order
        self._modules.clear()
        last_reader = {}
        for i, node in enumerate(order):
            if node.layer is not None and all(
                    m is not node.layer for m in self._modules.values()):
                self.add_module(node.name, node.layer)
            for p in node.parents:
                last_reader[p.id] = i
        # the values forward may drop after each node: those it was the
        # last to read, outputs excepted (eagerly, every value kept to the
        # end of a forward would hold all activations at once)
        outs = {o.id for o in self.outputs}
        self._drop_after: List[List[int]] = [[] for _ in order]
        for nid, i in last_reader.items():
            if nid not in outs:
                self._drop_after[i].append(nid)

    def forward(self, *inputs, key=None):
        """The nodes in topological order; with a ``key``, node ``i`` of
        that order gets ``prng.fold_in(key, i)``, as in the JAX
        package."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{self.name} takes {len(self.inputs)} inputs, "
                             f"got {len(inputs)}")
        values = {node.id: x for node, x in zip(self.inputs, inputs)}
        for i, (node, drop) in enumerate(zip(self.order, self._drop_after)):
            if node.layer is not None:
                values[node.id] = self.call_child(
                    node.layer, i, *[values[p.id] for p in node.parents],
                    key=key)
            for nid in drop:
                del values[nid]
        outs = [values[o.id] for o in self.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)


class Sequential(Model):
    """Keras ``Sequential``: a chain of layers built as a one-input graph,
    rebuilt at every ``add``."""

    def __init__(self, layers: Sequence[nn.Module] = (), input_shape=None,
                 name=None):
        Module.__init__(self, name or "Sequential")
        self._layers: List[nn.Module] = []
        self._input_shape = input_shape
        self.inputs, self.outputs = [], []
        self._set_order([])
        for layer in layers:
            self.add(layer)

    def add(self, layer: nn.Module) -> "Sequential":
        self._layers.append(layer)
        node = inp = Input(self._input_shape)
        for lay in self._layers:
            node = Node(lay, [node])
        self.inputs, self.outputs = [inp], [node]
        self._set_order(_topo_order(self.outputs))
        return self
