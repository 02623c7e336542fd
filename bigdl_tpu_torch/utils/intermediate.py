"""IR graph and engine retargeting — the port of
``bigdl_tpu.utils.intermediate``.

A built model (a keras ``Model`` or an nn ``Sequential``) is lifted to
an engine-neutral graph of :class:`IRNode`s and re-emitted as a keras
``Model`` for one of two engines, named as in the JAX package:

- ``"xla"``: the same layers, an identity rebuild;
- ``"fused"``: the inference rewrites, in this order:
    * ``Dropout`` and ``Identity`` nodes dropped;
    * a ``BatchNorm`` folded into the ``Conv2D`` or ``Linear`` before it
      (float64 scale and bias, cast to float32; a layer without a bias
      gains one), where that producer has no other consumer and is no
      graph output;
    * every ``LayerNorm`` node re-emitted as :class:`FusedLayerNorm`, on
      the hand-written LayerNorm kernel (``ops.fused``).

Usage::

    ir = IRGraph.from_model(model)
    fast = ir.to_model("fused")     # a new keras Model
    same = ir.to_model("xla")

The weights live in the layers, so every ``to_model`` deep-copies them:
neither the caller's model nor the graph is ever changed, and a layer
used at two nodes stays one layer in the copy.  Unlike the JAX package,
a BatchNorm is not folded where its producer's or its own layer is used
at another node too, since that node would see the folded weights."""

import copy
from typing import Dict, List

import torch
from torch import nn

from bigdl_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dropout, LayerNorm,
                                      Linear)
from bigdl_tpu_torch.nn.module import Identity, Module, Sequential
from bigdl_tpu_torch.ops.fused import fused_layernorm


class FusedLayerNorm(Module):
    """LayerNorm on :func:`~bigdl_tpu_torch.ops.fused.fused_layernorm`,
    the counterpart of the JAX package's ``PallasLayerNorm``; its
    ``weight`` and ``bias`` are those of ``nn.LayerNorm``."""

    def __init__(self, num_features: int, eps: float = 1e-6, name=None):
        super().__init__(name)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    @staticmethod
    def from_layernorm(ln: LayerNorm) -> "FusedLayerNorm":
        """The twin of ``ln``, with its eps, name and weights, on its
        device."""
        twin = FusedLayerNorm(ln.weight.shape[0], eps=ln.eps, name=ln.name)
        twin.weight, twin.bias = ln.weight, ln.bias
        return twin

    def forward(self, x):
        shape = x.shape
        y = fused_layernorm(x.reshape(-1, shape[-1]), self.weight,
                            self.bias, eps=self.eps)
        return y.reshape(shape)


class IRNode:
    """One op in the engine-neutral graph: a layer (None for an input)
    and the nodes it reads."""

    __slots__ = ("layer", "parents", "is_input", "uid")
    _counter = [0]

    def __init__(self, layer=None, parents=(), is_input=False):
        IRNode._counter[0] += 1
        self.uid = IRNode._counter[0]
        self.layer = layer
        self.parents: List[IRNode] = list(parents)
        self.is_input = is_input

    def __repr__(self):
        t = "Input" if self.is_input else type(self.layer).__name__
        return f"IRNode({t}#{self.uid})"


class IRGraph:
    """Engine-neutral graph of IRNodes; ``order`` is topological, inputs
    included.  Its nodes hold the model's own layers, which
    :meth:`to_model` copies."""

    def __init__(self, inputs: List[IRNode], outputs: List[IRNode],
                 order: List[IRNode], training: bool = False):
        self.inputs = inputs
        self.outputs = outputs
        self.order = order
        self.training = training

    @staticmethod
    def from_model(model: nn.Module) -> "IRGraph":
        """Lift a keras ``Model`` (or keras ``Sequential``), or an nn
        ``Sequential`` (nested Sequentials flattened, other children
        kept whole)."""
        from bigdl_tpu_torch.keras.engine import Model as KModel

        if isinstance(model, KModel):
            by_id: Dict[int, IRNode] = {}
            order: List[IRNode] = []
            inputs: List[IRNode] = []
            for node in model.order:
                if node.layer is None:
                    ir = IRNode(is_input=True)
                    inputs.append(ir)
                else:
                    ir = IRNode(node.layer,
                                [by_id[p.id] for p in node.parents])
                by_id[node.id] = ir
                order.append(ir)
            outputs = [by_id[o.id] for o in model.outputs]
            return IRGraph(inputs, outputs, order, model.training)
        if isinstance(model, Sequential):
            inp = IRNode(is_input=True)
            order = [inp]
            out = IRGraph._chain_sequential(model, inp, order)
            return IRGraph([inp], [out], order, model.training)
        raise TypeError(f"cannot lift {type(model).__name__} to IR")

    @staticmethod
    def _chain_sequential(seq: Sequential, cur: IRNode,
                          order: List[IRNode]) -> IRNode:
        for child in seq.layers:
            if isinstance(child, Sequential):
                cur = IRGraph._chain_sequential(child, cur, order)
            else:
                cur = IRNode(child, [cur])
                order.append(cur)
        return cur

    def to_model(self, engine: str = "xla"):
        """A new keras ``Model`` of this graph for ``engine``, in the
        source model's train/eval mode."""
        if engine not in ("xla", "fused"):
            raise ValueError(f"unknown engine {engine!r}: 'xla' or 'fused'")
        nodes, outputs = _copy_graph(self.order, self.outputs)
        if engine == "fused":
            nodes, outputs = _fuse_pass(nodes, outputs)
        return _emit(self.inputs, nodes, outputs).train(self.training)


# ---------------------------------------------------------------------------
# fusion pass
# ---------------------------------------------------------------------------


def _consumer_counts(nodes: List[IRNode]) -> Dict[int, int]:
    c: Dict[int, int] = {}
    for n in nodes:
        for p in n.parents:
            c[p.uid] = c.get(p.uid, 0) + 1
    return c


def _copy_graph(nodes: List[IRNode], outputs: List[IRNode]):
    """Uid-preserving copy of the node list with parents remapped into
    the copies and every layer deep-copied (one memo, so a layer shared
    by two nodes stays shared in the copy)."""
    memo: dict = {}
    by_uid: Dict[int, IRNode] = {}
    copies = []
    for n in nodes:
        c = IRNode(None if n.is_input else copy.deepcopy(n.layer, memo),
                   [by_uid[p.uid] for p in n.parents], n.is_input)
        c.uid = n.uid
        by_uid[c.uid] = c
        copies.append(c)
    return copies, [by_uid[o.uid] for o in outputs]


def _fold_bn(prod: nn.Module, bn: BatchNorm) -> None:
    """Fold ``bn``'s inference affine map into ``prod`` (a Conv2D or
    Linear, whose out channel is its weight's last axis) in place: the
    scale and bias in float64, stored as float32."""
    with torch.no_grad():
        mean = bn.running_mean.double()
        var = bn.running_var.double()
        if bn.affine:
            gamma, beta = bn.weight.double(), bn.bias.double()
        else:
            gamma, beta = torch.ones_like(mean), torch.zeros_like(mean)
        scale = gamma / torch.sqrt(var + bn.eps)
        prod.weight.copy_((prod.weight.double() * scale).float())
        old_bias = prod.bias.double() if prod.bias is not None else 0.0
        new_bias = ((old_bias - mean) * scale + beta).float()
        if prod.bias is None:
            prod.bias = nn.Parameter(new_bias)
            prod.with_bias = True
        else:
            prod.bias.copy_(new_bias)


def _fuse_pass(nodes: List[IRNode], outputs: List[IRNode]):
    """The "fused" rewrites on copied nodes (``_copy_graph``)."""
    # 1. drop inference no-ops by rewiring their consumers
    drop = {n.uid: n.parents[0] for n in nodes
            if isinstance(n.layer, (Dropout, Identity))
            and len(n.parents) == 1}

    def resolve(p: IRNode) -> IRNode:
        while p.uid in drop:
            p = drop[p.uid]
        return p

    for n in nodes:
        n.parents = [resolve(p) for p in n.parents]
    outputs = [resolve(o) for o in outputs]
    nodes = [n for n in nodes if n.uid not in drop]

    # 2. fold a BatchNorm into the single-consumer Conv2D / Linear before it
    counts = _consumer_counts(nodes)
    out_ids = {o.uid for o in outputs}
    uses: Dict[int, int] = {}
    for n in nodes:
        uses[id(n.layer)] = uses.get(id(n.layer), 0) + 1
    folded: Dict[int, IRNode] = {}   # BN node uid -> its producer
    for n in nodes:
        if not isinstance(n.layer, BatchNorm) or len(n.parents) != 1:
            continue
        prod = n.parents[0]
        # exact types only: a subclass may compute otherwise
        if type(prod.layer) not in (Conv2D, Linear):
            continue
        if counts.get(prod.uid, 0) != 1 or prod.uid in out_ids:
            continue
        if uses[id(prod.layer)] != 1 or uses[id(n.layer)] != 1:
            continue
        _fold_bn(prod.layer, n.layer)
        folded[n.uid] = prod
    if folded:
        for n in nodes:
            n.parents = [folded.get(p.uid, p) for p in n.parents]
        outputs = [folded.get(o.uid, o) for o in outputs]
        nodes = [n for n in nodes if n.uid not in folded]

    # 3. LayerNorm -> the kernel's twin
    twins: Dict[int, FusedLayerNorm] = {}
    for n in nodes:
        if type(n.layer) is LayerNorm:
            if id(n.layer) not in twins:
                twins[id(n.layer)] = FusedLayerNorm.from_layernorm(n.layer)
            n.layer = twins[id(n.layer)]
    return nodes, outputs


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------


def _emit(ir_inputs: List[IRNode], nodes: List[IRNode],
          ir_outputs: List[IRNode]):
    from bigdl_tpu_torch.keras.engine import Input, Model, Node

    sym = {}
    k_inputs = []
    for ir in ir_inputs:
        sym[ir.uid] = Input(None)
        k_inputs.append(sym[ir.uid])
    for ir in nodes:
        if not ir.is_input:
            sym[ir.uid] = Node(ir.layer, [sym[p.uid] for p in ir.parents])
    return Model(k_inputs, [sym[o.uid] for o in ir_outputs], name="IRModel")
