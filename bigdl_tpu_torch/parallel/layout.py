"""Declarative sharding layouts — the port of ``bigdl_tpu.parallel.layout``:
canonical partition specs over a named ``(data, fsdp, tp, seq)`` mesh.

One frozen :class:`SpecLayout` names the mesh axes and one
:class:`ModelLayout` table per model family maps every parameter path to
a spec, as in the JAX package.  There ``jax.jit`` and ``NamedSharding``
place the collectives; here each spec becomes DTensor placements on a
``torch.distributed`` ``DeviceMesh`` (:func:`spec_to_placements`) and
DTensor's sharding propagation places them (``parallel.gspmd``).

:class:`P` is the port's own partition spec: a tuple of axis names,
tuples of names or None, printed as JAX prints ``PartitionSpec``, so the
tables, the tests and the reports read the same in both packages.  A
parameter's path is its JAX tree path (``utils.convert.jax_path`` of the
module's dotted name, joined by ``/``: ``dec0/attn/wq``), so the port's
names hit the same rules and the reports key the same paths.

Axis semantics (the JAX package's):

- ``data`` — pure data parallelism: batch sharded, params replicated,
  gradients all-reduced.
- ``fsdp`` — data parallelism with the parameters and optimizer state
  sharded too (the arXiv 2004.13336 weight-update sharding).
- ``tp`` — Megatron tensor parallelism: column-split in-projections,
  row-split out-projections, one activation all-reduce a pair.
- ``seq`` — the sequence dimension of activations and batches.

A parameter that matches no rule (or whose matching rules are all
rank-rejected) is replicated, visibly: :meth:`LayoutAudit.export` sets
the ``parallel.layout.replicated_params`` gauge and logs one line
listing the paths (the JAX package's flight-recorder line is a log line
here until the flight recorder is ported, ROADMAP A.6.7)."""

import logging
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.utils.convert import jax_path

log = logging.getLogger("bigdl_tpu_torch.parallel.layout")

# canonical axis names of the layout mesh (mesh_policy builds it)
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SEQ = "seq"
LAYOUT_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TP, AXIS_SEQ)

# the audit's log line lists at most this many paths
_AUDIT_LIST_CAP = 32


class P(tuple):
    """A partition spec: entry ``d`` names the mesh axis (a string), the
    axes (a tuple, major to minor) or nothing (None) that split tensor
    dim ``d``.  Equal to the tuple of its entries."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "PartitionSpec" + repr(tuple(self))


def _ps(*dims) -> P:
    """A spec from entries whose names may be None (an axis the layout
    does not have): Nones inside tuples are dropped, single-name tuples
    collapse to the bare name and empty entries become None, so a layout
    with ``fsdp=None`` gives exactly the legacy 2-axis specs and a matrix
    rule's spec stays rank 2."""
    out = []
    for d in dims:
        if isinstance(d, tuple):
            names = tuple(n for n in d if n is not None)
            out.append(None if not names else
                       names[0] if len(names) == 1 else names)
        else:
            out.append(d)
    return P(*out)


@dataclass(frozen=True)
class SpecLayout:
    """Canonical specs over the named layout mesh.  Fields are the mesh
    axis names (None: the layout has no such axis and its entries vanish
    from every spec)."""

    data: Optional[str] = AXIS_DATA
    fsdp: Optional[str] = AXIS_FSDP
    tp: Optional[str] = AXIS_TP
    seq: Optional[str] = AXIS_SEQ

    def batch_axes(self) -> Tuple[str, ...]:
        """The axes the batch dim splits over: ``data`` and ``fsdp``."""
        return tuple(a for a in (self.data, self.fsdp) if a is not None)

    def batch_spec(self, ndim: int = 2) -> P:
        """Inputs and targets: dim 0 over the data axes, dim 1 over
        ``seq`` for leaves of rank >= 2."""
        if ndim >= 2:
            return _ps(self.batch_axes(), self.seq)
        return _ps(self.batch_axes())

    def activation_spec(self, ndim: int = 3) -> P:
        if ndim >= 3:
            return _ps(self.batch_axes(), self.seq, None)
        return self.batch_spec(ndim)

    def vocab_embedding(self) -> P:
        """(vocab, d) tables: vocab rows over fsdp x tp."""
        return _ps((self.fsdp, self.tp), None)

    def hidden_in(self) -> P:
        """Column-parallel kernels (wq/wk/wv, ffn-up)."""
        return _ps(self.fsdp, self.tp)

    def hidden_out(self) -> P:
        """Row-parallel kernels (wo, ffn-down)."""
        return _ps(self.tp, self.fsdp)

    def tower_kernel(self) -> P:
        """Two-tower MLP kernels: output columns over tp x fsdp, the
        contraction dim unsharded (the JAX package's reasons)."""
        return _ps(None, (self.tp, self.fsdp))

    def tower_bias(self) -> P:
        return _ps((self.tp, self.fsdp))

    def col_bias(self) -> P:
        return _ps(self.tp)

    def row_bias(self) -> P:
        return _ps(self.fsdp)

    def norm(self) -> P:
        return _ps(self.fsdp)

    def replicated(self) -> P:
        return P()


# the legacy 2-axis (data x model) layout
LEGACY_SPEC_LAYOUT = SpecLayout(data="data", fsdp=None, tp="model",
                                seq=None)


@dataclass(frozen=True)
class LayoutRule:
    """Paths matching ``pattern`` get ``build(layout)``; a spec longer
    than the leaf's rank is rejected and the search goes on.  ``ndim``
    pins a rule to leaves of exactly that rank."""

    name: str
    pattern: str
    build: Callable[[SpecLayout], P]
    ndim: Optional[int] = None


def _r(name: str, pattern: str, build, ndim: Optional[int] = None
       ) -> LayoutRule:
    return LayoutRule(name, pattern, build, ndim)


TRANSFORMER_RULES: Tuple[LayoutRule, ...] = (
    _r("vocab_embedding",
       r"(^|/)(embedding|emb/weight|lookuptable[^/]*/weight|"
       r"embedding[^/]*/weight)$",
       lambda l: l.vocab_embedding()),
    _r("attn_qkv", r"(^|/)(wq|wk|wv)$", lambda l: l.hidden_in()),
    _r("attn_qkv_bias", r"(^|/)(bq|bk|bv)$", lambda l: l.col_bias()),
    _r("attn_out", r"(^|/)wo$", lambda l: l.hidden_out()),
    _r("attn_out_bias", r"(^|/)bo$", lambda l: l.row_bias()),
    _r("ffn_up", r"(^|/)(w1|ffn/l1/weight)$", lambda l: l.hidden_in()),
    _r("ffn_up_bias", r"(^|/)(b1|ffn/l1/bias)$", lambda l: l.col_bias()),
    _r("ffn_down", r"(^|/)(w2|ffn/l2/weight)$", lambda l: l.hidden_out()),
    _r("ffn_down_bias", r"(^|/)(b2|ffn/l2/bias)$",
       lambda l: l.row_bias()),
    _r("norm",
       r"(^|/)(ln\d*|ln_out|ln_f|norm\d*|layernorm[^/]*|rmsnorm[^/]*)"
       r"/(weight|bias)$",
       lambda l: l.norm()),
)

TWO_TOWER_RULES: Tuple[LayoutRule, ...] = (
    _r("tower_embedding", r"(^|/)(user_emb|item_emb)$",
       lambda l: l.vocab_embedding()),
    _r("tower_kernel", r"(^|/)[ui]w\d+$", lambda l: l.tower_kernel()),
    _r("tower_bias", r"(^|/)[ui]b\d+$", lambda l: l.tower_bias()),
    _r("tower_out", r"(^|/)[ui]w_out$", lambda l: l.hidden_out()),
)

GENERIC_RULES: Tuple[LayoutRule, ...] = (
    _r("linear_kernel", r"(^|/)weight$",
       lambda l: l.hidden_in(), ndim=2),               # (in, out) only
    _r("conv_kernel_cout", r"(^|/)weight$",
       lambda l: _ps(None, None, l.fsdp, l.tp),
       ndim=4),                                        # (kh, kw, cin, cout)
)

# deliberately replicated paths: accounted "replicate", never flagged
GENERIC_REPLICATE: Tuple[str, ...] = (
    r"(^|/)bias$",
    r"(^|/)(gamma|beta|scale|offset)$",
    r"(^|/)(running_mean|running_var|moving_mean|moving_var)$",
)


def _rank() -> int:
    """This process's rank (0 alone): only rank 0 logs."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def path_str(path) -> str:
    """A parameter's path as the tables match it: a module's dotted name
    becomes its JAX tree path joined by ``/``; a tuple of keys is
    joined as it is."""
    if isinstance(path, str):
        return "/".join(jax_path(path))
    return "/".join(str(k) for k in path)


def _leaves(tree, prefix=()):
    """(path tuple, leaf) of a nested dict in sorted key order (the JAX
    tree order), or of a module's named parameters (its JAX paths)."""
    if hasattr(tree, "named_parameters"):
        for name, p in sorted(tree.named_parameters(),
                              key=lambda kv: jax_path(kv[0])):
            yield jax_path(name), p
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
        return
    yield prefix, tree


def _nest(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


@dataclass
class LayoutAudit:
    """What a table did to one parameter tree: the sharded paths, the
    deliberately replicated ones and the silent fallbacks."""

    model: str
    sharded: Dict[str, Tuple] = field(default_factory=dict)
    allowlisted: List[str] = field(default_factory=list)
    fallback_replicated: List[str] = field(default_factory=list)
    fallback_elems: int = 0

    def export(self, metrics=None) -> "LayoutAudit":
        """The ``parallel.layout.replicated_params`` gauge (set even at
        0) and one warning line naming the fallback paths."""
        if metrics is None:
            from bigdl_tpu_torch.optim.metrics import global_metrics

            metrics = global_metrics()
        metrics.gauge("parallel.layout.replicated_params",
                      float(len(self.fallback_replicated)))
        if self.fallback_replicated and _rank() == 0:
            listed = self.fallback_replicated[:_AUDIT_LIST_CAP]
            extra = len(self.fallback_replicated) - len(listed)
            suffix = f" (+{extra} more)" if extra > 0 else ""
            log.warning(
                "layout_replicated_params: layout %r replicates %d "
                "parameter(s) (%s elements) that matched no rule: %s%s — "
                "add a table rule or an explicit replicate-allowlist entry",
                self.model, len(self.fallback_replicated),
                f"{self.fallback_elems:,}", ", ".join(listed), suffix)
        return self


class ModelLayout:
    """A per-model table: ordered rules and an explicit replicate
    allowlist, resolved against one :class:`SpecLayout`."""

    def __init__(self, spec_layout: SpecLayout,
                 rules: Sequence[LayoutRule] = TRANSFORMER_RULES,
                 replicate: Sequence[str] = GENERIC_REPLICATE,
                 name: str = "transformer"):
        self.spec_layout = spec_layout
        self.rules = tuple(rules)
        self.replicate = tuple(replicate)
        self.name = name

    def spec_for(self, path: str, ndim: int) -> Tuple[P, Optional[str]]:
        """(spec, kind) for one path: ``kind`` is the matching rule's
        name, ``"replicate"`` for an allowlisted path, or None for the
        silent fallback."""
        for rule in self.rules:
            if rule.ndim is not None and rule.ndim != ndim:
                continue
            if re.search(rule.pattern, path):
                s = rule.build(self.spec_layout)
                if len(s) <= ndim:
                    return s, rule.name
        for pat in self.replicate:
            if re.search(pat, path):
                return P(), "replicate"
        return P(), None

    def param_specs(self, params) -> Dict[str, Any]:
        """The specs of a JAX-keyed tree (nested dicts of anything with a
        shape), or of a module's parameters, as a nested dict."""
        return _nest((p, self.spec_for(path_str(p), len(_shape(x)))[0])
                     for p, x in _leaves(params))

    def audit(self, params) -> LayoutAudit:
        """Classify every leaf; ``.export()`` the result for the gauge
        and the log line."""
        audit = LayoutAudit(model=self.name)
        for p, leaf in _leaves(params):
            path = path_str(p)
            shape = _shape(leaf)
            spec, kind = self.spec_for(path, len(shape))
            if kind is None:
                audit.fallback_replicated.append(path)
                audit.fallback_elems += int(np.prod(shape)) if shape else 1
            elif kind == "replicate" or not any(a is not None
                                                for a in spec):
                audit.allowlisted.append(path)
            else:
                audit.sharded[path] = (tuple(shape), tuple(spec))
        return audit


def transformer_layout(spec_layout: SpecLayout) -> ModelLayout:
    """The transformer family: the LM, the translation Transformer and
    keras graphs built from the attention blocks."""
    return ModelLayout(spec_layout, rules=TRANSFORMER_RULES + GENERIC_RULES,
                       name="transformer")


def two_tower_layout(spec_layout: SpecLayout) -> ModelLayout:
    return ModelLayout(spec_layout,
                       rules=TWO_TOWER_RULES + TRANSFORMER_RULES
                       + GENERIC_RULES,
                       name="two_tower")


def generic_layout(spec_layout: SpecLayout) -> ModelLayout:
    return ModelLayout(spec_layout, rules=TRANSFORMER_RULES + GENERIC_RULES,
                       name="generic")


# model class name -> table builder; register_layout extends it
_MODEL_TABLES: Dict[str, Callable[[SpecLayout], ModelLayout]] = {
    "Transformer": transformer_layout,
    "TransformerLayer": transformer_layout,
    "TransformerDecoderLayer": transformer_layout,
    "TwoTower": two_tower_layout,
    "NeuralCF": two_tower_layout,
}


def register_layout(model_cls_name: str,
                    table: Callable[[SpecLayout], ModelLayout]) -> None:
    """A table builder ``table(spec_layout) -> ModelLayout`` for a model
    family, by class name."""
    _MODEL_TABLES[model_cls_name] = table


def layout_for_model(model, spec_layout: SpecLayout) -> ModelLayout:
    """The model's own class first, then the first registered family
    among its sub-modules, else the generic table."""
    cls = type(model).__name__
    if cls in _MODEL_TABLES:
        return _MODEL_TABLES[cls](spec_layout)
    for m in getattr(model, "modules", lambda: ())():
        name = type(m).__name__
        if name in _MODEL_TABLES:
            return _MODEL_TABLES[name](spec_layout)
    return generic_layout(spec_layout)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (its dim names) or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_to_placements(spec, mesh, shape: Optional[Sequence[int]] = None):
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    dim names): for each mesh dim, ``Shard(d)`` where tensor dim ``d``
    names it, else ``Replicate()``.  Axes the mesh lacks are dropped (the
    live mesh leaves out a size-1 axis the policy does not name).  DTensor splits a dim named by several
    mesh dims in mesh-dim order, major to minor, so a spec that names
    them in another order is refused, and so is such a dim that their
    sizes' product does not divide (``shape`` given): ``torch.chunk``
    nested per axis would then cut other bounds than JAX's one padded
    split."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = _axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(tuple(spec)):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a is not None and a in sizes]
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec!r}: dim {d} names {tuple(axes)}, but DTensor "
                f"splits a dim in mesh order {tuple(names)}")
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if len(axes) > 1 and shape is not None and shape[d] % n:
            raise ValueError(
                f"spec {spec!r}: dim {d} of size {shape[d]} does not "
                f"divide into the {n} shards of {tuple(axes)}")
        for i in idx:
            out[i] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# the per-axis collective-bytes ledger (pure layout math)
# ---------------------------------------------------------------------------

def _spec_axes(spec) -> Tuple[str, ...]:
    names: List[str] = []
    for entry in tuple(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                names.append(a)
    return tuple(names)


def _paired(params, specs):
    """(leaf, spec) pairs of a tree (or module) and its nested specs."""
    flat = dict(_leaves(specs)) if isinstance(specs, dict) else {}
    for p, leaf in _leaves(params):
        yield leaf, flat.get(p, P())


def collective_bytes_by_axis(params, specs, mesh,
                             dtype_bytes: int = 4) -> Dict[str, Any]:
    """Analytic per-step, per-axis collective bytes of a layout (the JAX
    ledger, its conventions and numbers): ``data`` all-reduces each
    parameter's gradient over the data axes it is not sharded on (2x
    its local shard bytes); ``fsdp`` gathers an fsdp-sharded parameter
    for the forward and the backward and reduce-scatters its gradient (3
    passes of ``elems (n - 1) / n``); ``tp`` moves activations
    (:func:`tp_activation_bytes`), 0 here.  ``mesh``: a ``DeviceMesh``
    with dim names, or ``{axis: size}``."""
    axes = _axis_sizes(mesh)
    data_axes = [a for a in (AXIS_DATA, "dcn_data") if axes.get(a, 1) > 1]
    fsdp_axis = AXIS_FSDP if axes.get(AXIS_FSDP, 1) > 1 else None
    per_axis = {a: 0.0 for a in LAYOUT_AXES}
    total_elems = 0.0
    shard_elems_total = 0.0
    for leaf, spec in _paired(params, specs):
        shape = _shape(leaf)
        elems = float(np.prod(shape)) if shape else 1.0
        names = _spec_axes(spec)
        div = 1.0
        for a in names:
            div *= axes.get(a, 1)
        shard = elems / max(div, 1.0)
        total_elems += elems
        shard_elems_total += shard
        n_rep = 1
        for a in data_axes + ([fsdp_axis] if fsdp_axis else []):
            if a not in names:
                n_rep *= axes.get(a, 1)
        if n_rep > 1:
            per_axis[AXIS_DATA] += 2.0 * shard * dtype_bytes
        if fsdp_axis and fsdp_axis in names:
            nf = axes[fsdp_axis]
            per_axis[AXIS_FSDP] += 3.0 * elems * (nf - 1) / nf \
                * dtype_bytes
    return {
        "per_axis_bytes_per_step": {a: per_axis[a] for a in LAYOUT_AXES},
        "param_elems": total_elems,
        "param_bytes_per_chip": shard_elems_total * dtype_bytes,
        "total_bytes_per_step": float(sum(per_axis.values())),
        "mesh": {k: int(v) for k, v in axes.items()},
    }


def tp_activation_bytes(batch: int, seq: int, d_model: int,
                        n_row_collectives: int, tp: int,
                        dtype_bytes: int = 4) -> float:
    """tp traffic: each row-parallel product's output all-reduce moves
    ``2 (tp - 1) / tp`` of the (batch, seq, d_model) activation, three
    times a step (forward and the backward's two)."""
    if tp <= 1:
        return 0.0
    one = 2.0 * (tp - 1) / tp * batch * seq * d_model * dtype_bytes
    return 3.0 * n_row_collectives * one


def embedding_lookup_bytes(batch: int, dim: int, sizes: Dict[str, int],
                           n_tables: int = 1,
                           dtype_bytes: int = 4) -> Dict[str, Any]:
    """Lookups against a vocab-sharded table: one ring all-gather of the
    gathered ``batch x dim`` block over each vocab-shard axis,
    ``(n - 1) / n`` of it a chip; 0 on an unsharded mesh."""
    per_axis: Dict[str, float] = {}
    block = float(batch) * float(dim) * float(dtype_bytes) * \
        float(n_tables)
    for axis in (AXIS_FSDP, AXIS_TP):
        n = int(sizes.get(axis, 1) or 1)
        per_axis[axis] = block * (n - 1) / n if n > 1 else 0.0
    return {
        "per_axis_bytes": per_axis,
        "total_bytes": float(sum(per_axis.values())),
        "rows": int(batch),
        "dim": int(dim),
    }
