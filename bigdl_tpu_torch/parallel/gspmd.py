"""Layout training over DeviceMesh and DTensor — the port of
``bigdl_tpu.parallel.gspmd``.

The JAX package gives every parameter a ``PartitionSpec``, jits the
plain train step with those shardings and lets the GSPMD partitioner
place the collectives.  Here every parameter becomes a DTensor on the
layout's mesh (``mesh_policy.place_module``), the batch a DTensor split
over the data axes, and the model's plain forward, the criterion and
autograd run on DTensors: DTensor's sharding propagation places the
collectives.  What has no sharding rule, or takes plain tensors (the
flash kernels), runs on the local shards through ``local_map``
(``parallel.local_ops``).  Each gradient is redistributed to its
parameter's placements before the update reads it (a ``Partial``
gradient of a parameter replicated over the data axes is all-reduced,
an fsdp-sharded one reduce-scattered), and the optimizer state is made
on the DTensor parameters, so fsdp's Adam moments are sharded.

One process drives one device: every rank runs the same loop on its
shards of the same global batches (where the JAX package drives every
device from one controller), returns the same losses and stats, and
only rank 0 logs.  Gathering a whole value (``get_variables``,
``predict``, the reports' losses) is a collective every rank calls."""

import logging
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.parallel import local_ops
from bigdl_tpu_torch.parallel.layout import (
    AXIS_FSDP, LEGACY_SPEC_LAYOUT, ModelLayout, P, TRANSFORMER_RULES,
    _axis_sizes, _leaves, _nest, _paired, _shape, _spec_axes,
    collective_bytes_by_axis as _bytes_by_axis, path_str,
    spec_to_placements)
from bigdl_tpu_torch.parallel.mesh_policy import (ResolvedLayout,
                                                  mesh_and_layout,
                                                  place_module)
from bigdl_tpu_torch.runtime.mesh import AXIS_DATA, AXIS_DCN

log = logging.getLogger("bigdl_tpu_torch.parallel.gspmd")

# the legacy (data x model) transformer table of tp_spec_for_path: the
# family rules only, as in the JAX package
_LEGACY_TABLE = ModelLayout(LEGACY_SPEC_LAYOUT, rules=TRANSFORMER_RULES,
                            name="transformer-legacy")


def tp_spec_for_path(path: str, leaf) -> P:
    """The legacy (data, model) mesh's spec of one parameter path;
    replicated when no rule matches."""
    spec, _ = _LEGACY_TABLE.spec_for(path, len(_shape(leaf)))
    return spec


def build_param_specs(params, rule_fn=tp_spec_for_path) -> Dict[str, Any]:
    """``rule_fn``'s spec of every leaf of a JAX-keyed tree (or of a
    module's parameters), as a nested dict."""
    return _nest((p, rule_fn(path_str(p), leaf))
                 for p, leaf in _leaves(params))


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class GSPMDTrainStep:
    """The train step of a declarative layout over ``model``'s own
    parameters (``variables``, a JAX-keyed tree, loaded first when
    given), which it makes DTensors in place.

    ``layout=`` a :class:`~bigdl_tpu_torch.parallel.mesh_policy.
    ResolvedLayout` (or a :class:`~bigdl_tpu_torch.parallel.layout.
    ModelLayout` with an explicit ``DeviceMesh``): specs from the
    model's table over the named (data, fsdp, tp, seq) mesh; the batch
    splits over data x fsdp, and dim 1 over seq for leaves of rank >= 2.
    (The JAX class's legacy mode, an explicit (data, model) mesh with a
    ``rule_fn``, has no caller in the port.)

    The layout is audited at construction (``parallel.layout.
    LayoutAudit``).  A model with active dropout is handed each step's
    ``key`` (``fit_layout`` passes ``fold_in(PRNGKey(seed), i)``, the
    JAX driver's)."""

    def __init__(self, model, criterion, optim_method, mesh=None,
                 variables: Optional[Dict[str, Any]] = None,
                 remat: bool = False, layout=None):
        self.model = model
        self.criterion = criterion
        self.optim = optim_method
        self.remat = bool(remat)
        if isinstance(layout, ResolvedLayout):
            self._table = layout.table_for(model)
            mesh = mesh if mesh is not None else layout.dtensor_mesh
            self._sizes = _axis_sizes(layout.mesh)
            self._batch_prod = layout.n_batch_shards
        elif isinstance(layout, ModelLayout) and mesh is not None:
            self._table = layout
            self._sizes = _axis_sizes(mesh)
            self._batch_prod = int(np.prod(
                [self._sizes.get(a, 1)
                 for a in layout.spec_layout.batch_axes()]))
        else:
            raise ValueError("GSPMDTrainStep needs layout= a "
                             "ResolvedLayout, or a ModelLayout and a mesh")
        self.mesh = mesh
        self._spec_layout = self._table.spec_layout
        if variables is not None:
            from bigdl_tpu_torch.utils.convert import load_jax_variables

            load_jax_variables(model, variables)
        self.specs = self._table.param_specs(model)
        self.audit = self._table.audit(model).export()
        place_module(model, mesh, self._table.spec_for)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.device = self.params[0].to_local().device if self.params \
            else torch.device("cpu")
        # the optimizer's state made on the DTensor parameters: each slot
        # split as its parameter (fsdp's sharded moments)
        self.opt_state = self.optim.init_state(self.params)
        self.ema_flat = None   # the layout path keeps no EMA

    # ------------------------------------------------------------------
    def put_batch(self, a):
        """A host array (or tensor) as a DTensor split per the batch
        spec: each rank keeps its own rows of the global batch."""
        from torch.distributed.tensor import distribute_tensor

        t = torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(self.device)
        return distribute_tensor(
            t, self.mesh, spec_to_placements(
                self._spec_layout.batch_spec(t.ndim), self.mesh,
                tuple(t.shape)), src_data_rank=None)

    def _forward(self, xs, key):
        out = self.model(*xs) if key is None else self.model(*xs, key=key)
        return self._seq_whole(out)

    def _seq_whole(self, t):
        """``t`` with its seq split gathered: the criterion (a gather
        over flattened rows) has no sharding rule for a strided split."""
        names = self.mesh.mesh_dim_names
        if not local_ops.is_dtensor(t) or "seq" not in names:
            return t
        from torch.distributed.tensor import Replicate

        pl = list(t.placements)
        pl[names.index("seq")] = Replicate()
        return t.redistribute(self.mesh, pl)

    def gradients(self, key, x, y):
        """(loss, gradients): the loss of one forward and backward on
        the batch, and every trainable parameter's gradient as a
        DTensor placed as its parameter (each ``Partial`` reduced); the
        update is not made."""
        from torch.distributed.tensor.experimental import \
            implicit_replication

        xs = tuple(self.put_batch(a) for a in _as_tuple(x))
        yd = self.put_batch(y)
        self.model.train(True)
        for p in self.params:
            p.grad = None
        with implicit_replication():
            if self.remat:
                from torch.utils.checkpoint import checkpoint

                loss = checkpoint(
                    lambda *a: self.criterion(self._forward(a, key),
                                              self._seq_whole(yd)),
                    *xs, use_reentrant=False)
            else:
                loss = self.criterion(self._forward(xs, key),
                                      self._seq_whole(yd))
            loss.backward()
            grads = []
            for p in self.params:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if tuple(g.placements) != tuple(p.placements):
                    g = g.redistribute(p.device_mesh, p.placements)
                grads.append(g)
        return loss.detach(), grads

    def train_step(self, step: int, key, x, y) -> torch.Tensor:
        """Iteration ``step`` on the global batch (x, y): the forward,
        the backward, the reduced gradients and the update.  Returns the
        loss, the same 0-d tensor on every rank."""
        from torch.distributed.tensor.experimental import \
            implicit_replication

        loss, grads = self.gradients(key, x, y)
        scalars = self.optim.step_tensors(step, self.device)
        with torch.no_grad(), implicit_replication():
            self.optim.apply(scalars, grads, self.params, self.opt_state)
        return local_ops.replicated(loss)

    def get_params(self) -> Dict[str, Any]:
        """The whole parameters as a JAX-keyed tree of numpy arrays (a
        collective)."""
        return self.get_variables()["params"]

    @property
    def n_data_replicas(self) -> int:
        """The batch-dim multiple ``predict`` pads to (data x fsdp)."""
        return max(1, self._batch_prod)

    def get_variables(self, ema: bool = False) -> Dict[str, Any]:
        """``{"params", "state"}`` whole, as JAX-keyed numpy trees (a
        collective); no EMA on this path (``ema=True`` returns the
        parameters)."""
        from bigdl_tpu_torch.utils.convert import export_variables

        return export_variables(self.model)

    def set_variables(self, variables: Dict[str, Any]) -> None:
        """Install a loaded JAX-keyed tree, each leaf re-placed as its
        parameter."""
        from bigdl_tpu_torch.utils.convert import (jax_path,
                                                   load_jax_variables)

        params = variables["params"]
        want = {jax_path(n) for n, _ in self.model.named_parameters()}
        got = {p for p, _ in _leaves(params)}
        if got != want:
            raise ValueError("loaded params do not match the model's "
                             "parameter structure")
        load_jax_variables(self.model, variables)

    def predict_fn(self):
        """The inference callable: a host batch padded to the data-shard
        multiple, split over the data axes, the forward in eval mode and
        the whole output back as numpy (every rank calls it)."""
        from torch.distributed.tensor.experimental import \
            implicit_replication

        k = self.n_data_replicas

        def run(x):
            multi = isinstance(x, tuple)
            xs = tuple(np.asarray(a) for a in x) if multi \
                else (np.asarray(x),)
            n = xs[0].shape[0]
            pad = (-n) % k
            if pad:
                xs = tuple(np.concatenate(
                    [a, np.repeat(a[-1:], pad, 0)]) for a in xs)
            self.model.train(False)
            with torch.no_grad(), implicit_replication():
                out = self.model(*(self.put_batch(a) for a in xs))
                out = local_ops.replicated(out)
            return out.cpu().numpy()[:n]

        return run

    def evaluate(self, methods, batches) -> list:
        """Every method over host batches (a ``drop_last=False`` plan),
        a padded last batch counting its real rows only."""
        from bigdl_tpu_torch.optim.validation import StatsAccumulator

        if not methods:
            return []
        run = self.predict_fn()
        acc = StatsAccumulator()
        for mb in batches:
            x, y = mb["input"], mb["target"]
            w = mb.get("weight")
            n = int(np.sum(w)) if w is not None else len(y)
            xs = tuple(a[:n] for a in _as_tuple(x))
            out = torch.from_numpy(run(xs if len(xs) > 1 else xs[0]))
            acc.add([m.batch_stats(out, torch.as_tensor(np.asarray(y[:n])))
                     for m in methods])
        totals = acc.fetch() or []
        return [m.fold(s, c) for m, (s, c) in zip(methods, totals)]

    # ------------------------------------------------------------------
    def shard_report(self) -> Dict[str, Tuple]:
        """path -> (global shape, spec) of every split parameter."""
        shapes = {path_str(p): tuple(leaf.shape)
                  for p, leaf in _leaves(self.model)}
        return {path_str(p): (shapes[path_str(p)], tuple(spec))
                for p, spec in _leaves(self.specs)
                if any(a is not None for a in spec)}

    def collective_bytes_report(self, grad_dtype_bytes: int = 4
                                ) -> Dict[str, float]:
        """The gradient-sync byte estimate of the layout (the ZeRO-1
        path's convention)."""
        return collective_bytes_for_specs(self.model, self.specs,
                                          self._sizes,
                                          grad_dtype_bytes=grad_dtype_bytes)

    def collective_bytes_by_axis(self, dtype_bytes: int = 4
                                 ) -> Dict[str, Any]:
        """The per-axis ledger of this step's layout."""
        return _bytes_by_axis(self.model, self.specs, self._sizes,
                              dtype_bytes=dtype_bytes)


def collective_bytes_for_specs(params, specs, mesh,
                               grad_dtype_bytes: int = 4
                               ) -> Dict[str, float]:
    """Per-step gradient all-reduce bytes from the specs: a leaf's local
    shard is ``prod(shape) / prod(split axis sizes)`` elements and the
    data-parallel sync moves about twice its bytes; the data-parallel
    degree counts data, dcn_data and fsdp.  ``mesh``: a ``DeviceMesh``
    with dim names or ``{axis: size}``."""
    axes = _axis_sizes(mesh)
    n_data = (axes.get(AXIS_DATA, 1) * axes.get(AXIS_DCN, 1)
              * axes.get(AXIS_FSDP, 1))
    total_shard_elems = 0.0
    total_elems = 0.0
    for leaf, spec in _paired(params, specs):
        shape = _shape(leaf)
        elems = float(np.prod(shape)) if shape else 1.0
        div = 1.0
        for a in _spec_axes(spec):
            div *= axes.get(a, 1)
        total_elems += elems
        total_shard_elems += elems / max(div, 1.0)
    sync_bytes = (2.0 * total_shard_elems * grad_dtype_bytes
                  if n_data > 1 else 0.0)
    return {
        "dp_allreduce_bytes_per_step": sync_bytes,
        "grad_shard_bytes": total_shard_elems * grad_dtype_bytes,
        "param_elems": total_elems,
        "n_data_replicas": float(n_data),
    }


# ---------------------------------------------------------------------------
# the parallelism= fit driver (Estimator / keras / forecasters)
# ---------------------------------------------------------------------------

def _has_dropout(model) -> bool:
    from bigdl_tpu_torch.nn.layers import Dropout

    return any(isinstance(m, Dropout) and m.p > 0.0
               for m in model.modules())


def fit_layout(model, criterion, optim_method, dataset, *,
               parallelism, batch_size: int, epochs: int = 1,
               seed: int = 42, log_every: int = 10, metrics=None,
               device=None):
    """Train ``model`` (from its own weights) under a declarative
    ``parallelism=`` policy on ``device`` (None is ``cuda``) and return
    ``(TrainedModel, stats)``: the driver behind the Estimator, keras
    and forecaster ``parallelism=`` key.  Every rank of the world calls
    it.  Batches are keyed by (seed, epoch) as the classic driver keys
    them, so two policies from one seed see the same data order; step
    ``i``'s dropout key is ``fold_in(PRNGKey(seed), i)``."""
    from bigdl_tpu_torch.nn.layers import has_lazy
    from bigdl_tpu_torch.ops.common import resolve_device
    from bigdl_tpu_torch.optim.optimizer import TrainedModel
    from bigdl_tpu_torch.optim.train_step import to_device
    from bigdl_tpu_torch.utils import prng

    dev = resolve_device(device)
    resolved = mesh_and_layout(parallelism, dev)
    rank0 = torch.distributed.get_rank() == 0
    if rank0:
        log.info("parallelism %s over %d devices", resolved.describe(),
                 int(np.prod(list(resolved.sizes.values()))))
    if batch_size % resolved.n_batch_shards != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the "
            f"{resolved.n_batch_shards} batch shards of parallelism "
            f"{parallelism!r} (data x fsdp = "
            f"{resolved.sizes.get('data', 1)} x "
            f"{resolved.sizes.get('fsdp', 1)})")
    sample = next(iter(dataset.batches(batch_size, shuffle=False)), None)
    if sample is None:
        raise ValueError(
            f"dataset yields no batch of size {batch_size} "
            f"({dataset.size()} samples, drop_last) — shrink batch_size")
    model = model.to(dev)
    if has_lazy(model):
        with torch.no_grad():
            model.train(False)
            model(*(to_device(a[:1], dev) for a in _as_tuple(
                sample["input"])))
    step = GSPMDTrainStep(model, criterion, optim_method, layout=resolved)

    if metrics is None:
        from bigdl_tpu_torch.optim.metrics import global_metrics

        metrics = global_metrics()
    ledger = step.collective_bytes_by_axis()
    for axis, b in ledger["per_axis_bytes_per_step"].items():
        metrics.gauge(f"parallel.layout.{axis}_bytes_per_step", float(b))
    metrics.gauge("parallel.layout.param_bytes_per_chip",
                  float(ledger["param_bytes_per_chip"]))

    base = prng.PRNGKey(seed, device=dev) if _has_dropout(model) else None
    t0 = time.time()
    it = 0
    losses = []
    for epoch in range(epochs):
        for mb in dataset.batches(batch_size, shuffle=True, seed=seed,
                                  epoch=epoch):
            key = None if base is None else prng.fold_in(base, it)
            loss = step.train_step(it, key, mb["input"], mb["target"])
            losses.append(float(loss))
            if rank0 and log_every and it % log_every == 0:
                log.info("[layout %s] epoch %d iter %d loss %.4f",
                         resolved.parallelism, epoch + 1, it, losses[-1])
            it += 1
    model.train(False)
    trained = TrainedModel(model, dev, step, losses)
    stats = {
        "train_time_s": time.time() - t0,
        "epochs": epochs,
        "num_samples": dataset.size(),
        "iterations": it,
        "parallelism": resolved.parallelism,
        "mesh": dict(resolved.sizes),
        "losses": losses,
        "replicated_params": len(step.audit.fallback_replicated),
        "collective_bytes_by_axis": ledger["per_axis_bytes_per_step"],
        "param_bytes_per_chip": ledger["param_bytes_per_chip"],
    }
    return trained, stats
