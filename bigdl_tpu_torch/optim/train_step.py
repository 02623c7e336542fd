"""The train step — the port of
``bigdl_tpu.optim.train_step.ShardedParameterStep``: ``TrainStep`` on one
process, ``ShardedParameterStep`` (below) across the processes of a
``runtime.mesh.Mesh``, the ZeRO-1 cycle.

One step is the forward in training mode, the criterion, autograd's
backward, the trainable mask, optional gradient clipping (constant,
then global L2 norm, as the JAX step clips; a layer-wise method such as
``LarsSGD`` gets only the norm clip, as on the JAX replicated path), the
optimizer's in-place update, and the EMA of the parameters.  With one
rank the JAX step's reduce-scatter / all-gather cycle is the identity,
so ``TrainStep`` has nothing of it.

- ``accum_steps``: the batch is cut into that many contiguous
  microbatches; BatchNorm buffers move through them in order, the
  gradients (summed in float32 by autograd) and the loss are divided by
  ``accum_steps``, and clipping and the update follow once.
- ``ema_decay``: after the update ``ema = d * ema + (1 - d) * params``,
  from a copy of the initial parameters.
- ``remat``: ``torch.utils.checkpoint`` over each top-level child of a
  ``Sequential`` (the whole forward otherwise); ``remat_policy="dots"``
  keeps the conv and matmul outputs and recomputes the rest.  The
  recompute runs each child again in training mode, so each BatchNorm
  is handed the running mean its first run shifted by and leaves its
  running buffers alone: they move once a step and the recompute
  normalizes as the first run did, as without remat.
- ``trainable_mask``: a JAX-keyed bool tree of the parameters (a bool
  or an array a leaf); frozen gradients are zeroed before clipping and
  frozen entries are put back bit for bit after the update.

Clipping, the update and the EMA run in the profiler range
``train_step/update``, so a trace can tell the optimizer's share of a
step.

Dropout is seeded as the JAX Optimizer seeds it: the run's key is
``PRNGKey(seed + 1)``, step ``i`` draws from ``fold_in(key, i)``, the one
data replica from ``fold_in(step_key, 0)`` — the key the JAX step hands
to the forward of its replica 0 — and microbatch ``k`` from
``fold_in(replica_key, k)``.

Everything a step reads that depends on its index lives in device
tensors written before it runs: the step counter the dropout key folds
in, and the optim method's rate and bias corrections
(``OptimMethod.step_tensors``).  So the step itself reads nothing from
the host, and ``train_bundle`` can replay it as a CUDA graph.

Step bundles (``train_bundle``, the JAX ``train_bundle_device``): K
consecutive steps with one loss vector back.  On the card the bundle
replays a captured CUDA graph of ONE step K times, one graph per batch
signature (shapes and dtypes): a full batch and an epoch's ragged tail
get one each, in private memory pools, and one step's activations stay
in memory whatever K.  (The JAX package compiles one program per bundle
size instead, ``tests/test_step_bundle.py``; replaying one step keeps
memory flat and needs no program per size.)  Before each replay the host
writes the step's scalars and copies the batch into the graph's static
inputs on the step's stream, which already waits on the device feed's
copy, then replays; the launch counts the capture recorded are credited
at each replay (``ops.common.captured_launches``).  The first
``WARM_STEPS`` steps of a new signature are the run's own steps run
eagerly on a side stream (cuBLAS and cuDNN set themselves up there),
then one step is captured (a capture runs nothing) and replayed: no
step runs twice.  A step that cannot be captured (one that reads the
card on the host: ``.item()``, ``.cpu()``, ``bool`` of a tensor) raises
at the capture, with the offending call named; it never falls back to
eager steps.  A graph replays the products it captured, so the compute
dtype (``tensor.policy``) is pinned at the first capture: a later bundle
in another dtype raises.  On the CPU there are no graphs: the bundle
runs the same step K times, the plain version of the graph."""

import functools
import warnings
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from bigdl_tpu_torch.nn.layers import BatchNorm, Dropout
from bigdl_tpu_torch.nn.module import Module, Sequential, _as_tuple
from bigdl_tpu_torch.ops.common import (captured_launches, credit_launches,
                                        round_up)
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.validation import (StatsAccumulator,
                                              ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.tensor.policy import get_compute_dtype
from bigdl_tpu_torch.utils import prng
from bigdl_tpu_torch.utils.convert import (flat_order, jax_path, nest,
                                           ravel, unravel_into)


@dataclass
class GradientClipping:
    """Constant clipping to [constant_min, constant_max] (either may be
    None) and clipping of the global L2 norm to ``l2_norm``."""

    constant_min: Optional[float] = None
    constant_max: Optional[float] = None
    l2_norm: Optional[float] = None


@torch.no_grad()
def clip_gradients(grads: List[torch.Tensor], clip: GradientClipping,
                   constant: bool = True) -> None:
    """Clip ``grads`` in place: constant first (unless ``constant`` is
    False), then the global norm scaled by min(1, l2_norm / (norm +
    1e-12))."""
    if constant and (clip.constant_min is not None
                     or clip.constant_max is not None):
        for g in grads:
            g.clamp_(clip.constant_min, clip.constant_max)
    if clip.l2_norm is not None:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(clip.l2_norm / (norm + 1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host batch as a new tensor on ``device`` (never a view of the
    host buffer).  float64 becomes float32, as JAX without x64 does."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if device.type == "cuda":
        # a pinned copy, so the upload can overlap the running step
        return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
    return torch.tensor(a, device=device)


_DOTS = None


def _dots_policy():
    """The selective-checkpoint context of ``remat_policy="dots"``: conv
    and matmul outputs are saved, everything else recomputed."""
    global _DOTS
    if _DOTS is None:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)

        aten = torch.ops.aten
        saved = {aten.convolution.default, aten.mm.default,
                 aten.addmm.default, aten.bmm.default}
        # bfloat16 products with a float32 result (tensor.policy)
        saved |= {op.dtype for op in (aten.mm, aten.bmm)
                  if hasattr(op, "dtype")}

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        _DOTS = functools.partial(create_selective_checkpoint_contexts,
                                  policy)
    return _DOTS


def _remat_call(module: torch.nn.Module, fn, xs, policy):
    """``fn(*xs)``, the forward of ``module``, under activation
    checkpointing.  For the recompute each BatchNorm of ``module`` gets
    the running mean its first run shifted by (``replay_shift``), so it
    normalizes as that run did and leaves its running buffers alone."""
    from torch.utils.checkpoint import checkpoint

    bns = [m for m in module.modules()
           if isinstance(m, BatchNorm) and m.training]
    shifts = [m.running_mean.clone() for m in bns]
    runs = [0]

    def run(*args):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*args)
        for m, s in zip(bns, shifts):
            m.replay_shift = s
        try:
            return fn(*args)
        finally:
            for m in bns:
                m.replay_shift = None

    kw = {"context_fn": _dots_policy()} if policy == "dots" else {}
    return checkpoint(run, *xs, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _leaf_mask(tree, path):
    node = tree
    for part in path:
        if not isinstance(node, dict):
            break
        if part not in node:
            raise ValueError(f"trainable_mask has no {'/'.join(path)}")
        node = node[part]
    return node


@torch.no_grad()
def evaluate(model: torch.nn.Module, methods: Sequence[ValidationMethod],
             batches: Iterable, device: torch.device, group=None
             ) -> List[ValidationResult]:
    """Every method over host ``batches`` (a ``drop_last=False`` plan),
    ``model`` in eval mode; a padded last batch counts its real rows
    only.  The sums stay on the device until the end (the JAX
    ``_build_eval``); with a process ``group`` each rank passes its own
    plan and the sums are added over the ranks (every rank calls it)."""
    model.train(False)
    acc = StatsAccumulator()
    for mb in batches:
        x, y = mb["input"], mb["target"]
        w = mb.get("weight")
        n = int(np.sum(w)) if w is not None else len(y)
        xs = tuple(to_device(a[:n], device) for a in _as_tuple(x))
        out = model(*xs)
        yd = to_device(y[:n], device)
        acc.add([m.batch_stats(out, yd) for m in methods])
    if group is not None:
        flat = (torch.stack([t for pair in acc.totals for t in pair])
                if acc.totals is not None
                else torch.zeros(2 * len(methods), device=device))
        dist.all_reduce(flat, group=group)
        acc.totals = [(flat[2 * i], flat[2 * i + 1])
                      for i in range(len(methods))]
    totals = acc.fetch() or []
    return [m.fold(s, c) for m, (s, c) in zip(methods, totals)]


class TrainStep:
    """Trains ``model``'s parameters in place.  ``step(it, x, y)`` runs
    iteration ``it`` (0-based) on a batch already on the model's device
    and returns the loss as a 0-d tensor on that device (reading it
    waits for the step); ``train_bundle(it0, xs, ys)`` runs ``len(xs)``
    steps (captured CUDA graphs on the card).  A model with active
    dropout gets the step's key, derived from ``seed``, as
    ``model(x, key=key)``."""

    # eager steps of a new batch signature before its capture
    WARM_STEPS = 2

    def __init__(self, model: torch.nn.Module, criterion,
                 optim_method: OptimMethod,
                 clip: Optional[GradientClipping] = None, seed: int = 42,
                 accum_steps: int = 1, ema_decay: float = 0.0,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 trainable_mask: Optional[Dict[str, Any]] = None):
        if remat_policy not in (None, "nothing", "dots"):
            raise ValueError(f"remat_policy {remat_policy!r}: None | "
                             "'nothing' | 'dots'")
        self.model = model
        self.criterion = criterion
        self.optim_method = optim_method
        self.clip = clip
        self.accum_steps = max(1, int(accum_steps))
        self.ema_decay = float(ema_decay)
        self.remat = bool(remat)
        self.remat_policy = remat_policy
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self._order = flat_order(self.names)
        self.device = (self.params[0].device if self.params
                       else torch.device("cpu"))
        self.opt_state, self.ema = self._init_state()
        self.masks: Optional[List[Optional[torch.Tensor]]] = None
        if trainable_mask is not None:
            self.masks = []
            for n, p in named:
                m = torch.as_tensor(np.broadcast_to(np.asarray(
                    _leaf_mask(trainable_mask, jax_path(n)), bool),
                    tuple(p.shape)).copy(), device=p.device)
                self.masks.append(None if bool(m.all()) else m)
            if all(m is None for m in self.masks):
                self.masks = None
        self._base_key = None
        if any(isinstance(m, Dropout) and m.p > 0.0
               for m in model.modules()):
            self._base_key = prng.PRNGKey(seed + 1, device=self.device)
        # the index of the step being run, written before it runs
        self._step_t = torch.zeros((), dtype=torch.int64,
                                   device=self.device)
        # step bundles on the card: batch signature -> _Captured, and the
        # eager steps each signature has run so far
        self._graphs: Dict[tuple, "_Captured"] = {}
        # the compute dtype of the captured graphs (pinned at the first)
        self.graph_dtype: Optional[torch.dtype] = None
        self._warm: Counter = Counter()
        self._side: Optional[torch.cuda.Stream] = None

    def _init_state(self):
        """The optimizer's slots and the EMA (None without one)."""
        ema = ([p.detach().clone() for p in self.params]
               if self.ema_decay else None)
        return self.optim_method.init_state(self.params), ema

    def step_key(self, step) -> Optional[torch.Tensor]:
        """Replica 0's dropout key of iteration ``step`` (an int, or the
        int64 step tensor the step reads; None when the model drops
        nothing)."""
        if self._base_key is None:
            return None
        return prng.fold_in(prng.fold_in(self._base_key, step), 0)

    @property
    def graphs_captured(self) -> int:
        return len(self._graphs)

    def drop_graphs(self) -> None:
        """Forget every captured bundle (and the eager steps counted
        toward one): the model changed under them (a restored
        block-sparse pattern), so each batch shape is captured again."""
        self._graphs.clear()
        self._warm.clear()
        self.graph_dtype = None

    # ---- the step ----------------------------------------------------------
    def _forward(self, x, key):
        xs = _as_tuple(x)
        if not self.remat:
            if key is None:
                return self.model(*xs)
            return self.model(*xs, key=key)
        if isinstance(self.model, Sequential):
            for i, layer in enumerate(self.model.layers):
                fn = functools.partial(Module.call_child, layer, i, key=key)
                xs = _as_tuple(_remat_call(layer, fn, xs,
                                           self.remat_policy))
            return xs[0] if len(xs) == 1 else xs
        kw = {} if key is None else {"key": key}
        return _remat_call(self.model, functools.partial(self.model, **kw),
                           xs, self.remat_policy)

    def _loss(self, x, y, key) -> torch.Tensor:
        loss = self.criterion(self._forward(x, key), y)
        loss.backward()
        return loss.detach()

    def _set_step(self, step: int):
        """Write ``step``'s values into the device tensors the step
        reads; returns the optim method's."""
        self._step_t.fill_(step)
        return self.optim_method.step_tensors(step, self.device)

    def _run(self, x, y, scalars, want_gnorm: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One step on the values already written: everything a capture
        holds.  Returns the loss and, with ``want_gnorm``, the global L2
        norm of the (masked, averaged) gradient before clipping."""
        self.model.train(True)
        self._zero_grads()
        key = self.step_key(self._step_t)
        accum = self.accum_steps
        if accum == 1:
            loss = self._loss(x, y, key)
        else:
            xs, ys = _as_tuple(x), y
            if ys.shape[0] % accum:
                raise ValueError(f"batch of {ys.shape[0]} rows does not "
                                 f"split into {accum} microbatches")
            mb = ys.shape[0] // accum
            total = None
            for k in range(accum):
                part = tuple(a[k * mb:(k + 1) * mb] for a in xs)
                lk = self._loss(part if len(part) > 1 else part[0],
                                ys[k * mb:(k + 1) * mb],
                                None if key is None
                                else prng.fold_in(key, k))
                total = lk if total is None else total + lk
            loss = total / accum
        return loss, self._apply(scalars, accum, want_gnorm)

    def _zero_grads(self) -> None:
        for p in self.params:
            p.grad = None

    def __call__(self, step: int, x, y) -> torch.Tensor:
        return self._run(x, y, self._set_step(step))[0]

    @torch.no_grad()
    def _apply(self, scalars, accum: int, want_gnorm: bool
               ) -> Optional[torch.Tensor]:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if accum > 1:
            for g in grads:
                g.div_(accum)
        frozen = []
        if self.masks is not None:
            for g, p, m in zip(grads, self.params, self.masks):
                if m is not None:
                    g.mul_(m)
                    frozen.append((p, m, p.detach().clone()))
        gnorm = None
        if want_gnorm:
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        with record_function("train_step/update"):
            if self.clip is not None:
                clip_gradients(grads, self.clip,
                               constant=self.optim_method.elementwise)
            self.optim_method.apply(scalars, grads, self.params,
                                    self.opt_state)
            for p, m, old in frozen:
                p.copy_(torch.where(m, p, old))
            if self.ema is not None:
                d = self.ema_decay
                for e, p in zip(self.ema, self.params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        return gnorm

    # ---- step bundles ---------------------------------------------------------
    def train_bundle(self, step0: int, xs: Sequence, ys: Sequence
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Steps ``step0 .. step0 + len(xs) - 1`` on the device batches
        ``xs``/``ys``; returns the losses and the gradient norms as
        (K,) float32 vectors on the device, read by the caller when it
        needs them.  The same losses, to the bit, as K calls of the step
        (module docstring)."""
        k = len(xs)
        if k == 0 or len(ys) != k:
            raise ValueError(f"a bundle needs matching non-empty batch "
                             f"lists, got {k} inputs / {len(ys)} targets")
        losses = torch.empty(k, device=self.device)
        gnorms = torch.empty(k, device=self.device)
        for j, (x, y) in enumerate(zip(xs, ys)):
            scalars = self._set_step(step0 + j)
            if self.device.type != "cuda":
                loss, gnorm = self._run(x, y, scalars, want_gnorm=True)
            else:
                loss, gnorm = self._graph_step(x, y, scalars)
            losses[j] = loss
            gnorms[j] = gnorm
        return losses, gnorms

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _graph_step(self, x, y, scalars):
        """One step of a bundle on the card: eager on the side stream
        while the signature warms up, then captured once and replayed."""
        dt = get_compute_dtype(self.device)
        if self.graph_dtype is not None and dt != self.graph_dtype:
            raise RuntimeError(
                f"this step's CUDA graphs were captured in compute dtype "
                f"{self.graph_dtype} and a bundle runs in {dt}: train each "
                f"dtype with its own Optimizer")
        sig = tuple((tuple(t.shape), t.dtype) for t in _as_tuple(x) + (y,))
        entry = self._graphs.get(sig)
        if entry is None and self._warm[sig] < self.WARM_STEPS:
            self._warm[sig] += 1
            cur = torch.cuda.current_stream(self.device)
            side = self._side_stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                loss, gnorm = self._run(x, y, scalars, want_gnorm=True)
            cur.wait_stream(side)
            loss.record_stream(cur)
            gnorm.record_stream(cur)
            return loss, gnorm
        if entry is None:
            entry = self._graphs[sig] = self._capture(x, y, scalars)
            self.graph_dtype = dt
        for static, t in zip(entry.xs, _as_tuple(x)):
            static.copy_(t)
        entry.y.copy_(y)
        entry.graph.replay()
        credit_launches(entry.launches)
        return entry.loss, entry.gnorm

    def _capture(self, x, y, scalars) -> "_Captured":
        """Capture one step on static copies of ``x`` and ``y`` into a
        CUDA graph with its own memory pool.  A synchronizing call inside
        the step raises (``set_sync_debug_mode("error")``) before it
        reaches the card, so the capture ends cleanly and the error names
        the call; nothing runs eagerly in its place."""
        xs = tuple(t.clone() for t in _as_tuple(x))
        ys = y.clone()
        graph = torch.cuda.CUDAGraph()
        side = self._side_stream()
        side.wait_stream(torch.cuda.current_stream(self.device))
        mode = torch.cuda.get_sync_debug_mode()
        with captured_launches() as launches:
            try:
                # entering the capture synchronizes: the mode goes on
                # inside it
                with torch.cuda.graph(graph, stream=side):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        loss, gnorm = self._run(
                            xs if len(xs) > 1 else xs[0], ys, scalars,
                            want_gnorm=True)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
            except RuntimeError as e:
                raise RuntimeError(
                    f"steps_per_call > 1 runs each step as a captured CUDA "
                    f"graph, and a step of {type(self.model).__name__} "
                    f"cannot be captured: {e}.  A step that reads the card "
                    f"on the host (.item(), .cpu(), bool or float of a "
                    f"tensor, a Python scalar copied to the card) cannot "
                    f"be replayed; train it with steps_per_call=1") from e
        return _Captured(graph, xs, ys, loss, gnorm, launches)

    # ---- variables and checkpoints -------------------------------------------
    def get_variables(self, ema: bool = False) -> Dict[str, Any]:
        """``{"params", "state"}`` as the JAX package keys them, the
        params from the EMA when ``ema`` and the run keeps one."""
        src = self.ema if (ema and self.ema is not None) else self.params
        host = lambda t: t.detach().cpu().numpy().astype(np.float32)
        return {"params": nest(zip(self.names, src), host),
                "state": nest(self._buffers(), host)}

    def _ordered(self, tensors):
        return [tensors[i] for i in self._order]

    def _buffers(self):
        persistent = set(self.model.state_dict().keys())
        return [(n, b) for n, b in self.model.named_buffers()
                if n in persistent]

    def checkpoint_arrays(self, opt: bool = True) -> Dict[str, Any]:
        """The step's tensors as the host arrays of a checkpoint
        (``optim.checkpoint`` names them); ``opt=False`` leaves the
        optimizer state out (a sharded save writes ``opt_shard``)."""
        host = lambda t: t.detach().cpu().numpy()
        flat, ema = self._flat_vectors()
        out = {"flat_params": host(flat),
               "ema_flat": None if ema is None else host(ema),
               "model_state": {"/".join(jax_path(n)): host(b)
                               for n, b in self._buffers()}}
        if opt:
            out["opt_state"] = self._opt_arrays()
        return out

    def _flat_vectors(self):
        """The parameters and the EMA (or None) raveled."""
        return (ravel(self._ordered(self.params)),
                None if self.ema is None else ravel(self._ordered(self.ema)))

    def opt_shard(self) -> Tuple[Dict[str, np.ndarray], int,
                                 Dict[str, np.ndarray]]:
        """This process's part of an elementwise method's state, as a
        sharded checkpoint writes it: (each slot's vector, its offset in
        the flat vector, the tensor slots whole); one process holds it
        all, at offset 0."""
        arrays = self._opt_arrays()
        whole = {k: arrays[k] for k, v in self.opt_state.items()
                 if isinstance(v, torch.Tensor)}
        return ({k: a for k, a in arrays.items() if k not in whole}, 0,
                whole)

    def _opt_arrays(self) -> Dict[str, np.ndarray]:
        host = lambda t: t.detach().cpu().numpy()
        opt: Dict[str, np.ndarray] = {}
        for slot, val in self.opt_state.items():
            if isinstance(val, torch.Tensor):
                opt[slot] = host(val)
            elif self.optim_method.elementwise:
                opt[slot] = host(ravel(self._ordered(val)))
            else:
                for n, t in zip(self.names, val):
                    opt["/".join((slot,) + jax_path(n))] = host(t)
        return opt

    @torch.no_grad()
    def restore(self, flat, opt_state: Dict[str, np.ndarray],
                model_state: Dict[str, np.ndarray], ema=None) -> None:
        """Load a checkpoint's arrays (``optim.checkpoint.
        load_checkpoint``) into the parameters, the optimizer's slots,
        the buffers and the EMA; without a saved EMA it restarts from
        the restored parameters."""
        unravel_into(flat, self._ordered(self.params))
        self._restore_opt(opt_state)
        for n, b in self._buffers():
            b.copy_(torch.as_tensor(model_state["/".join(jax_path(n))]
                                    ).reshape(b.shape))
        if self.ema is not None:
            unravel_into(flat if ema is None else ema,
                         self._ordered(self.ema))

    def _restore_opt(self, opt_state: Dict[str, np.ndarray]) -> None:
        for slot, val in self.opt_state.items():
            if isinstance(val, torch.Tensor):
                val.copy_(torch.as_tensor(opt_state[slot]).reshape(
                    val.shape))
            elif self.optim_method.elementwise:
                unravel_into(opt_state[slot], self._ordered(val))
            else:
                for n, t in zip(self.names, val):
                    t.copy_(torch.as_tensor(opt_state[
                        "/".join((slot,) + jax_path(n))]).reshape(t.shape))


class ShardedParameterStep(TrainStep):
    """``TrainStep`` across the ranks of ``mesh``'s data axis: the ZeRO-1
    cycle of the JAX ``ShardedParameterStep``.  Every rank runs the
    forward and backward on its own rows of the global batch; then the
    flat gradient is reduce-scattered (``grad_comm``: ``"fp32"``,
    ``"bf16"`` or ``"int8"``, one collective a bucket of
    ``comm_bucket_bytes``), each rank updates its shard of the
    parameters with the optimizer state of that shard alone, and the
    updated shards are all-gathered back (``param_comm``: ``"fp32"``, or
    ``"int8"``: the update's delta, blockwise quantized by
    ``quant_block``).

    The parameters (in the JAX ravel order, ``utils.convert.
    flat_order``), their gradients and the EMA are views into one
    float32 buffer each (``flat_params``, ``flat_grads``), padded to
    ``n_pad``, a multiple of the ranks, and allocated once: autograd
    accumulates into ``flat_grads`` in place, the reduce-scatter reads it
    as it is, and the all-gather writes ``flat_params`` in place.  An
    elementwise method keeps its slots for this rank's
    ``shard_size`` entries only; a layer-wise one (``LarsSGD``) averages
    the whole gradient with one ``all_reduce`` and updates replicated.
    Clipping and ``gnorm`` sum the shards' squares with one
    ``all_reduce``; the trainable mask zeroes frozen gradients and puts
    frozen entries back bit for bit after the gather; the EMA runs over
    the gathered parameters.  Rank ``r`` draws its dropout masks from
    ``fold_in(step_key, r)`` (microbatch ``k`` from ``fold_in(., k)``),
    and after the step the loss and every floating buffer (BatchNorm's
    running statistics) are averaged over the ranks.

    With ``dcn_data > 1`` slices (``mesh.dcn_size``) the cycle is the JAX
    step's hierarchical one: the reduce-scatter and the all-gather run
    on the slice's ranks (``mesh.ici_group``, the ``data`` axis) and
    each reduced bucket slice is summed across slices on
    ``mesh.dcn_group`` in the ``grad_comm`` wire (:func:`collectives.
    psum_wire`; int8: two quantized phases), so only ``1 / data`` of the
    gradient crosses slices and no parameter does.  Every slice then
    makes the same update; the mean divides by ``n_data_replicas``
    (``data * dcn``), and rank ``r`` is data replica ``r``.

    On one rank there is no wire: the step is ``TrainStep``'s, to the
    bit, on the flat buffers.  On the card a bundle is a captured CUDA
    graph of one step with its NCCL collectives inside; the eager warm
    steps before the capture run every collective once, so NCCL sets up
    its communicator outside the capture.  ``bf16_grads=True`` is the
    deprecated spelling of ``grad_comm="bf16"``."""

    def __init__(self, model: torch.nn.Module, criterion,
                 optim_method: OptimMethod, mesh, *,
                 clip: Optional[GradientClipping] = None, seed: int = 42,
                 accum_steps: int = 1, ema_decay: float = 0.0,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 trainable_mask: Optional[Dict[str, Any]] = None,
                 grad_comm: Optional[str] = None,
                 comm_bucket_bytes: Optional[int] = None,
                 quant_block: int = collectives.DEFAULT_QUANT_BLOCK,
                 param_comm: Optional[str] = None,
                 bf16_grads: bool = False):
        if grad_comm is not None:
            grad_comm = str(grad_comm).strip().lower()
        if bf16_grads:
            warnings.warn("bf16_grads is deprecated: use grad_comm='bf16'",
                          DeprecationWarning, stacklevel=2)
            if grad_comm is None:
                grad_comm = "bf16"
        grad_comm = grad_comm or "fp32"
        if grad_comm not in collectives.GRAD_COMM_MODES:
            raise ValueError(f"grad_comm {grad_comm!r}: one of "
                             f"{collectives.GRAD_COMM_MODES}")
        param_comm = str(param_comm or "fp32").strip().lower()
        if param_comm not in collectives.PARAM_COMM_MODES:
            raise ValueError(f"param_comm {param_comm!r}: one of "
                             f"{collectives.PARAM_COMM_MODES}")
        self.grad_comm, self.param_comm = grad_comm, param_comm
        self.bf16_grads = grad_comm == "bf16"
        self.quant_block = int(quant_block)
        self.comm_bucket_bytes = comm_bucket_bytes
        self.mesh = mesh
        # the ZeRO-1 cycle runs on the slice's ranks; loss, buffers and
        # a layer-wise method's gradient average over every rank
        self.group = mesh.ici_group if mesh.ici_group is not None \
            else mesh.group
        self.world_group = mesh.group
        self.dcn_group = mesh.dcn_group
        self.rank = mesh.rank
        self.ndev = mesh.data_size
        self.dcn = mesh.dcn_size
        self.data_index = mesh.data_index
        super().__init__(model, criterion, optim_method, clip=clip,
                         seed=seed, accum_steps=accum_steps,
                         ema_decay=ema_decay, remat=remat,
                         remat_policy=remat_policy,
                         trainable_mask=trainable_mask)
        if (self.group is not None and self.device.type != "cuda"
                and dist.get_backend(self.group) == "nccl"):
            raise ValueError(f"the process group runs NCCL and the model "
                             f"lives on {self.device}: NCCL takes CUDA "
                             f"tensors only")
        self._mask_flat = None
        if self.masks is not None:
            mf = torch.zeros(self.n_pad, dtype=torch.bool,
                             device=self.device)
            for (lo, hi), i in zip(self._spans, self._order):
                m = self.masks[i]
                mf[lo:hi] = True if m is None else m.reshape(-1)
            self._mask_flat = mf

    # ---- the flat layout ------------------------------------------------------
    def _init_state(self):
        """Move the parameters into ``flat_params`` (views in the ravel
        order), give each a gradient view into ``flat_grads``, and build
        the optimizer's slots (this rank's shard for an elementwise method
        across ranks) and the EMA's buffer."""
        dev = self.device
        sizes = [self.params[i].numel() for i in self._order]
        self.n_real = sum(sizes)
        self.n_pad = round_up(max(self.n_real, 1), self.ndev)
        self.shard_size = self.n_pad // self.ndev
        self._cols = collectives.bucket_columns(
            self.shard_size, self.ndev, self.comm_bucket_bytes,
            collectives.wire_itemsize(self.grad_comm),
            self.quant_block if self.grad_comm == "int8" else None)
        self.flat_params = torch.zeros(self.n_pad, device=dev)
        self.flat_grads = torch.zeros(self.n_pad, device=dev)
        self._ema_flat = (torch.zeros(self.n_pad, device=dev)
                          if self.ema_decay else None)
        self._spans = []
        self._grad_views = [None] * len(self.params)
        ema = [None] * len(self.params) if self.ema_decay else None
        off = 0
        with torch.no_grad():
            for i, n in zip(self._order, sizes):
                p = self.params[i]
                if p.dtype != torch.float32:
                    raise ValueError(f"{self.names[i]}: parameters live in "
                                     f"float32, got {p.dtype}")
                view = self.flat_params[off:off + n].view(p.shape)
                view.copy_(p)
                p.data = view
                self._grad_views[i] = self.flat_grads[off:off + n].view(
                    p.shape)
                p.grad = self._grad_views[i]
                if ema is not None:
                    ema[i] = self._ema_flat[off:off + n].view(p.shape)
                    ema[i].copy_(view)
                self._spans.append((off, off + n))
                off += n
        if not self._zero1:
            return self.optim_method.init_state(self.params), ema
        lo = self.data_index * self.shard_size
        state = self.optim_method.init_state(
            [self.flat_params[lo:lo + self.shard_size]])
        if len(self._cols) > 1:
            # a bucket's update slices every slot like the parameters; a
            # slot that is not one per element would be fed whole to
            # every bucket and drift from the monolithic update
            bad = {k: (tuple(v.shape) if isinstance(v, torch.Tensor)
                       else [tuple(t.shape) for t in v])
                   for k, v in state.items()
                   if isinstance(v, torch.Tensor) or len(v) != 1
                   or tuple(v[0].shape) != (self.shard_size,)}
            if bad:
                raise ValueError(
                    f"comm_bucket_bytes requires per-element optimizer "
                    f"state (every slot shaped ({self.shard_size},)); "
                    f"{type(self.optim_method).__name__} has {bad}: use "
                    f"comm_bucket_bytes=None with this OptimMethod")
        return state, ema

    @property
    def _zero1(self) -> bool:
        """Whether the update runs on the flat shards (the optimizer
        state this rank's shard alone): an elementwise method on more
        than one rank."""
        return self.n_data_replicas > 1 and self.optim_method.elementwise

    @property
    def n_data_replicas(self) -> int:
        """The data-parallel degree over both axes (data x dcn)."""
        return self.ndev * self.dcn

    def _zero_grads(self) -> None:
        self.flat_grads.zero_()
        for p, g in zip(self.params, self._grad_views):
            if p.grad is not g:
                p.grad = g

    def step_key(self, step) -> Optional[torch.Tensor]:
        """This rank's dropout key of iteration ``step``."""
        if self._base_key is None:
            return None
        return prng.fold_in(prng.fold_in(self._base_key, step), self.rank)

    # ---- the step ---------------------------------------------------------------
    def _pmean(self, t: torch.Tensor) -> torch.Tensor:
        s = t.detach().float().reshape(1).clone()
        dist.all_reduce(s, group=self.world_group)
        return (s / self.n_data_replicas).reshape(t.shape)

    def _run(self, x, y, scalars, want_gnorm: bool = False):
        loss, gnorm = super()._run(x, y, scalars, want_gnorm)
        if self.n_data_replicas > 1:
            with torch.no_grad():
                loss = self._pmean(loss)
                bufs = [b for _, b in self._buffers()
                        if b.is_floating_point()]
                if bufs:
                    flat = torch.cat([b.reshape(-1) for b in bufs])
                    dist.all_reduce(flat, group=self.world_group)
                    flat.div_(self.n_data_replicas)
                    off = 0
                    for b in bufs:
                        b.copy_(flat[off:off + b.numel()].view(b.shape))
                        off += b.numel()
        return loss, gnorm

    @torch.no_grad()
    def _apply(self, scalars, accum: int, want_gnorm: bool
               ) -> Optional[torch.Tensor]:
        if self.n_data_replicas == 1:
            return super()._apply(scalars, accum, want_gnorm)
        g, n = self.flat_grads, self.ndev
        if accum > 1:
            g.div_(accum)
        if self._mask_flat is not None:
            g.mul_(self._mask_flat)
        if not self.optim_method.elementwise:
            # layer-wise (LARS): the whole mean gradient, replicated update
            with record_function("train_step/grad_sync"):
                dist.all_reduce(g, group=self.world_group)
                g.div_(self.n_data_replicas)
            return super()._apply(scalars, 1, want_gnorm)
        group, block = self.group, self.quant_block
        g2d = g.view(n, self.shard_size)
        with record_function("train_step/grad_sync"):
            slices = []
            for c0, c1 in self._cols:
                # one slice's rank alone: no wire, no quantization
                sb = (collectives.reduce_scatter_wire(
                    g2d[:, c0:c1], group, self.grad_comm, block=block)
                    if n > 1 else g[c0:c1])
                if self.dcn > 1:
                    # still in the wire dtype: bf16 crosses at half the
                    # bytes, int8 in two quantized phases
                    sb = collectives.psum_wire(sb, self.dcn_group,
                                               self.dcn, self.grad_comm,
                                               block=block)
                slices.append(sb.float() / self.n_data_replicas)
        gnorm = None
        if want_gnorm:
            gnorm = self._global_sq(slices).sqrt()
        with record_function("train_step/update"):
            clip = self.clip
            if clip is not None:
                if (clip.constant_min is not None
                        or clip.constant_max is not None):
                    for sb in slices:
                        sb.clamp_(clip.constant_min, clip.constant_max)
                if clip.l2_norm is not None:
                    scale = torch.clamp(clip.l2_norm / (
                        self._global_sq(slices).sqrt() + 1e-12), max=1.0)
                    for sb in slices:
                        sb.mul_(scale)
            flat = self.flat_params
            old = flat.clone() if self._mask_flat is not None else None
            flat2d = flat.view(n, self.shard_size)
            lo = self.data_index * self.shard_size
            for (c0, c1), sb in zip(self._cols, slices):
                p_b = flat[lo + c0:lo + c1]
                o_b = (self.opt_state if len(self._cols) == 1 else
                       {k: [v[0][c0:c1]] for k, v in self.opt_state.items()})
                prev = p_b.clone() if self.param_comm == "int8" else None
                self.optim_method.apply(scalars, [sb], [p_b], o_b)
                rows = flat2d[:, c0:c1]
                if n == 1:
                    continue
                if prev is not None:
                    # the delta on the wire; every rank adds the same
                    # dequantized bytes to its replicated base
                    delta = p_b - prev
                    p_b.copy_(prev)
                    collectives.all_gather_delta_quantized(
                        delta, rows, group, block=block, out=rows)
                elif len(self._cols) == 1:
                    collectives.all_gather(flat, p_b, group)
                else:
                    gathered = flat.new_empty((n, c1 - c0))
                    collectives.all_gather(gathered, p_b, group)
                    rows.copy_(gathered)
            if old is not None:
                torch.where(self._mask_flat, flat, old, out=flat)
            if self._ema_flat is not None:
                d = self.ema_decay
                self._ema_flat.mul_(d).add_(flat, alpha=1.0 - d)
        return gnorm

    def _global_sq(self, slices) -> torch.Tensor:
        """The sum over a slice's ranks of the shards' squared entries
        (every slice holds the same summed shards)."""
        sq = sum(torch.sum(sb * sb) for sb in slices).reshape(1)
        if self.ndev > 1:
            dist.all_reduce(sq, group=self.group)
        return sq.reshape(())

    # ---- the byte ledger -----------------------------------------------------
    @property
    def comm_buckets(self) -> int:
        """Gradient-sync buckets (1: one collective)."""
        return len(self._cols)

    @property
    def grad_sync_ici_bytes_per_step(self) -> int:
        """Wire bytes a step of the gradient reduce-scatter in its wire
        dtype (int8: payload, scales and block padding); 0 on one rank.
        "ici" keeps the JAX name: the link between the cards."""
        if self.ndev <= 1:
            return 0
        return sum(collectives.rs_wire_bytes(
            c1 - c0, self.ndev, self.grad_comm, self.quant_block)
            for c0, c1 in self._cols)

    @property
    def param_sync_ici_bytes_per_step(self) -> int:
        """Wire bytes a step of the updated-parameter all-gather in the
        ``param_comm`` wire dtype; 0 on one rank."""
        if self.ndev <= 1:
            return 0
        return sum(collectives.ag_wire_bytes(
            c1 - c0, self.ndev, self.param_comm, self.quant_block)
            for c0, c1 in self._cols)

    @property
    def collective_bytes_per_step(self) -> int:
        return (self.grad_sync_ici_bytes_per_step
                + self.param_sync_ici_bytes_per_step)

    @property
    def dcn_bytes_per_step(self) -> int:
        """Wire bytes a step across slices: the DCN psum of each bucket's
        ``1 / data`` slice in the ``grad_comm`` wire (int8: both
        quantized phases); 0 with one slice."""
        if self.dcn <= 1:
            return 0
        return sum(collectives.psum_wire_bytes(
            c1 - c0, self.dcn, self.grad_comm, self.quant_block)
            for c0, c1 in self._cols)

    # ---- checkpoints --------------------------------------------------------------
    def opt_shard(self) -> Tuple[Dict[str, np.ndarray], int,
                                 Dict[str, np.ndarray]]:
        """This rank's part of the optimizer state: (its shard of each
        elementwise slot, the shard's offset in the flat vector, the
        tensor slots whole)."""
        if not self._zero1:
            return super().opt_shard()
        shards, whole = {}, {}
        for slot, val in self.opt_state.items():
            if isinstance(val, torch.Tensor):
                whole[slot] = val.detach().cpu().numpy()
            else:
                shards[slot] = val[0].detach().cpu().numpy()
        return shards, self.data_index * self.shard_size, whole

    def _flat_vectors(self):
        """The flat buffers at ``n_pad``, as the JAX step writes them."""
        return self.flat_params, self._ema_flat

    def _opt_arrays(self) -> Dict[str, np.ndarray]:
        """Across ranks the optimizer's shards are gathered first (a
        collective: every rank calls ``checkpoint_arrays``)."""
        if not self._zero1:
            return super()._opt_arrays()
        opt = {}
        for slot, val in self.opt_state.items():
            if isinstance(val, torch.Tensor):
                opt[slot] = val.detach().cpu().numpy()
                continue
            if self.ndev == 1:
                opt[slot] = val[0].detach().cpu().numpy()
                continue
            full = val[0].new_empty(self.n_pad)
            collectives.all_gather(full, val[0], self.group)
            opt[slot] = full.cpu().numpy()
        return opt

    def _restore_opt(self, opt_state: Dict[str, np.ndarray]) -> None:
        if not self._zero1:
            return super()._restore_opt(opt_state)
        lo = self.data_index * self.shard_size
        for slot, val in self.opt_state.items():
            src = np.asarray(opt_state[slot])
            if isinstance(val, torch.Tensor):
                val.copy_(torch.as_tensor(src).reshape(val.shape))
                continue
            part = np.zeros(self.shard_size, np.float32)
            got = src.reshape(-1)[lo:lo + self.shard_size]
            part[:len(got)] = got
            val[0].copy_(torch.as_tensor(part))


@dataclass
class _Captured:
    """One captured step: the graph, its static inputs and outputs, and
    the kernel launches its capture recorded."""

    graph: Any
    xs: Tuple[torch.Tensor, ...]
    y: torch.Tensor
    loss: torch.Tensor
    gnorm: torch.Tensor
    launches: Counter
