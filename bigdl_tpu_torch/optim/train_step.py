"""The train step — the single-device case of
``bigdl_tpu.optim.train_step.ShardedParameterStep``.

One step is the forward in training mode, the criterion, autograd's
backward, the trainable mask, optional gradient clipping (constant,
then global L2 norm, as the JAX step clips; a layer-wise method such as
``LarsSGD`` gets only the norm clip, as on the JAX replicated path), the
optimizer's in-place update, and the EMA of the parameters.  With one
rank the JAX step's reduce-scatter / all-gather cycle is the identity,
so nothing of it is here.

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
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from bigdl_tpu_torch.nn.layers import BatchNorm, Dropout
from bigdl_tpu_torch.nn.module import Module, Sequential, _as_tuple
from bigdl_tpu_torch.ops.common import captured_launches, credit_launches
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.validation import (StatsAccumulator,
                                              ValidationMethod,
                                              ValidationResult)
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
             batches: Iterable, device: torch.device
             ) -> List[ValidationResult]:
    """Every method over host ``batches`` (a ``drop_last=False`` plan),
    ``model`` in eval mode; a padded last batch counts its real rows
    only.  The sums stay on the device until the end (the JAX
    ``_build_eval``)."""
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
        self.opt_state = optim_method.init_state(self.params)
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.ema_decay else None)
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
        self.device = (self.params[0].device if self.params
                       else torch.device("cpu"))
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
        for p in self.params:
            p.grad = None
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

    def checkpoint_arrays(self) -> Dict[str, Any]:
        """The step's tensors as the host arrays of a checkpoint
        (``optim.checkpoint`` names them)."""
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
        return {"flat_params": host(ravel(self._ordered(self.params))),
                "ema_flat": (None if self.ema is None
                             else host(ravel(self._ordered(self.ema)))),
                "opt_state": opt,
                "model_state": {"/".join(jax_path(n)): host(b)
                                for n, b in self._buffers()}}

    @torch.no_grad()
    def restore(self, flat, opt_state: Dict[str, np.ndarray],
                model_state: Dict[str, np.ndarray], ema=None) -> None:
        """Load a checkpoint's arrays (``optim.checkpoint.
        load_checkpoint``) into the parameters, the optimizer's slots,
        the buffers and the EMA; without a saved EMA it restarts from
        the restored parameters."""
        unravel_into(flat, self._ordered(self.params))
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
        for n, b in self._buffers():
            b.copy_(torch.as_tensor(model_state["/".join(jax_path(n))]
                                    ).reshape(b.shape))
        if self.ema is not None:
            unravel_into(flat if ema is None else ema,
                         self._ordered(self.ema))


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
