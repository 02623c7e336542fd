"""Optimizer — the port of the training loop of
``bigdl_tpu.optim.optimizer``, on one process or across the processes
of ``Engine.get().mesh``.

The setters and ``optimize()``'s loop are the JAX ``Optimizer``'s: each
epoch walks the batch plan of ``(seed, epoch)``, so the same (dataset,
batch size, seed) trains on the same batches in the same order with the
same dropout masks (``TrainStep``'s keys), and the triggers read the same
state dict (``epoch``, ``iteration``, ``epoch_batch``, ``epoch_finished``,
``loss``, ``score``, ``n_validations``).  After every step the
validation, checkpoint and parameter-summary triggers are asked, and once
more at each epoch's end, each firing at most once an iteration.

The input side is the JAX driver's (``_epoch_batch_iter``): a dataset
with ``stream_batches`` (``RecordDataSet``, ``AugmentedRecordImages``)
runs its stage-parallel pipeline when ``streaming`` and ``host_prefetch >
0``; any other dataset's ``batches()`` runs ``host_prefetch`` batches
ahead on a thread (``host_prefetch=0``: inline).  Both go through
``data.pipeline.dispatch_to_device``, ``prefetch`` batches deep: on the
card each batch is copied on a side stream (straight from a page-locked
ring slot when it comes from the pipeline) and the step's stream waits
on the copy's event; batches are copied, never aliased.  Every wait for
the next batch is recorded in ``metrics`` as ``train.data_wait_s`` (and
the ``data_time`` timer, in the ``train/data`` profiler range): a wait
there means the run is bound by its input, not by the card.

Step bundles (``steps_per_call``, the JAX driver's fused multi-step
execution): the loop pulls up to K device batches at a time
(``data.pipeline.bundle_batches``) and runs them as one bundle,
``TrainStep.train_bundle`` — on the card a captured CUDA graph of one
step replayed K times, so the host's work per step is a few launches.
``_bundle_span`` keeps bundle edges on the per-epoch grid (multiples of
K of ``epoch_batch``, so a resumed run meets the edges an uninterrupted
one did), clamps a bundle to the next ``Trigger.boundary`` edge of the
end, validation, checkpoint and histogram triggers (``several_iteration
(6)`` still checkpoints at 6 under K = 4), and shrinks it to one step
when a preemption is pending; the epoch's tail is a shorter bundle.  A
bundle is the same steps as K eager steps, to the bit.  ``steps_per_call
= 1`` (the default, from ``EngineConfig``) is today's eager step, the
reference the graphs are held to; ``"auto"`` starts at 1 and picks K
after its first timed window (dispatch against step time).  Triggers and
summaries see bundle edges only; the metrics ``step_dispatch`` (host
time a step), ``train.bundle_size``, ``train.steps_in_flight`` and
``train.dispatch_gap_s`` describe the bundles.

Losses stay on the device as one vector a bundle, so the host runs
ahead of the card.  They are read one bundle late — the card always has
the next bundle queued behind the one the host waits for — when someone
needs them: a train summary (``set_train_summary``: each step's
``loss``, ``lr`` and ``throughput``, records/s between the host's
reads), the ``watchdog`` (a ``resilience.detector.StepWatchdog``: every
step's loss in order, its NaN streak raising ``PoisonedStepError``), and
before every checkpoint, so that a checkpoint never holds a step the
watchdog has not passed.  A validation reads the device at its own
iteration; a validation summary takes each validation method's result,
and ``set_summary_trigger("Parameters", trigger)`` a histogram of every
parameter when the trigger fires.  The files are the JAX package's
(jsonl and TensorBoard events) with the same tags.

The in-run retry loop: a failure inside the loop is classified
(``resilience.retry.classify``), counted against
``EngineConfig.failure_retry_times`` and the cause's own bound
(``EngineConfig.resolved_failure_policy()``: its ``failure_policy``, or
one built from the retry knobs),
backed off, and recovered from the newest complete checkpoint in place
(the parameters, slots and buffers a captured graph holds are copied
into, never rebound); without a checkpoint it re-raises.  Metrics
``recoveries_total``, ``retries_by_cause.<cause>`` and
``time_lost_to_recovery_s``.  ``resilience.faults`` fires
``step_fail``, ``slow_host`` and ``process_kill`` for every step of a
bundle's range at its edge, ``checkpoint_write_fail`` inside the
checkpoint writer and ``storage_io_fail`` at the storage seam.
``set_preemption_checkpoint(*signals)`` installs a handler that only
sets a flag; the loop checkpoints at the next bundle edge (the next
bundle shrunk to one step) and stops.  ``set_profile`` (or
``EngineConfig.profile_dir``) traces a window of iterations with
``torch.profiler`` (``utils.profiling``).

``set_checkpoint`` writes the format of ``optim.checkpoint``;
``optimize()`` first resumes from the newest complete checkpoint under
the path (parameters, optimizer slots, BatchNorm buffers, EMA, the
loop's state and a ``Plateau``'s state) and goes on with the epoch's
batch order from ``epoch_batch``.  The step's knobs ``accum_steps``,
``remat``, ``remat_policy``, ``ema_decay`` and ``trainable_mask`` are
attributes, as on the JAX Optimizer.  A model with lazy widths
(``Linear(out)``, ``BatchNorm()``, ``PReLU()``) is built from one sample
row before its parameters are collected.

Across processes (an engine that joined a process group,
``runtime.engine``): the step is ``ShardedParameterStep``, the ZeRO-1
cycle, with the wire attributes ``grad_comm`` (else
``EngineConfig.grad_comm``; the deprecated ``bf16_grads=True`` warns and
means ``"bf16"``), ``param_comm``, ``comm_bucket_bytes`` (else the
engine's) and ``quant_block``; its byte ledger is published as the
``train.collective_*`` gauges.  ``batch_size`` is the global batch:
rank ``r`` of ``n`` trains on its plan ``(process_id=r,
process_count=n)``, ``batch_size / n`` rows a step, and the losses are
the ranks' mean.  Checkpoints: ``set_checkpoint(sharded="auto")`` writes
one optimizer-state shard a process when there is more than one (rank
0 writes the rest and the manifest; a synchronous save barriers, an
asynchronous one names its files by an attempt token that rank 0
broadcasts on the main thread), ``sharded=False`` gathers the state to
rank 0, ``mirror=`` copies every save to a second root.  A checkpoint
loads at any process count; one written by another count mid-epoch
(the manifest's ``process_count``) is an elastic resume: the epoch's
remaining examples are re-sharded over the new processes (the dataset's
``resharded_batches``; nothing replays, nothing is dropped), or the
epoch replays from its start when the dataset cannot re-shard
(``elastic_resumes_total``, ``elastic_resharded_total``).  Every rank
validates on its own plan and the sums are reduced; rank 0 alone writes
summaries and histograms.  A process at world 1 keeps ``TrainStep``
unless a process group is up, and ``ShardedParameterStep`` on one rank
is ``TrainStep``'s step to the bit.

``seq_parallel`` (the JAX attribute): the step shards dim 1 of every
rank >= 2 input and target over the mesh's ``seq`` axis
(``ShardedParameterStep(seq_parallel=True)``); the ranks of a data
replica train on the replica's batch plan (``Mesh.replica_index`` of
``Mesh.data_replicas``) and validate on it, each on its sequence block.

Performance accounting (the JAX driver's ``_arm_perf_accounting``):
before the first step the analytic cost model (``obs.cost``, a shape walk
of a CPU copy of the model on one sample row, no kernel launched) gives
``train.flops_per_step`` and ``train.effective_flops_per_step`` for the
global batch, the device's peak (``obs.cost.peak_flops``:
``BIGDL_TPU_PEAK_FLOPS``, ``EngineConfig.peak_flops``, the device name's
table) the denominator, and the collective ledger the
``train.collective_*`` gauges.  Best effort: a walk that fails leaves the
FLOP gauges unset and never stops training.  Every ``log_every`` steps
(JAX's default 1) a log point closes an attribution window when the
host reads the bundle that reached it, one bundle late, so the card
always has the next bundle queued: ``obs.attr.StepAttribution`` splits
the window's wall time into data, dispatch, overhead and device
(``train.attr.*_s``), and from the second window on (but for the windows
of a flush: the run's end, a checkpoint) ``train.step_time_s``,
``train.achieved_flops_per_chip``, ``train.mfu`` and
``train.effective_mfu`` (the bfloat16 peak even in a float32-pinned run,
as in JAX) are set, and across processes the stragglers'
``train.step_time_{max,min,skew}_s``.  The recompile sentinel
(``obs.attr``) goes steady after two windows; a CUDA graph capture or a
kernel build after that, outside ``expected_compile``, counts as
``train.unexpected_recompiles_total``.  ``attribution.table()`` is logged
at the run's end.  ``BIGDL_TPU_MEASURE_OVERLAP=1`` runs the step's
overlap audit on the first batch before training
(``train.comm_overlap_efficiency``, ``train.comm_exposed_collective_s``,
a ``comm_overlap_audit`` flight event).

Not ported: the cluster hooks (``set_cluster``, gang recovery,
membership, cluster-wide preemption notices; ROADMAP A.6.9): the
preemption path and the in-run retry are per process."""

import itertools
import logging
import os
import signal
import time
import uuid
import warnings
from collections import Counter
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.data.pipeline import bundle_batches, dispatch_to_device
from bigdl_tpu_torch.data.prefetch import thread_prefetch
from bigdl_tpu_torch.nn.freeze import has_frozen, trainable_mask_for
from bigdl_tpu_torch.nn.layers import has_lazy
from bigdl_tpu_torch.obs import attr as obs_attr
from bigdl_tpu_torch.obs import cost as obs_cost
from bigdl_tpu_torch.obs import flight, trace
from bigdl_tpu_torch.ops.block_sparse import apply_masks, collect_masks
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim import checkpoint as ckpt
from bigdl_tpu_torch.optim.metrics import Metrics, SummaryWriter, Timer
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import (GradientClipping,
                                              ShardedParameterStep,
                                              TrainStep, evaluate, to_device)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.retry import classify
from bigdl_tpu_torch.runtime.engine import Engine
from bigdl_tpu_torch.tensor.policy import apply_precision_policy
from bigdl_tpu_torch.utils.convert import (export_variables, jax_path,
                                           load_jax_variables)
from bigdl_tpu_torch.utils.profiling import IterationProfiler

log = logging.getLogger("bigdl_tpu_torch.optim")


class TrainedModel:
    """What ``optimize()`` returns: the trained module, its variables as
    JAX-keyed ``{"params", "state"}`` trees, batched prediction and
    evaluation, and ``losses``, the loss of every step of the run.

    A layout's model (``parallel.gspmd.fit_layout``: its parameters
    DTensors) predicts, evaluates and loads through its step, as the
    JAX ``TrainedModel`` does through a layout engine; reading its
    variables gathers them (a collective every rank calls)."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 step: Optional[TrainStep] = None,
                 losses: Sequence[float] = ()):
        self.model = model
        self.device = device
        self._step = step
        self.losses = list(losses)

    @property
    def _layout(self) -> bool:
        return hasattr(self._step, "predict_fn")

    @property
    def variables(self) -> Dict[str, Any]:
        return export_variables(self.model)

    @property
    def ema_variables(self) -> Optional[Dict[str, Any]]:
        """The EMA weights (with the live BatchNorm state) when the run
        kept one (``ema_decay``), else None; evaluate them through
        ``set_variables(trained.ema_variables)``."""
        if self._step is None or getattr(self._step, "ema", None) is None:
            return None
        return self._step.get_variables(ema=True)

    def set_variables(self, variables: Dict[str, Any]) -> None:
        """Copy a ``{"params", "state"}`` tree into the model."""
        if self._layout:
            self._step.set_variables(variables)
        else:
            load_jax_variables(self.model, variables)

    @torch.no_grad()
    def predict(self, x, batch_size: int = 0) -> np.ndarray:
        """The model's outputs for the host array ``x`` (a tuple of
        arrays for a multi-input model), in batches of ``batch_size``
        rows (all at once for 0)."""
        self.model.train(False)
        xs = x if isinstance(x, tuple) else (x,)
        n = len(xs[0])
        step = batch_size if batch_size > 0 else max(n, 1)
        if self._layout:
            run = self._step.predict_fn()
            return np.concatenate([
                run(tuple(a[i:i + step] for a in xs) if len(xs) > 1
                    else xs[0][i:i + step]) for i in range(0, n, step)])
        return np.concatenate([
            self.model(*(to_device(a[i:i + step], self.device)
                         for a in xs)).cpu().numpy()
            for i in range(0, n, step)])

    def evaluate(self, dataset: DataSet,
                 methods: Sequence[ValidationMethod],
                 batch_size: int = 128) -> List[ValidationResult]:
        """Every method over ``dataset`` in order, every row once, in
        eval mode on the training device."""
        batches = dataset.batches(batch_size, shuffle=False,
                                  drop_last=False)
        if self._layout:
            return self._step.evaluate(list(methods), batches)
        return evaluate(self.model, list(methods), batches, self.device)


class Optimizer:
    """Sets up and runs training on this process's device, alone or as
    one rank of the engine's process group.  ``device=None`` is ``cuda``;
    without CUDA the caller must pass ``device="cpu"``."""

    def __init__(self, model: torch.nn.Module, dataset: DataSet, criterion,
                 batch_size: int = 32, seed: int = 42, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.batch_size = batch_size
        self.seed = seed
        self.optim_method: OptimMethod = SGD(learning_rate=1e-2)
        self.end_when: Trigger = Trigger.max_epoch(10)
        self.clip: Optional[GradientClipping] = None
        # the step's knobs (the JAX Optimizer's attributes)
        self.accum_steps = 1      # gradient-accumulation microbatches
        self.remat = False        # recompute activations in the backward
        self.remat_policy: Optional[str] = None   # None|'nothing'|'dots'
        self.ema_decay = 0.0      # weight EMA (0 = off)
        self.trainable_mask = None  # JAX-keyed bool tree over params
        # the ZeRO-1 wire across processes (None: the engine's / fp32)
        self.grad_comm: Optional[str] = None   # "fp32" | "bf16" | "int8"
        self.bf16_grads = False   # deprecated spelling of grad_comm="bf16"
        self.param_comm: Optional[str] = None  # "fp32" | "int8"
        self.comm_bucket_bytes: Optional[int] = None
        self.quant_block: Optional[int] = None  # int8 elements a scale
        # shard dim 1 over the mesh's seq axis (sequence-parallel
        # attention layers required)
        self.seq_parallel = False
        # a log point (attribution window, MFU) every log_every steps
        self.log_every = 1
        # the input side (the JAX Optimizer's attributes and defaults)
        self.prefetch = 2         # device-copy lookahead (1 = no overlap)
        self.host_prefetch = 2    # batches the host producer runs ahead
        #                           (0 = inline production)
        self.streaming = True     # stage-parallel pipeline when the
        #                           dataset has stream_batches
        self.metrics = Metrics()  # train.data_wait_s, data.* and the feed
        # step bundles: an int K >= 1 or "auto"; None inherits
        # EngineConfig.steps_per_call
        self.steps_per_call = None
        self.watchdog = None      # a resilience.detector.StepWatchdog
        self._preempt_signals: tuple = ()
        self._preempted = False
        self._profiler: Optional[IterationProfiler] = None
        self._bundle_k = 1
        self._bundle_auto = False
        self._bundle_picked = False
        # bundles run and not yet read by the host: (first step, losses,
        # grad norms or None, the event of their copy to the host); every
        # bundle's losses of this run
        self._pending: List[Tuple[int, torch.Tensor, Any, Any]] = []
        self._trained: List[Tuple[int, torch.Tensor]] = []
        self._reads = 0
        self._inflight = 0
        self._last_dispatch_end: Optional[float] = None
        self._train_summary: Optional[SummaryWriter] = None
        self._val_summary: Optional[SummaryWriter] = None
        self._summary_triggers: Dict[str, Trigger] = {}
        self._last_hist_iter = -1
        self._log_t = 0.0
        self._initial_variables: Optional[Dict[str, Any]] = None
        self._ckpt_path: Optional[str] = None
        self._ckpt_trigger: Optional[Trigger] = None
        self._ckpt_async: Optional[ckpt.AsyncCheckpointer] = None
        self._ckpt_sharded: Any = "auto"
        self._ckpt_mirror: Optional[str] = None
        # this process's place in the engine's process group, and its
        # batch plan (its data replica's)
        self._group = None
        self._rank, self._world = 0, 1
        self._plan_rank, self._plan_count = 0, 1
        self._seq = None
        # performance accounting (_arm_perf_accounting)
        self.attribution: Optional[obs_attr.StepAttribution] = None
        self._recompile: Optional[obs_attr.RecompileSentinel] = None
        self._flops_per_step: Optional[float] = None
        self._eff_flops_per_step: Optional[float] = None
        self.peak_flops: Optional[float] = None
        self.peak_device: Optional[str] = None
        self._cost_sample = None
        self._attr_t0 = 0.0
        self._attr_prev_it = 0
        self._attr_data0 = 0.0
        self._attr_dispatch = 0.0
        self._attr_overhead = 0.0
        self._attr_wall_windows = 0
        # the completion event of the bundle that closed the last window
        self._attr_event = None
        # (first iteration, last iteration, seconds a step) of the last
        # window that set the step time and MFU gauges
        self.timed_window: Optional[Tuple[int, int, float]] = None
        self._validated = False
        # the last optimize()'s overlap audit (BIGDL_TPU_MEASURE_OVERLAP)
        self.overlap_audit: Optional[Dict[str, Any]] = None
        # the collective bytes a step (_arm_perf_accounting)
        self._ici_bytes_step = self._dcn_bytes_step = 0
        self._val_trigger: Optional[Trigger] = None
        self._val_dataset: Optional[DataSet] = None
        self._val_methods: List[ValidationMethod] = []
        self._val_batch = batch_size
        self._last_val_iter = -1
        self._last_ckpt_iter = -1
        self._final_state: Optional[Dict[str, Any]] = None
        # the loss of every step of the last optimize(), in order
        self.losses: List[float] = []
        # (iteration, results) of every validation of the last optimize()
        self.validations: List[Tuple[int, List[ValidationResult]]] = []

    # ---- setters ----------------------------------------------------------
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_initial_variables(self, variables: Dict[str, Any]
                              ) -> "Optimizer":
        """Start from a JAX-keyed variables tree (``{"params", "state"}``,
        or the params tree itself), e.g. weights trained by the JAX
        package; copied in by ``utils.convert.load_jax_variables``."""
        self._initial_variables = (variables if "params" in variables
                                   else {"params": variables})
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       async_write: bool = False, sharded="auto",
                       mirror: Optional[str] = None) -> "Optimizer":
        """Checkpoint into ``path`` (local, or a ``utils.storage`` URI
        every process sees) whenever ``trigger`` fires; ``async_write``
        snapshots the tensors to the host at the trigger and writes on a
        background thread, one write in flight.  ``sharded``: ``"auto"``
        writes the optimizer state as one shard a process when there is
        more than one, ``True`` always, ``False`` never (gathered to rank
        0); a layer-wise method's replicated state is never sharded.
        ``mirror``: a second root every completed save is copied to."""
        if sharded not in ("auto", True, False):
            raise ValueError(f"sharded {sharded!r}: 'auto', True or False")
        self._ckpt_path = path
        self._ckpt_trigger = trigger
        self._ckpt_sharded = sharded
        self._ckpt_mirror = mirror
        self._ckpt_async = ckpt.AsyncCheckpointer() if async_write else None
        return self

    def set_validation(self, trigger: Trigger, dataset: DataSet,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        self._val_trigger = trigger
        self._val_dataset = dataset
        self._val_methods = list(methods)
        if batch_size:
            self._val_batch = batch_size
        return self

    def set_gradient_clipping_by_l2_norm(self, norm: float) -> "Optimizer":
        self.clip = self.clip or GradientClipping()
        self.clip.l2_norm = norm
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float
                                       ) -> "Optimizer":
        self.clip = self.clip or GradientClipping()
        self.clip.constant_min = min_v
        self.clip.constant_max = max_v
        return self

    def set_train_summary(self, log_dir: str) -> "Optimizer":
        self._train_summary = SummaryWriter(log_dir, "train")
        return self

    def set_val_summary(self, log_dir: str) -> "Optimizer":
        self._val_summary = SummaryWriter(log_dir, "validation")
        return self

    def set_summary_trigger(self, tag: str, trigger: Trigger
                            ) -> "Optimizer":
        """Opt-in heavy summary streams; the one tag is ``"Parameters"``
        (a histogram of every parameter, a device-to-host copy of the
        model whenever ``trigger`` fires)."""
        if tag != "Parameters":
            raise ValueError(f"unknown summary tag {tag!r} "
                             "(supported: 'Parameters')")
        self._summary_triggers[tag] = trigger
        return self

    def set_profile(self, log_dir: str, start_iter: int = 10,
                    num_iters: int = 5) -> "Optimizer":
        """Trace iterations ``[start_iter, start_iter + num_iters)`` with
        torch.profiler into ``log_dir`` (a Chrome trace file)."""
        self._profiler = IterationProfiler(log_dir, start_iter, num_iters)
        return self

    def set_cluster(self, coordinator) -> "Optimizer":
        """Not ported yet: the cluster coordinator (membership, peer-shard
        publishes and restores) comes with ROADMAP A.6.9."""
        raise ValueError("Optimizer.set_cluster: the cluster coordinator "
                         "is not ported yet (ROADMAP A.6.9)")

    def set_preemption_checkpoint(self, *signals) -> "Optimizer":
        """Checkpoint and stop cleanly when the process receives one of
        ``signals`` (default SIGTERM, what a preempted machine gets); the
        handler only sets a flag, the loop saves at its next bundle
        edge.  Requires ``set_checkpoint``."""
        self._preempt_signals = signals or (signal.SIGTERM,)
        return self

    def _resolved_grad_comm(self, config) -> str:
        """The run's gradient wire: ``grad_comm``, else the deprecated
        ``bf16_grads=True`` (warned) as ``"bf16"``, else the engine's."""
        if self.grad_comm is not None:
            mode = str(self.grad_comm).strip().lower()
            if self.bf16_grads and mode != "bf16":
                warnings.warn("both grad_comm and the deprecated bf16_grads "
                              f"are set; grad_comm={mode!r} wins",
                              DeprecationWarning, stacklevel=2)
            return mode
        if self.bf16_grads:
            warnings.warn("Optimizer.bf16_grads is deprecated: set "
                          "grad_comm='bf16'", DeprecationWarning,
                          stacklevel=2)
            return "bf16"
        return getattr(config, "grad_comm", "fp32") or "fp32"

    @property
    def final_state(self) -> Optional[Dict[str, Any]]:
        """The loop's state at the end of the last ``optimize()``."""
        return self._final_state

    # ---- the training loop --------------------------------------------------
    def _sample_batch(self) -> Optional[Dict[str, Any]]:
        """The first batch of this process's plan, unshuffled: its first
        row builds lazy widths and sizes the cost walk, the batch feeds
        the overlap audit (the JAX driver's ``sample``).  None when the
        plan has no batch (the loop then says so)."""
        it = self.dataset.batches(self.batch_size, shuffle=False,
                                  process_id=self._plan_rank,
                                  process_count=self._plan_count)
        try:
            return next(iter(it), None)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _prepare_model(self, batch) -> torch.nn.Module:
        model = self.model.to(self.device)
        if has_lazy(model) and batch is not None:
            sample = batch["input"]
            with torch.no_grad():
                model.train(False)
                model(*(to_device(a[:1], self.device)
                        for a in (sample if isinstance(sample, tuple)
                                  else (sample,))))
        if self._initial_variables is not None:
            load_jax_variables(model, self._initial_variables)
        return model

    def optimize(self) -> TrainedModel:
        engine = Engine.get()
        config, mesh = engine.config, engine.mesh
        self._group = mesh.group
        self._rank, self._world = mesh.rank, mesh.world_size
        self._plan_rank, self._plan_count = (mesh.replica_index,
                                             mesh.data_replicas)
        if self.seq_parallel and not mesh.distributed:
            raise ValueError("seq_parallel needs a mesh seq axis > 1 "
                             "(init_engine(seq=N))")
        if self._profiler is None and config.profile_dir:
            self.set_profile(config.profile_dir)
        spc = (self.steps_per_call if self.steps_per_call is not None
               else config.steps_per_call)
        self._bundle_auto = spc == "auto"
        if not self._bundle_auto and (isinstance(spc, bool)
                                      or not isinstance(spc, int)
                                      or spc < 1):
            raise ValueError(
                f"steps_per_call {spc!r}: an int >= 1 or 'auto'")
        self._bundle_k = 1 if self._bundle_auto else spc
        self._bundle_picked = False
        if self._preempt_signals and not self._ckpt_path:
            raise ValueError(
                "set_preemption_checkpoint requires set_checkpoint")
        if self.device.type == "cuda":
            apply_precision_policy()
        batch = self._sample_batch()
        model = self._prepare_model(batch)
        mask = self.trainable_mask
        if mask is None and has_frozen(model):
            mask = trainable_mask_for(model)
        kw = dict(clip=self.clip, seed=self.seed,
                  accum_steps=self.accum_steps, ema_decay=self.ema_decay,
                  remat=self.remat, remat_policy=self.remat_policy,
                  trainable_mask=mask)
        if mesh.distributed:
            if self.quant_block is not None:
                kw["quant_block"] = int(self.quant_block)
            step = ShardedParameterStep(
                model, self.criterion, self.optim_method, mesh,
                grad_comm=self._resolved_grad_comm(config),
                param_comm=self.param_comm,
                comm_bucket_bytes=(self.comm_bucket_bytes
                                   if self.comm_bucket_bytes is not None
                                   else config.comm_bucket_bytes),
                seq_parallel=self.seq_parallel, **kw)
            if self._rank == 0:
                log.info("%s parameters; %d ranks; ZeRO-1 shard %s; "
                         "grad_comm %s", f"{step.n_real:,}", step.ndev,
                         f"{step.shard_size:,}", step.grad_comm)
        else:
            step = TrainStep(model, self.criterion, self.optim_method,
                             **kw)
        self._seq = step.seq if getattr(step, "seq_parallel", False) \
            else None
        self._arm_perf_accounting(config, step, batch)
        if batch is not None and os.environ.get(
                "BIGDL_TPU_MEASURE_OVERLAP", "0") in ("1", "true"):
            self._overlap_audit(step, batch)
        state: Dict[str, Any] = {
            "epoch": 1, "iteration": 0, "epoch_batch": 0,
            "epoch_finished": False, "loss": float("nan"),
            "score": float("-inf"),
        }
        self._last_val_iter = self._last_ckpt_iter = -1
        self.validations = []
        self._trained = []
        if self._ckpt_path:
            self._try_resume(step, state)
        # the handler only sets a flag: the loop saves at a bundle edge
        self._preempted = False
        old_handlers = []

        def on_preempt(signum, frame):
            self._preempted = True

        for sig in self._preempt_signals:
            old_handlers.append((sig, signal.signal(sig, on_preempt)))
        try:
            self._loop(step, state)
            if self._ckpt_async is not None:
                self._ckpt_async.wait()
        finally:
            # the run's tail and a later run's warmup are not flagged
            self._recompile.mark_warmup()
            model.train(False)
            if self._profiler is not None:
                self._profiler.close()
            for sig, handler in old_handlers:
                signal.signal(sig, handler)
        self.losses = (torch.cat([lv for _, lv in self._trained])
                       .cpu().tolist() if self._trained else [])
        if self.losses:
            state["loss"] = self.losses[-1]
        self._final_state = dict(state)
        if self.attribution.steps and self._rank == 0:
            log.info("%s", self.attribution.table())
        return TrainedModel(model, self.device, step, self.losses)

    def _arm_perf_accounting(self, config, step: TrainStep, batch) -> None:
        """The run's accounting state (the JAX driver's): the analytic
        FLOPs a step, the device's peak, the collective ledger's gauges,
        the attribution accumulator and the recompile sentinel."""
        self.attribution = obs_attr.StepAttribution(self.metrics)
        self._attr_wall_windows = 0
        self._recompile = obs_attr.recompile_sentinel()
        self._recompile.mark_warmup()
        self._flops_per_step = self._eff_flops_per_step = None
        self._cost_sample = None
        if batch is not None:
            x = batch["input"]
            self._cost_sample = tuple(np.asarray(a[:1]) for a in (
                x if isinstance(x, tuple) else (x,)))
        self._refresh_cost_model()
        self.peak_device = obs_cost.device_name(self.device)
        self.peak_flops = obs_cost.peak_flops(self.peak_device,
                                               config.peak_flops)
        led = obs_cost.collective_ledger(step)
        self._ici_bytes_step = led["ici_bytes_per_step"]
        self._dcn_bytes_step = led["dcn_bytes_per_step"]
        self.metrics.gauge("train.collective_ici_bytes_per_step",
                           self._ici_bytes_step)
        self.metrics.gauge("train.collective_dcn_bytes_per_step",
                           self._dcn_bytes_step)
        self.metrics.gauge("train.collective_grad_ici_bytes_per_step",
                           led["grad_ici_bytes_per_step"])
        self.metrics.gauge("train.collective_param_ici_bytes_per_step",
                           led["param_ici_bytes_per_step"])
        self.metrics.gauge("train.grad_comm_buckets", led["comm_buckets"])

    def _refresh_cost_model(self) -> None:
        """The FLOP gauges from the cost walk of the model as it is now
        (again after a restore changed its block-sparse masks); a walk
        that fails leaves them as they were."""
        if self._cost_sample is None:
            return
        try:
            detail = obs_cost.train_step_flops_detail(
                self.model, self._cost_sample, self.batch_size)
        except Exception as e:  # noqa: BLE001 — observability only
            log.debug("analytic cost model unavailable (%s); no live MFU "
                      "gauge this run", e)
            return
        self._flops_per_step = detail["dense"]
        self._eff_flops_per_step = detail["effective"]
        self.metrics.gauge("train.flops_per_step", self._flops_per_step)
        self.metrics.gauge("train.effective_flops_per_step",
                           self._eff_flops_per_step)

    def _overlap_audit(self, step: TrainStep, batch) -> None:
        """``BIGDL_TPU_MEASURE_OVERLAP=1``: the step's overlap audit on
        this rank's first batch, before the first step; it leaves the
        step's state as it found it."""
        x = batch["input"]
        xs = tuple(to_device(a, self.device) for a in (
            x if isinstance(x, tuple) else (x,)))
        y = to_device(batch["target"], self.device)
        try:
            ov = step.measure_overlap(xs if len(xs) > 1 else xs[0], y)
        except Exception as e:  # noqa: BLE001 — an audit never stops a run
            log.warning("overlap audit failed (%s); skipped", e)
            return
        self.metrics.gauge("train.comm_overlap_efficiency",
                           ov["overlap_efficiency"])
        self.metrics.gauge("train.comm_exposed_collective_s",
                           ov["exposed_collective_s"])
        self.overlap_audit = ov
        flight.record("comm_overlap_audit", **ov)

    def _should_log(self, prev_it: int, it: int) -> bool:
        """A log point is a multiple of ``log_every`` in (prev_it, it]."""
        return bool(self.log_every) and \
            it // self.log_every > prev_it // self.log_every

    def _account_window(self, it: int, now: float, timed: bool = True,
                        done=None) -> None:
        """Close the attribution window that ends with step ``it``, read
        at ``now``: the four components (``train.attr.*_s``), then, from
        the second window on, the step time, MFU and straggler gauges;
        the sentinel goes steady after two windows (the first holds the
        set-up and the captures, the second the first replays).  A
        window read by a flush (``timed=False``: the run's end, a
        checkpoint) began when the bundle it waits for was mostly run
        (its dispatch had filled the card's queue), so it is attributed
        but sets no step time.  On the card (``done``, the completion
        event of the bundle read) the step time is the card's time
        between the two windows' last bundles finishing: the host's
        read of a bundle may come late (its dispatch of the next one
        waited on the card), which would move time from one window to
        the next."""
        steps = it - self._attr_prev_it
        wall = now - self._attr_t0
        data = self.metrics.total("data_time")
        if steps <= 0 or wall <= 0:
            return
        self.attribution.window(steps, wall,
                                data_s=data - self._attr_data0,
                                dispatch_s=self._attr_dispatch,
                                overhead_s=self._attr_overhead)
        first, last_event = self._attr_prev_it, self._attr_event
        self._attr_t0, self._attr_prev_it, self._attr_data0 = now, it, data
        self._attr_event = done
        self._attr_dispatch = self._attr_overhead = 0.0
        self._attr_wall_windows += 1
        if self.attribution.windows >= 2 and not self._recompile.steady:
            self._recompile.mark_steady(it)
        if self._attr_wall_windows < 2 or not timed:
            return
        if done is not None and last_event is not None:
            wall = last_event.elapsed_time(done) / 1e3
        dt = wall / steps
        self.timed_window = (first, it, dt)
        self.metrics.observe("train.step_time_s", dt)
        if self._flops_per_step:
            self.metrics.gauge("train.achieved_flops_per_chip",
                               self._flops_per_step / dt / self._world)
            m = obs_cost.mfu(self._flops_per_step, dt, self._world,
                             self.peak_flops)
            if m is not None:
                self.metrics.gauge("train.mfu", m)
            em = obs_cost.mfu(self._eff_flops_per_step or 0.0, dt,
                              self._world, self.peak_flops)
            if em is not None:
                self.metrics.gauge("train.effective_mfu", em)
        if self._world > 1:
            stats = obs_attr.host_step_time_stats(dt, group=self._group)
            if stats:
                self.metrics.gauge("train.step_time_max_s", stats["max"])
                self.metrics.gauge("train.step_time_min_s", stats["min"])
                self.metrics.gauge("train.step_time_skew_s", stats["skew"])

    def _restart_window(self, it: int) -> None:
        """A new attribution window from iteration ``it`` now (the run's
        start, a recovery); the first window after it holds set-up."""
        self._attr_t0 = time.perf_counter()
        self._attr_prev_it = it
        self._attr_data0 = self.metrics.total("data_time")
        self._attr_dispatch = self._attr_overhead = 0.0
        self._attr_wall_windows = 0
        self._attr_event = None

    def _loop(self, step: TrainStep, state) -> None:
        """``_train`` under the in-run retry loop (the JAX driver's): a
        failure is classified, bounded overall and per cause, backed
        off, and recovered from the newest checkpoint."""
        config = Engine.get().config
        retries = 0
        by_cause: Counter = Counter()
        while True:
            try:
                self._train(step, state)
                return
            except Exception as e:
                retries += 1
                t_fail = time.perf_counter()
                # the failed bundles' unread losses belong to the steps
                # about to be rolled back
                self._pending = []
                self._inflight = 0
                self._last_dispatch_end = None
                cause = classify(e)
                cause_policy = config.resolved_failure_policy() \
                    .policy_for(cause)
                by_cause[cause] += 1
                # an async write in flight may be the newest checkpoint
                if self._ckpt_async is not None:
                    self._ckpt_async.wait(raise_error=False)
                can_resume = (self._ckpt_path
                              and ckpt.latest_checkpoint(self._ckpt_path))
                if (retries > config.failure_retry_times or not can_resume
                        or by_cause[cause] > cause_policy.max_retries):
                    raise
                delay = cause_policy.backoff(by_cause[cause])
                log.warning("iteration failed (%s: %s); retry %d/%d from "
                            "checkpoint [cause %s] in %.2fs",
                            type(e).__name__, e, retries,
                            config.failure_retry_times, cause.value, delay)
                flight.record("train_in_run_retry", cause=cause.value,
                              retry=retries, iteration=state["iteration"],
                              error=f"{type(e).__name__}: {e}")
                time.sleep(delay)
                with record_function("resilience/in_run_resume"), \
                        trace.span("resilience/in_run_resume",
                                   cause=cause.value, retry=retries):
                    self._try_resume(step, state)
                self._trained = [(i, lv) for i, lv in self._trained
                                 if i < state["iteration"]]
                self.metrics.inc("recoveries_total")
                self.metrics.inc(f"retries_by_cause.{cause.value}")
                self.metrics.inc("time_lost_to_recovery_s",
                                 time.perf_counter() - t_fail)
                # recovery is not step time
                self.metrics.reset()
                self._restart_window(state["iteration"])

    def _train(self, step: TrainStep, state) -> None:
        self._pending = []
        self._reads = 0
        self._inflight = 0
        self._last_dispatch_end = None
        self._log_t = time.perf_counter()
        self._restart_window(state["iteration"])
        while not self.end_when(state):
            if self._preempted:
                # the signal came during epoch-edge work: still save
                self._save_checkpoint_once(step, state)
                break
            state["epoch_finished"] = False
            skip = int(state.pop("_resume_skip", 0) or 0)
            # an elastic resume: the epoch's remaining examples over the
            # new process set; epoch_batch keeps counting global steps
            reshard = state.pop("_resume_reshard", None)
            state["epoch_batch"] = (int(reshard["trained"])
                                    + int(reshard.get("skip", 0) or 0)
                                    if reshard else skip)
            ran_any = False
            bundles = bundle_batches(
                self._traced_data(self._epoch_batch_iter(
                    state["epoch"], skip, reshard)),
                lambda: self._bundle_span(state))
            try:
                for mbs in bundles:
                    ran_any = True
                    self._one_bundle(step, state, mbs)
                    t_trig = time.perf_counter()
                    self._fire_triggers(step, state)
                    # trigger work is not step time: the attribution's
                    # overhead component
                    trig_dt = time.perf_counter() - t_trig
                    self._log_t += trig_dt
                    self._attr_overhead += trig_dt
                    if self._preempted:
                        log.warning("preemption signal received: "
                                    "checkpointing at iteration %d and "
                                    "stopping", state["iteration"])
                        self._save_checkpoint_once(step, state)
                        break
                    if self.end_when(state):
                        break
                else:
                    if not ran_any and skip == 0 and reshard is None:
                        raise ValueError(
                            f"the dataset's {self.dataset.size()} rows "
                            f"give no batch of {self.batch_size}")
                    # a resume whose skip used up the epoch already fired
                    # this boundary's triggers before it was written
                    if ran_any or skip == 0 or reshard is not None:
                        state["epoch_finished"] = True
                        self._fire_triggers(step, state)
                    state["epoch"] += 1
                    # a re-sharded plan ends with its epoch
                    state.pop("reshard_origin", None)
            finally:
                bundles.close()
        if self._needs_reads():
            self._read_losses(keep=0)

    def _bundle_span(self, state) -> int:
        """How many steps the next bundle may take: to the next edge of
        the per-epoch grid of K, shortened to the next ``boundary`` edge
        of an iteration trigger, one step while a preemption is
        pending."""
        k = self._bundle_k
        if k <= 1 or self._preempted:
            return 1
        span = k - state.get("epoch_batch", 0) % k
        it = state["iteration"]
        for t in (self.end_when, self._val_trigger, self._ckpt_trigger,
                  self._summary_triggers.get("Parameters")):
            b = getattr(t, "boundary", None) if t is not None else None
            edge = b(it) if b is not None else None
            if edge is not None and 0 < edge < span:
                span = edge
        return span

    def _one_bundle(self, step: TrainStep, state, mbs) -> None:
        """Run the bundle ``mbs`` (device batches ``(x, y)``) from the
        current iteration: the step-scoped faults of its whole range
        first, then K eager steps' worth as one ``train_bundle`` (K > 1)
        or the eager step (K = 1)."""
        it0, k = state["iteration"], len(mbs)
        now = time.perf_counter()
        if self._last_dispatch_end is not None:
            self.metrics.observe("train.dispatch_gap_s",
                                 now - self._last_dispatch_end)
        with trace.span("train/bundle", step=it0, size=k):
            faults.fire_bundle(it0, k)
            if self.watchdog is not None:
                self.watchdog.step_started(it0)
            for j in range(k):
                with trace.span("train/step", step=it0 + j):
                    if self._profiler is not None:
                        self._profiler.step(it0 + j)
            with record_function("train/bundle"), \
                    trace.span("train/dispatch", step=it0, size=k):
                t0 = time.perf_counter()
                if self._bundle_k > 1:
                    losses, gnorms = step.train_bundle(
                        it0, [x for x, _ in mbs], [y for _, y in mbs])
                else:
                    ((x, y),) = mbs
                    losses, gnorms = step(it0, x, y).reshape(1), None
                disp_dt = time.perf_counter() - t0
                self.metrics.add("step_dispatch", disp_dt / k)
                self._attr_dispatch += disp_dt
        self._last_dispatch_end = time.perf_counter()
        self._recompile.note_step(it0 + k)
        # every step moves the same sync traffic (a static layout)
        if self._ici_bytes_step:
            self.metrics.inc("train.collective_ici_bytes_total",
                             self._ici_bytes_step * k)
        if self._dcn_bytes_step:
            self.metrics.inc("train.collective_dcn_bytes_total",
                             self._dcn_bytes_step * k)
        self._trained.append((it0, losses))
        if self._needs_reads():
            self._pending.append((it0, *self._to_host(losses, gnorms)))
        self._inflight += k
        self.metrics.gauge("train.steps_in_flight", self._inflight)
        self.metrics.gauge("train.bundle_size", k)
        state["loss"] = losses[-1]  # a device scalar; float() reads it
        state["iteration"] = it0 + k
        state["epoch_batch"] += k
        if self._needs_reads():
            self._read_losses(keep=1)

    def _pick_bundle_size(self, step_s: float) -> None:
        """``steps_per_call="auto"``: after the first timed window, K so
        that the host's dispatch is about 2% of a step (1 when it is
        already less), at most 32."""
        self._bundle_picked = True
        disp = self.metrics.mean("step_dispatch")
        ratio = disp / step_s if step_s > 0 else 0.0
        k = 1 if ratio < 0.02 else int(min(32, max(2, np.ceil(ratio
                                                              / 0.02))))
        if self._rank == 0:
            log.info("steps_per_call=auto: dispatch %.3f ms a step against "
                     "a %.3f ms step: bundles of %d", disp * 1e3,
                     step_s * 1e3, k)
            flight.record("bundle_auto_pick", k=k, dispatch_s=disp,
                          step_s=step_s)
        self._bundle_k = k

    def _epoch_batch_iter(self, epoch: int, skip: int, reshard=None):
        """One epoch's device batches of this process, ``(input,
        target)``: the streaming pipeline when the dataset has one (and
        ``streaming`` and ``host_prefetch > 0``), else ``batches()``
        behind ``thread_prefetch``, both through the device feed.  A
        resumed epoch skips its first ``skip`` batches; ``reshard`` (an
        elastic resume's ``{"process_count", "trained", "skip"}``) runs
        the epoch's re-sharded remainder plan instead."""
        kw = dict(shuffle=True, seed=self.seed, epoch=epoch,
                  process_id=self._plan_rank,
                  process_count=self._plan_count)
        prefix = ""
        if reshard is not None:
            kw.update(trained_batches=int(reshard["trained"]),
                      old_process_count=int(reshard["process_count"]))
            prefix = "resharded_"
            skip = int(reshard.get("skip", 0) or 0)
        stream = (self.streaming and self.host_prefetch > 0
                  and hasattr(self.dataset, prefix + "stream_batches"))
        if stream:
            # the pipeline's own threads are the host lookahead;
            # EngineConfig.data_workers sizes its decode pool (None:
            # autotune_workers)
            batch_iter = getattr(self.dataset, prefix + "stream_batches")(
                self.batch_size, metrics=self.metrics,
                workers=Engine.get().config.data_workers, **kw)
        else:
            batch_iter = getattr(self.dataset, prefix + "batches")(
                self.batch_size, **kw)
        if skip:
            batch_iter = _skip_closing(batch_iter, skip)
        if self.host_prefetch and not stream:
            # never stacked on the streaming path: a queue of RingBatches
            # would let their slots be refilled under the consumer
            batch_iter = thread_prefetch(batch_iter,
                                         depth=self.host_prefetch)
        return dispatch_to_device(
            batch_iter, lambda mb: (mb["input"], mb["target"]),
            size=self.prefetch, metrics=self.metrics, device=self.device)

    def _traced_data(self, batch_iter):
        """The data phase under a profiler range and a timer: each wait
        for the next device batch is time the card may spend idle, and
        lands in the ``train.data_wait_s`` histogram.  Closing this
        generator closes the feed (and the pipeline's threads)."""
        it = iter(batch_iter)
        try:
            while True:
                with record_function("train/data"), \
                        trace.span("train/data"), \
                        Timer(self.metrics, "data_time"):
                    t0 = time.perf_counter()
                    try:
                        mb = next(it)
                    except StopIteration:
                        return
                    self.metrics.observe("train.data_wait_s",
                                         time.perf_counter() - t0)
                yield mb
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _needs_reads(self) -> bool:
        """Whether anyone reads the losses as the run goes: the log
        points, a train summary, the watchdog, or ``"auto"`` timing its
        window."""
        return (bool(self.log_every) or self._train_summary is not None
                or self.watchdog is not None
                or (self._bundle_auto and not self._bundle_picked))

    def _to_host(self, losses, gnorms):
        """Start copying a bundle's losses (and gradient norms) to the
        host as soon as the bundle is done: on the card a copy into
        page-locked memory behind an event, so the read waits for this
        bundle alone, never for the ones queued after it."""
        if self.device.type != "cuda":
            return losses, gnorms, None
        host = [None if t is None else t.to("cpu", non_blocking=True)
                for t in (losses, gnorms)]
        # timed: a window's step time is the card's (_account_window)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        return host[0], host[1], done

    def _read_losses(self, keep: int) -> None:
        """Read every unread bundle but the newest ``keep`` (waiting for
        them): the train summary's scalars of each step, the gradient
        norms' histogram, then the watchdog's observations in step order
        (it may raise ``PoisonedStepError`` into the retry loop)."""
        while len(self._pending) > keep:
            it0, lv, gv, done = self._pending.pop(0)
            with trace.span("train/device_sync", step=it0):
                if done is not None:
                    done.synchronize()
                values = lv.tolist()
            now = time.perf_counter()
            dt, self._log_t = (now - self._log_t) / len(values), now
            self._inflight -= len(values)
            self._reads += 1
            if gv is not None:
                for g in gv.tolist():
                    self.metrics.observe("train.grad_norm", g)
            if self._train_summary is not None and self._rank == 0:
                for j, value in enumerate(values):
                    it = it0 + j + 1
                    lr = float(np.asarray(
                        self.optim_method.get_learning_rate(it - 1)))
                    self._train_summary.add_scalar("loss", value, it)
                    self._train_summary.add_scalar("lr", lr, it)
                    self._train_summary.add_scalar(
                        "throughput", self.batch_size / max(dt, 1e-9), it)
            if self.watchdog is not None:
                for j, value in enumerate(values):
                    self.watchdog.observe_loss(it0 + j, value)
            if self._should_log(it0, it0 + len(values)):
                self._account_window(it0 + len(values), now,
                                     timed=keep > 0, done=done)
            # the first read's window holds the set-up: time the second
            if self._bundle_auto and not self._bundle_picked \
                    and self._reads >= 2:
                self._pick_bundle_size(dt)
        self.metrics.gauge("train.steps_in_flight", self._inflight)

    def _fire_triggers(self, step: TrainStep, state) -> None:
        it = state["iteration"]
        if (self._val_trigger is not None and self._val_trigger(state)
                and self._last_val_iter != it):
            self._last_val_iter = it
            self._run_validation(step, state)
        if (self._ckpt_trigger is not None and self._ckpt_trigger(state)
                and self._last_ckpt_iter != it):
            self._last_ckpt_iter = it
            self._save_checkpoint(step, state)
        hist_trigger = self._summary_triggers.get("Parameters")
        if (hist_trigger is not None and self._train_summary is not None
                and hist_trigger(state) and self._last_hist_iter != it):
            self._last_hist_iter = it
            if self._rank != 0:
                return
            # the JAX tree's leaf order: paths in sorted order
            for name, p in sorted(step.model.named_parameters(),
                                  key=lambda kv: jax_path(kv[0])):
                self._train_summary.add_histogram(
                    "Parameters/" + "/".join(jax_path(name)),
                    p.detach().cpu().numpy(), it)

    def _run_validation(self, step: TrainStep, state) -> None:
        # every replica its own plan (each rank its sequence block under
        # seq_parallel); the sums are reduced over the ranks.  The run's
        # first validation is a new program (JAX's eval compile)
        first, self._validated = not self._validated, True
        with obs_attr.expected_compile() if first else nullcontext():
            results = evaluate(step.model, self._val_methods,
                               self._val_dataset.batches(
                                   self._val_batch, shuffle=False,
                                   drop_last=False,
                                   process_id=self._plan_rank,
                                   process_count=self._plan_count),
                               self.device, group=self._group,
                               seq=self._seq)
        self.validations.append((state["iteration"], results))
        if self._val_summary is not None and self._rank == 0:
            for r in results:
                self._val_summary.add_scalar(r.name, r.result,
                                             state["iteration"])
        if not results:
            return
        state["score"] = results[0].result
        state["n_validations"] = state.get("n_validations", 0) + 1
        schedule = getattr(self.optim_method, "schedule", None)
        if schedule is not None and hasattr(schedule, "on_score"):
            monitor = getattr(schedule, "monitor", None)
            picked = results[0]
            if monitor is not None:
                matches = [r for r in results if r.name == monitor]
                if not matches:
                    raise ValueError(
                        f"Plateau monitor {monitor!r} not among the "
                        f"validation methods {[r.name for r in results]}")
                picked = matches[0]
            # the next step's learning rate reads the new factor
            schedule.on_score(float(picked.result))

    def _save_checkpoint_once(self, step: TrainStep, state) -> None:
        """Checkpoint unless this iteration already was (the trigger may
        have fired just before a preemption stop)."""
        if self._last_ckpt_iter != state["iteration"]:
            self._last_ckpt_iter = state["iteration"]
            self._save_checkpoint(step, state)

    def _save_checkpoint(self, step: TrainStep, state) -> None:
        """Every rank calls this at the same iteration: the sharded format
        writes a shard a rank; the gathered one gathers (a collective)
        and rank 0 writes."""
        # every step up to here is read (and passed by the watchdog)
        # before it is persisted
        self._read_losses(keep=0)
        state["loss"] = float(state["loss"])
        snapshot = dict(state)
        # the batch plan is keyed by the process count: a resume under
        # another count re-shards the epoch (_try_resume)
        snapshot["process_count"] = self._plan_count
        schedule = getattr(self.optim_method, "schedule", None)
        if schedule is not None and hasattr(schedule, "state_dict"):
            snapshot["schedule_state"] = schedule.state_dict()
        # block-sparse masks are host state of the modules, not
        # parameters: they ride the driver state, so a resumed process
        # trains the same sparsity pattern, not dense again
        masks = collect_masks(self.model)
        if masks:
            snapshot["block_sparse_masks"] = masks
        # the ranks of a seq group hold the same optimizer shard: a
        # seq-axis run saves the gathered state
        seq_axis_up = self._world > self._plan_count
        if seq_axis_up and self._ckpt_sharded is True:
            raise ValueError("set_checkpoint(sharded=True) on a mesh with "
                             "a seq axis: the sequence ranks share their "
                             "shards; use sharded='auto' or False")
        sharded = self.optim_method.elementwise and not seq_axis_up and (
            self._world > 1 if self._ckpt_sharded == "auto"
            else bool(self._ckpt_sharded))
        kw = dict(step.checkpoint_arrays(opt=not sharded),
                  driver_state=snapshot, mirror=self._ckpt_mirror)
        if sharded:
            shards, offset, whole = step.opt_shard()
            kw.update(opt_shards=ckpt.local_opt_shards(shards, offset, whole),
                      shard_index=self._rank, shard_count=self._world,
                      attempt=self._attempt_token())
            # a barrier on the writer thread could interleave with the
            # step's collectives: asynchronous saves go without, and the
            # reader checks every shard of the attempt instead
            if self._ckpt_async is None and self._world > 1:
                kw["barrier"] = lambda: dist.barrier(group=self._group)
        elif self._rank != 0:
            return
        if self._ckpt_async is not None:
            self._ckpt_async.submit(self._ckpt_path, state["iteration"],
                                    **kw)
        else:
            ckpt.save_checkpoint(self._ckpt_path, state["iteration"], **kw)

    def _attempt_token(self) -> str:
        """One token a save, the same on every rank: rank 0's, broadcast
        on the main thread."""
        tok = [uuid.uuid4().hex[:8] if self._rank == 0 else None]
        if self._world > 1:
            dist.broadcast_object_list(tok, src=0, group=self._group)
        return tok[0]

    def _try_resume(self, step: TrainStep, state) -> None:
        """Restore the newest complete checkpoint under the path, if any,
        and skip the batches of its epoch that it had already trained.
        A checkpoint of another process count mid-epoch re-shards the
        epoch's remaining examples over this process set (or replays the
        epoch when the dataset cannot re-shard, or the set changed twice
        within it)."""
        latest = ckpt.latest_checkpoint(self._ckpt_path)
        if latest is None:
            return
        flat, opt_state, model_state, saved, ema = ckpt.load_checkpoint(
            latest)
        step.restore(flat, opt_state, model_state, ema)
        state.update(saved)
        masks = state.pop("block_sparse_masks", None)
        before = collect_masks(self.model) if masks else None
        restore_block_sparse_masks(self.model, step, masks)
        if masks and collect_masks(self.model) != before:
            # the effective FLOPs moved with the pattern
            self._refresh_cost_model()
        sched_state = state.pop("schedule_state", None)
        schedule = getattr(self.optim_method, "schedule", None)
        if sched_state is not None and schedule is not None \
                and hasattr(schedule, "load_state_dict"):
            schedule.load_state_dict(sched_state)
        state["epoch_finished"] = False
        it = int(saved.get("iteration", 0) or 0)
        self._last_ckpt_iter = min(self._last_ckpt_iter, it)
        self._last_val_iter = min(self._last_val_iter, it)
        self._last_hist_iter = min(self._last_hist_iter, it)
        state["epoch_batch"] = int(saved.get("epoch_batch", 0) or 0)
        state["_resume_skip"] = state["epoch_batch"]
        saved_pc = saved.get("process_count")
        state["process_count"] = self._plan_count
        origin = saved.get("reshard_origin")
        pc_changed = saved_pc is not None \
            and int(saved_pc) != self._plan_count
        can_reshard = hasattr(self.dataset, "resharded_batches")
        if origin is not None and state["_resume_skip"]:
            # into an epoch already on a re-sharded plan: the same plan,
            # past the batches trained on it
            if pc_changed or not can_reshard:
                self._replay_epoch(state, saved_pc, "the process set "
                                   "changed again mid-epoch")
            else:
                base = int(origin["trained"])
                state["_resume_reshard"] = {
                    "process_count": int(origin["process_count"]),
                    "trained": base,
                    "skip": max(0, state["epoch_batch"] - base)}
                state["_resume_skip"] = 0
        elif pc_changed and state["_resume_skip"]:
            if can_reshard:
                if self._rank == 0:
                    log.warning(
                        "elastic resume: checkpoint written at "
                        "process_count=%d, resuming at %d — epoch %d "
                        "continues on a re-sharded batch plan (the %d "
                        "already-trained global batches are excluded; "
                        "nothing replays, nothing is dropped)",
                        int(saved_pc), self._plan_count, state["epoch"],
                        state["epoch_batch"])
                state["_resume_reshard"] = {
                    "process_count": int(saved_pc),
                    "trained": state["epoch_batch"], "skip": 0}
                state["reshard_origin"] = {
                    "process_count": int(saved_pc),
                    "trained": state["epoch_batch"]}
                state["_resume_skip"] = 0
                self.metrics.inc("elastic_resumes_total")
                self.metrics.inc("elastic_resharded_total")
                flight.record("elastic_reshard", epoch=state["epoch"],
                              old_pc=int(saved_pc),
                              new_pc=self._plan_count,
                              trained=state["epoch_batch"])
            else:
                self._replay_epoch(state, saved_pc,
                                   "the per-process batch plan differs and "
                                   "this dataset cannot reshard mid-epoch")

    def _replay_epoch(self, state, saved_pc, why: str) -> None:
        if self._rank == 0:
            log.warning(
                "elastic resume: checkpoint written at process_count=%s, "
                "resuming at %d — %s, so epoch %d REPLAYS from its start "
                "(%d mid-epoch batches re-trained rather than silently "
                "dropped)", saved_pc, self._plan_count, why, state["epoch"],
                state["_resume_skip"])
        state["epoch_batch"] = 0
        state["_resume_skip"] = 0
        state.pop("reshard_origin", None)
        self.metrics.inc("elastic_resumes_total")


def restore_block_sparse_masks(model: torch.nn.Module, step: TrainStep,
                               masks) -> int:
    """Set a checkpoint's block-sparse ``masks`` (``collect_masks``) on
    ``model``; returns how many modules took one.  Where the pattern
    changed (a fresh process starts all-ones), ``step``'s captured
    bundles replay the old pattern's column plans: they are dropped and
    captured again on the next steps, and the flight recorder notes the
    restore (JAX's ``block_sparse_masks_restored``)."""
    if not masks:
        return 0
    before = collect_masks(model)
    with obs_attr.expected_compile():
        n = apply_masks(model, masks)
    if n and collect_masks(model) != before:
        # the next captures are a new program's, as JAX's retrace is
        step.drop_graphs()
        log.info("restored block-sparse masks for %d modules; step graphs "
                 "are captured again", n)
        flight.record("block_sparse_masks_restored", modules=n)
    return n


def _skip_closing(inner, n):
    """``inner`` past its first ``n`` items; closing this generator
    closes ``inner`` (a bare islice has no close(), and an abandoned
    resumed epoch must still shut its pipeline's threads down)."""
    try:
        yield from itertools.islice(inner, n, None)
    finally:
        close = getattr(inner, "close", None)
        if close is not None:
            close()
