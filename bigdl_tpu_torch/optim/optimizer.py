"""Optimizer — the port of the single-device training loop of
``bigdl_tpu.optim.optimizer``.

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

``set_checkpoint`` writes the single-writer format of
``optim.checkpoint``; ``optimize()`` first resumes from the newest
checkpoint under the path (parameters, optimizer slots, BatchNorm
buffers, EMA, the loop's state and a ``Plateau``'s state) and goes on
with the epoch's batch order from ``epoch_batch``.  The step's knobs
``accum_steps``, ``remat``, ``remat_policy``, ``ema_decay`` and
``trainable_mask`` are attributes, as on the JAX Optimizer.  A model with
lazy widths (``Linear(out)``, ``BatchNorm()``, ``PReLU()``) is built
from one sample row before its parameters are collected.

Not ported: the cluster hooks (``set_cluster``, gang recovery,
cluster-wide preemption notices), the multi-device ZeRO-1 step,
sharded checkpoints and mirrors, and the elastic re-sharded resume
(ROADMAP A.2); the attribution and MFU accounting and the Prometheus
export (A.6.7)."""

import itertools
import logging
import signal
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.data.pipeline import bundle_batches, dispatch_to_device
from bigdl_tpu_torch.data.prefetch import thread_prefetch
from bigdl_tpu_torch.nn.freeze import has_frozen, trainable_mask_for
from bigdl_tpu_torch.nn.layers import has_lazy
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim import checkpoint as ckpt
from bigdl_tpu_torch.optim.metrics import Metrics, SummaryWriter, Timer
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import (GradientClipping, TrainStep,
                                              evaluate, to_device)
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
    evaluation."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 step: Optional[TrainStep] = None):
        self.model = model
        self.device = device
        self._step = step

    @property
    def variables(self) -> Dict[str, Any]:
        return export_variables(self.model)

    @property
    def ema_variables(self) -> Optional[Dict[str, Any]]:
        """The EMA weights (with the live BatchNorm state) when the run
        kept one (``ema_decay``), else None; evaluate them through
        ``set_variables(trained.ema_variables)``."""
        if self._step is None or self._step.ema is None:
            return None
        return self._step.get_variables(ema=True)

    def set_variables(self, variables: Dict[str, Any]) -> None:
        """Copy a ``{"params", "state"}`` tree into the model."""
        load_jax_variables(self.model, variables)

    @torch.no_grad()
    def predict(self, x, batch_size: int = 0) -> np.ndarray:
        """The model's outputs for the host array ``x``, in batches of
        ``batch_size`` rows (all at once for 0)."""
        self.model.train(False)
        n = len(x)
        step = batch_size if batch_size > 0 else max(n, 1)
        return np.concatenate([
            self.model(to_device(x[i:i + step], self.device)).cpu().numpy()
            for i in range(0, n, step)])

    def evaluate(self, dataset: DataSet,
                 methods: Sequence[ValidationMethod],
                 batch_size: int = 128) -> List[ValidationResult]:
        """Every method over ``dataset`` in order, every row once, in
        eval mode on the training device."""
        return evaluate(self.model, list(methods), dataset.batches(
            batch_size, shuffle=False, drop_last=False), self.device)


class Optimizer:
    """Sets up and runs one device's training.  ``device=None``
    is ``cuda``; without CUDA the caller must pass ``device="cpu"``."""

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
        """Checkpoint into the local directory ``path`` whenever
        ``trigger`` fires; ``async_write`` snapshots the tensors to the
        host at the trigger and writes on a background thread, one write
        in flight.  Sharded checkpoints and mirrors come with
        multi-device training (ROADMAP A.2)."""
        if sharded is True or mirror is not None:
            raise ValueError(
                "sharded checkpoints and mirrors need the multi-device "
                "port (ROADMAP A.2); this Optimizer writes the single-writer "
                "format")
        self._ckpt_path = path
        self._ckpt_trigger = trigger
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

    def set_preemption_checkpoint(self, *signals) -> "Optimizer":
        """Checkpoint and stop cleanly when the process receives one of
        ``signals`` (default SIGTERM, what a preempted machine gets); the
        handler only sets a flag, the loop saves at its next bundle
        edge.  Requires ``set_checkpoint``."""
        self._preempt_signals = signals or (signal.SIGTERM,)
        return self

    @property
    def final_state(self) -> Optional[Dict[str, Any]]:
        """The loop's state at the end of the last ``optimize()``."""
        return self._final_state

    # ---- the training loop --------------------------------------------------
    def _prepare_model(self) -> torch.nn.Module:
        model = self.model.to(self.device)
        if has_lazy(model):
            sample = next(iter(self.dataset.batches(
                self.batch_size, shuffle=False)))["input"]
            with torch.no_grad():
                model.train(False)
                model(to_device(sample[:1], self.device))
        if self._initial_variables is not None:
            load_jax_variables(model, self._initial_variables)
        return model

    def optimize(self) -> TrainedModel:
        config = Engine.get().config
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
        model = self._prepare_model()
        mask = self.trainable_mask
        if mask is None and has_frozen(model):
            mask = trainable_mask_for(model)
        step = TrainStep(model, self.criterion, self.optim_method,
                         clip=self.clip, seed=self.seed,
                         accum_steps=self.accum_steps,
                         ema_decay=self.ema_decay, remat=self.remat,
                         remat_policy=self.remat_policy,
                         trainable_mask=mask)
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
        return TrainedModel(model, self.device, step)

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
                time.sleep(delay)
                with record_function("resilience/in_run_resume"):
                    self._try_resume(step, state)
                self._trained = [(i, lv) for i, lv in self._trained
                                 if i < state["iteration"]]
                self.metrics.inc("recoveries_total")
                self.metrics.inc(f"retries_by_cause.{cause.value}")
                self.metrics.inc("time_lost_to_recovery_s",
                                 time.perf_counter() - t_fail)
                # recovery is not step time
                self.metrics.reset()

    def _train(self, step: TrainStep, state) -> None:
        self._pending = []
        self._reads = 0
        self._inflight = 0
        self._last_dispatch_end = None
        self._log_t = time.perf_counter()
        while not self.end_when(state):
            if self._preempted:
                # the signal came during epoch-edge work: still save
                self._save_checkpoint_once(step, state)
                break
            state["epoch_finished"] = False
            skip = int(state.pop("_resume_skip", 0) or 0)
            state["epoch_batch"] = skip
            ran_any = False
            bundles = bundle_batches(
                self._traced_data(self._epoch_batch_iter(state["epoch"],
                                                         skip)),
                lambda: self._bundle_span(state))
            try:
                for mbs in bundles:
                    ran_any = True
                    self._one_bundle(step, state, mbs)
                    t_trig = time.perf_counter()
                    self._fire_triggers(step, state)
                    # trigger work is not step time
                    self._log_t += time.perf_counter() - t_trig
                    if self._preempted:
                        log.warning("preemption signal received: "
                                    "checkpointing at iteration %d and "
                                    "stopping", state["iteration"])
                        self._save_checkpoint_once(step, state)
                        break
                    if self.end_when(state):
                        break
                else:
                    if not ran_any and skip == 0:
                        raise ValueError(
                            f"the dataset's {self.dataset.size()} rows "
                            f"give no batch of {self.batch_size}")
                    # a resume whose skip used up the epoch already fired
                    # this boundary's triggers before it was written
                    if ran_any or skip == 0:
                        state["epoch_finished"] = True
                        self._fire_triggers(step, state)
                    state["epoch"] += 1
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
        faults.fire_bundle(it0, k)
        if self.watchdog is not None:
            self.watchdog.step_started(it0)
        if self._profiler is not None:
            for j in range(k):
                self._profiler.step(it0 + j)
        with record_function("train/bundle"):
            t0 = time.perf_counter()
            if self._bundle_k > 1:
                losses, gnorms = step.train_bundle(
                    it0, [x for x, _ in mbs], [y for _, y in mbs])
            else:
                ((x, y),) = mbs
                losses, gnorms = step(it0, x, y).reshape(1), None
            self.metrics.add("step_dispatch",
                             (time.perf_counter() - t0) / k)
        self._last_dispatch_end = time.perf_counter()
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
        log.info("steps_per_call=auto: dispatch %.3f ms a step against a "
                 "%.3f ms step: bundles of %d", disp * 1e3, step_s * 1e3, k)
        self._bundle_k = k

    def _epoch_batch_iter(self, epoch: int, skip: int):
        """One epoch's device batches, ``(input, target)``: the streaming
        pipeline when the dataset has one (and ``streaming`` and
        ``host_prefetch > 0``), else ``batches()`` behind
        ``thread_prefetch``, both through the device feed.  A resumed
        epoch skips its first ``skip`` batches."""
        kw = dict(shuffle=True, seed=self.seed, epoch=epoch)
        stream = (self.streaming and self.host_prefetch > 0
                  and hasattr(self.dataset, "stream_batches"))
        if stream:
            # the pipeline's own threads are the host lookahead;
            # EngineConfig.data_workers sizes its decode pool (None:
            # autotune_workers)
            batch_iter = self.dataset.stream_batches(
                self.batch_size, metrics=self.metrics,
                workers=Engine.get().config.data_workers, **kw)
        else:
            batch_iter = self.dataset.batches(self.batch_size, **kw)
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
        """Whether anyone reads the losses as the run goes: a train
        summary, the watchdog, or ``"auto"`` timing its window."""
        return (self._train_summary is not None or self.watchdog is not None
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
        done = torch.cuda.Event()
        done.record()
        return host[0], host[1], done

    def _read_losses(self, keep: int) -> None:
        """Read every unread bundle but the newest ``keep`` (waiting for
        them): the train summary's scalars of each step, the gradient
        norms' histogram, then the watchdog's observations in step order
        (it may raise ``PoisonedStepError`` into the retry loop)."""
        while len(self._pending) > keep:
            it0, lv, gv, done = self._pending.pop(0)
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
            if self._train_summary is not None:
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
            # the JAX tree's leaf order: paths in sorted order
            for name, p in sorted(step.model.named_parameters(),
                                  key=lambda kv: jax_path(kv[0])):
                self._train_summary.add_histogram(
                    "Parameters/" + "/".join(jax_path(name)),
                    p.detach().cpu().numpy(), it)

    def _run_validation(self, step: TrainStep, state) -> None:
        results = evaluate(step.model, self._val_methods,
                           self._val_dataset.batches(
                               self._val_batch, shuffle=False,
                               drop_last=False), self.device)
        self.validations.append((state["iteration"], results))
        if self._val_summary is not None:
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
        # every step up to here is read (and passed by the watchdog)
        # before it is persisted
        self._read_losses(keep=0)
        state["loss"] = float(state["loss"])
        snapshot = dict(state)
        schedule = getattr(self.optim_method, "schedule", None)
        if schedule is not None and hasattr(schedule, "state_dict"):
            snapshot["schedule_state"] = schedule.state_dict()
        kw = dict(step.checkpoint_arrays(), driver_state=snapshot)
        if self._ckpt_async is not None:
            self._ckpt_async.submit(self._ckpt_path, state["iteration"],
                                    **kw)
        else:
            ckpt.save_checkpoint(self._ckpt_path, state["iteration"], **kw)

    def _try_resume(self, step: TrainStep, state) -> None:
        """Restore the newest checkpoint under the path, if any, and
        skip the batches of its epoch that it had already trained."""
        latest = ckpt.latest_checkpoint(self._ckpt_path)
        if latest is None:
            return
        flat, opt_state, model_state, saved, ema = ckpt.load_checkpoint(
            latest)
        step.restore(flat, opt_state, model_state, ema)
        state.update(saved)
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
