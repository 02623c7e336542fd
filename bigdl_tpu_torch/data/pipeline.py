"""Streaming input pipeline — the port of ``bigdl_tpu.data.pipeline``:
stage-parallel read → decode/augment → batch-assemble → device feed over
bounded queues and a buffer ring.

- :class:`BufferRing` — a fixed pool of preallocated output buffers with a
  strict slot state machine (FREE → ASSIGNED → READY → LENT → FREE).  Decode
  workers write into ring slots, so steady-state batch assembly performs no
  numpy allocation; a slot is never handed to a producer while a consumer
  (or an in-flight host-to-device copy) still holds it.

- :class:`StreamingPipeline` — the stage graph.  A single read thread pulls
  work items in plan order, claims the next ring slot, fetches the item's
  raw bytes (mmap record gather / file read), splits the batch into
  sub-ranges, and feeds a pool of decode workers.  Workers run the
  decode/augment hot loop (native ``BatchPipeline`` calls release the GIL;
  the PIL fallback fans out to a shared-memory process pool) straight into
  their slice of the slot.  The consumer side yields batches strictly in
  plan order, so output is byte-identical for 1 or N workers —
  augmentation geometry must be carried by the plan, never drawn from a
  worker-scheduled RNG.

- :func:`dispatch_to_device` — the device feed.  On a CUDA device each ring
  slot is page-locked once (registered with the CUDA runtime, cached by
  pointer) and copied straight from the slot on a side stream; the
  consumer's stream waits on the copy's event, and a slot goes back to
  the ring only after its own copy event has completed.

- :func:`autotune_depths` / :func:`autotune_workers` — queue, ring and
  pool sizing from measured stage rates and the host's cores.

Observability: stage-throughput counters (``data.read_batches`` /
``data.decoded_images`` / ``data.ready_batches``), queue-depth gauges
(``data.queue_depth.*``), per-stage profiler ranges (``data/read``,
``data/decode``), the feed's ``data.dispatch.in_flight`` gauge and
``data.dispatch_overlapped_total`` counter, and the consumer-side
``train.data_wait_s`` histogram recorded by the optimizer.
"""

import math
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from torch.profiler import record_function

from bigdl_tpu_torch.data.dataset import MiniBatch

# slot states
_FREE, _ASSIGNED, _READY, _LENT = range(4)


class PipelineError(RuntimeError):
    """A pipeline stage died; raised at the consumer's next pull (never a
    hang) with the original exception as ``__cause__``."""


class RingBatch(MiniBatch):
    """A minibatch whose arrays are views over a ring slot.  The consumer
    MUST call :meth:`release` (or iterate via a driver that does) once the
    data has been consumed — i.e. copied, or transferred to device with the
    transfer complete — so the slot can be refilled.  Reading the arrays
    after ``release()`` observes the next batch's bytes by design."""

    def __init__(self, release: Callable[[], None], **fields):
        super().__init__(**fields)
        object.__setattr__(self, "_release_fn", release)
        object.__setattr__(self, "_released", False)

    def release(self) -> None:
        if not self._released:
            object.__setattr__(self, "_released", True)
            self._release_fn()

    def defer_release(self) -> Callable[[], None]:
        """Transfer slot-release ownership to the caller: the batch is
        marked released — the pipeline's post-yield auto-release becomes
        a no-op — and the underlying slot release is RETURNED instead of
        run.  The dispatch stage needs this: with transfers in flight the
        consumer pulls batch k+1 (which fires the auto-release for k)
        BEFORE transfer k has been synced, so without ownership transfer
        the slot would free mid-DMA and the no-aliasing invariant would
        hold only on paper."""
        if self._released:
            return lambda: None
        object.__setattr__(self, "_released", True)
        return self._release_fn


class BufferRing:
    """Preallocated reusable output buffers with a slot state machine.

    ``spec``: name -> (shape, dtype) per buffer in a slot; ``depth`` slots
    are allocated up front (or supplied via ``slots`` — e.g. views into a
    shared-memory block the multiprocess decode pool writes through) and
    recycled with zero steady-state allocation.  Slots are ASSIGNED by the
    (ordered) read stage, so batch ``k``'s slot exists before ``k+1``'s is
    requested — the classic reorder deadlock (every slot READY ahead of the
    sequence the consumer needs) cannot form."""

    def __init__(self, spec: Dict[str, tuple], depth: int,
                 slots: Optional[List[Dict[str, np.ndarray]]] = None):
        if depth < 2:
            raise ValueError(f"ring depth must be >= 2, got {depth}")
        self.depth = depth
        self.spec = dict(spec)
        if slots is not None:
            if len(slots) != depth:
                raise ValueError(
                    f"{len(slots)} preallocated slots for depth {depth}")
            self._slots = slots
        else:
            self._slots = [
                {k: np.empty(shape, dtype)
                 for k, (shape, dtype) in spec.items()}
                for _ in range(depth)]
        self._state = [_FREE] * depth
        self._meta: List[Optional[dict]] = [None] * depth
        self._seq = [-1] * depth
        self._pending = [0] * depth
        self._lock = threading.Lock()
        self._free_cv = threading.Condition(self._lock)
        self._ready_cv = threading.Condition(self._lock)

    # -- producer side -----------------------------------------------------
    def assign(self, seq: int, parts: int, stop: threading.Event,
               timeout: float = 0.1) -> Optional[int]:
        """Claim a FREE slot for batch ``seq`` (to be committed in
        ``parts`` pieces).  Polls ``stop`` so an abandoned pipeline never
        wedges its read thread; returns None once stopped."""
        with self._lock:
            while True:
                for i in range(self.depth):
                    if self._state[i] == _FREE:
                        self._state[i] = _ASSIGNED
                        self._seq[i] = seq
                        self._pending[i] = parts
                        self._meta[i] = {}
                        return i
                if stop.is_set():
                    return None
                self._free_cv.wait(timeout)

    def buffers(self, slot: int) -> Dict[str, np.ndarray]:
        return self._slots[slot]

    def part_done(self, slot: int, meta: Optional[dict] = None) -> None:
        """One decode sub-range finished; the slot turns READY when every
        part has reported."""
        with self._lock:
            if self._state[slot] != _ASSIGNED:
                raise PipelineError(
                    f"part_done on slot {slot} in state {self._state[slot]} "
                    "(ring protocol violation)")
            if meta:
                self._meta[slot].update(meta)
            self._pending[slot] -= 1
            if self._pending[slot] == 0:
                self._state[slot] = _READY
                self._ready_cv.notify_all()

    # -- consumer side -----------------------------------------------------
    def pop(self, seq: int, stop: threading.Event,
            error: Callable[[], Optional[BaseException]],
            drained: Optional[Callable[[], bool]] = None,
            timeout: float = 0.1):
        """Block until batch ``seq`` is READY, lend it out.  Returns
        ``(slot, buffers, meta)``, or ``None`` once ``drained()`` reports
        the plan ended before ``seq``; re-raises a pipeline error instead
        of hanging when a stage died.  ``drained`` is re-checked inside
        the wait loop — a plan that runs dry (or is empty) after the
        consumer has already parked here must wake it, not spin forever."""
        with self._lock:
            while True:
                for i in range(self.depth):
                    if self._state[i] == _READY and self._seq[i] == seq:
                        self._state[i] = _LENT
                        return i, self._slots[i], self._meta[i]
                err = error()
                if err is not None:
                    raise PipelineError(
                        "input pipeline stage failed") from err
                if drained is not None and drained():
                    return None
                if stop.is_set():
                    raise PipelineError("input pipeline closed")
                self._ready_cv.wait(timeout)

    def release(self, slot: int) -> None:
        with self._lock:
            if self._state[slot] != _LENT:
                raise PipelineError(
                    f"release of slot {slot} in state {self._state[slot]} "
                    "(double release, or releasing an unpopped slot)")
            self._state[slot] = _FREE
            self._seq[slot] = -1
            self._meta[slot] = None
            self._free_cv.notify_all()

    def depth_in_use(self) -> int:
        with self._lock:
            return sum(1 for s in self._state if s != _FREE)

    def _wake_all(self) -> None:
        with self._lock:
            self._ready_cv.notify_all()
            self._free_cv.notify_all()


def autotune_depths(read_rate: float, decode_rate: float, workers: int,
                    parts_per_batch: Optional[int] = None) -> Dict[str, int]:
    """Queue/ring depths from measured stage rates (img/s or batch/s — only
    the ratio matters).  When the reader is much faster than decode (the
    common mmap-vs-augment case) extra read lookahead is pure memory cost,
    so the raw-queue depth shrinks toward the per-batch part count.

    Ring sizing follows who fills a slot: with sub-batch parts (the
    default, ``parts_per_batch == workers``) every worker writes the SAME
    slot, so 4 slots cover filling + READY + LENT + assign headroom — big
    image batches make each extra slot hundreds of MB, so oversizing is
    real memory and page-fault cost.  With whole-batch parts each worker
    fills its own slot and the ring widens to ``workers + 3``."""
    workers = max(1, workers)
    parts = workers if parts_per_batch is None else max(1, parts_per_batch)
    if read_rate <= 0 or decode_rate <= 0:
        ratio = 1.0
    else:
        ratio = decode_rate / read_rate  # >1 → reader is the slow stage
    raw_depth = int(min(4, max(1, round(2 * ratio))))
    ring_depth = 4 if parts > 1 or workers == 1 else workers + 3
    return {"raw_depth": raw_depth, "ring_depth": ring_depth}


def autotune_workers(decode_rate: float = 0.0, target_rate: float = 0.0,
                     host_cores: Optional[int] = None,
                     reserve: int = 2) -> int:
    """Decode-pool width from probed stage rates: enough workers for the pool to match ``target_rate`` (the
    read stage's rate, or the device's demand) at ``decode_rate`` per
    worker, capped at the host's cores minus ``reserve`` (the read thread
    and the driver's dispatch loop must stay responsive).  With no rates —
    decode cost unknown before the first batch, the vision-augment case —
    the pool takes the whole ceiling: decode is the slow stage there by
    construction, and an idle worker just parks on the raw queue.

    The reserve only bites once the host has cores to spare: a 2-core
    host still gets 2 workers, never ``cores - reserve = 0``."""
    cores = host_cores if host_cores is not None else host_core_count()
    ceiling = max(1, min(cores, max(2, cores - max(0, reserve))))
    if decode_rate > 0 and target_rate > 0:
        return max(1, min(ceiling, math.ceil(target_rate / decode_rate)))
    return ceiling


def host_core_count() -> int:
    """Cores THIS process may schedule on: the affinity mask when the
    platform exposes one (cgroup-limited containers and taskset'd jobs
    report the quota, not the node), ``os.cpu_count()`` otherwise.
    Sizing a decode pool from the node's 128 cores inside a 4-CPU pod
    oversubscribes 32x — exactly what the old fixed caps accidentally
    protected against."""
    try:
        return len(os.sched_getaffinity(0)) or (os.cpu_count() or 2)
    except AttributeError:  # pragma: no cover — non-Linux platforms
        return os.cpu_count() or 2


def fill_pad_weights(w: np.ndarray, n_real: int, lo: int, hi: int) -> None:
    """Write rows ``[lo, hi)`` of a batch's weight vector: 1.0 for genuine
    rows, 0.0 for cyclic-pad rows at index >= ``n_real`` (the
    batch_index_plan tail contract) — shared by every decode adapter so
    the sub-range clamp lives in one place."""
    sub = w[lo:hi]
    sub[:] = 1.0
    if n_real < len(w) and max(n_real, lo) < hi:
        sub[max(n_real, lo) - lo:] = 0.0


def cached_slots(cache: Dict, spec: Dict[str, tuple],
                 depth: int) -> List[Dict[str, np.ndarray]]:
    """Ring slots reused ACROSS pipelines (one `stream_batches` call per
    epoch must not re-allocate — and re-page-fault — hundreds of MB of
    batch buffers every epoch).  ``cache`` is adapter-owned, keyed by
    (spec, depth); slot state lives in each epoch's fresh BufferRing, only
    the arrays persist."""
    key = (tuple(sorted((k, tuple(shape), np.dtype(dt).str)
                        for k, (shape, dt) in spec.items())), depth)
    slots = cache.get(key)
    if slots is None:
        slots = cache[key] = [
            {k: np.empty(shape, dt) for k, (shape, dt) in spec.items()}
            for _ in range(depth)]
    return slots


class StreamingPipeline:
    """Run ``fetch`` (ordered, one thread) and ``decode`` (worker pool,
    sub-batch parallel) concurrently, connected by a bounded raw queue and
    a :class:`BufferRing`; iterate the results strictly in plan order.

    Parameters
    ----------
    plan: iterable of work items (one per output batch, in order).  Each
        item must carry everything decode needs — including any
        augmentation geometry — so output bytes are independent of worker
        count and scheduling.
    fetch: ``fetch(item, slot) -> raw``; runs on the read thread (the IO
        stage).  ``slot`` is the ring slot already claimed for this batch,
        so a reusable per-slot staging buffer can back the raw bytes.
    decode: ``decode(item, raw, buffers, lo, hi, slot) -> meta | None``;
        runs on a worker thread and MUST write only rows ``[lo, hi)`` of
        the ring buffers.  Metas from all parts of a batch are merged.
    out_spec: ring buffer spec (name -> (shape, dtype)), full-batch shapes.
    rows: leading-dim size of a full batch (how sub-ranges are split).
    workers: decode worker threads (default: host cores, min 1).
    parts_per_batch: decode sub-ranges per batch (default: ``workers``).
    raw_depth / ring_depth: stage queue sizes (``autotune_depths`` output;
        adapters probe stage rates and pass tuned values).
    slots: optional preallocated ring slots (shared-memory views for the
        multiprocess decode path).
    finalize: ``finalize(buffers, meta) -> dict`` mapping a READY slot onto
        the yielded minibatch fields; default uses the buffers as-is
        (trimmed to ``meta["n"]`` rows) plus any array-valued meta.
    metrics: a ``bigdl_tpu_torch.optim.metrics.Metrics`` registry; stage
        counters and queue-depth gauges land here (``<name>.*``).
    """

    def __init__(self, plan: Iterable[Any], fetch: Callable[[Any, int], Any],
                 decode: Callable[..., Optional[dict]],
                 out_spec: Dict[str, tuple], rows: int,
                 workers: Optional[int] = None,
                 parts_per_batch: Optional[int] = None,
                 raw_depth: Optional[int] = None,
                 ring_depth: Optional[int] = None,
                 slots: Optional[List[Dict[str, np.ndarray]]] = None,
                 finalize: Optional[Callable[[dict, dict], dict]] = None,
                 on_close: Optional[Callable[[], None]] = None,
                 metrics=None, name: str = "data"):
        import queue as _queue

        self.workers = max(1, workers if workers is not None
                           else host_core_count())
        # never more parts than rows: a pool wider than the batch would
        # otherwise split into zero-row sub-ranges (autosized pools on
        # many-core hosts meet small batches in tests and probes)
        self.parts = max(1, min(rows if rows else 1,
                                parts_per_batch if parts_per_batch
                                is not None else self.workers))
        self.rows = rows
        self._fetch = fetch
        self._decode = decode
        self._finalize = finalize
        self._on_close = on_close
        self._plan = iter(plan)
        self._metrics = metrics
        self._name = name
        if ring_depth is None or raw_depth is None:
            tuned = autotune_depths(0, 0, self.workers)
            raw_depth = raw_depth or tuned["raw_depth"]
            ring_depth = ring_depth or tuned["ring_depth"]
        self.ring = BufferRing(out_spec, ring_depth, slots=slots)
        # depth in PART jobs: raw_depth batches' worth keeps workers fed
        # without unbounded raw staging
        self._raw: "_queue.Queue" = _queue.Queue(
            maxsize=max(1, raw_depth) * self.parts)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._n_planned: Optional[int] = None  # set when the plan runs dry
        self._t0 = time.perf_counter()  # stage_rates' measured window
        self._read_s = 0.0
        self._decode_s = 0.0
        self._read_n = 0
        self._decode_n = 0
        # backpressure accounting: time each stage spent BLOCKED on its
        # neighbour (read waiting for a free slot / queue space = the
        # downstream stages are the bottleneck; decode waiting for work =
        # the read stage is) — exported as data.backpressure.* gauges so
        # one /metrics scrape names the capping stage
        self._read_blocked_s = 0.0
        self._decode_starved_s = 0.0
        self._rows_out = 0
        self._rate_lock = threading.Lock()  # decode counters are updated
        #                                     from every worker thread
        self._closed = False
        self._threads: List[threading.Thread] = [
            threading.Thread(target=self._read_loop,
                             name=f"bigdl-tpu-torch-{name}-read", daemon=True)]
        for i in range(self.workers):
            self._threads.append(threading.Thread(
                target=self._decode_loop,
                name=f"bigdl-tpu-torch-{name}-decode-{i}", daemon=True))
        for t in self._threads:
            t.start()

    # -- stage threads -----------------------------------------------------
    def _fail(self, e: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = e
        self._stop.set()
        self.ring._wake_all()

    def _get_error(self) -> Optional[BaseException]:
        with self._error_lock:
            return self._error

    def _read_loop(self) -> None:
        import queue as _queue

        seq = 0
        try:
            for item in self._plan:
                if self._stop.is_set():
                    return
                # slot FIRST: ring occupancy is the pipeline's natural
                # backpressure, and per-slot staging buffers stay safe to
                # reuse (nothing reads slot k's staging after it frees)
                tb = time.perf_counter()
                slot = self.ring.assign(seq, self.parts, self._stop)
                self._read_blocked_s += time.perf_counter() - tb
                if slot is None:
                    return
                t0 = time.perf_counter()
                with record_function(f"{self._name}/read"):
                    raw = self._fetch(item, slot)
                self._read_s += time.perf_counter() - t0
                self._read_n += 1
                self._count("read_batches")
                bounds = np.linspace(0, self.rows, self.parts + 1,
                                     dtype=np.int64)
                for p in range(self.parts):
                    job = (seq, item, raw, slot,
                           int(bounds[p]), int(bounds[p + 1]))
                    tb = time.perf_counter()
                    while not self._stop.is_set():
                        try:
                            self._raw.put(job, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    else:
                        return
                    self._read_blocked_s += time.perf_counter() - tb
                self._gauge("queue_depth.raw", self._raw.qsize())
                self._gauge("queue_depth.ring", self.ring.depth_in_use())
                seq += 1
            self._n_planned = seq
            self.ring._wake_all()  # consumer may be waiting for a batch
            #                        that will never come
        except BaseException as e:  # noqa: BLE001 — surfaces at consumer
            self._fail(e)

    def _decode_loop(self) -> None:
        import queue as _queue

        while not self._stop.is_set():
            tb = time.perf_counter()
            try:
                job = self._raw.get(timeout=0.1)
            except _queue.Empty:
                # starvation is read's fault only while read COULD have
                # produced: the plan still has items AND a ring slot was
                # free.  With the ring full the raw queue is empty
                # because the CONSUMER holds the slots, and after the
                # plan drains idleness is just the epoch tail; a wait
                # that ends in work (the successful-get path) is not
                # counted either — it spans consumer-bound park time.
                # Counting any of those would invert the documented
                # bottleneck verdict (backpressure.decode high => read-
                # bound) on every device-bound run; a genuinely slow
                # read stage shows up as whole Empty timeouts here.
                if (self._n_planned is None
                        and self.ring.depth_in_use() < self.ring.depth):
                    with self._rate_lock:
                        self._decode_starved_s += (
                            time.perf_counter() - tb)
                continue
            seq, item, raw, slot, lo, hi = job
            try:
                t0 = time.perf_counter()
                with record_function(f"{self._name}/decode"):
                    meta = self._decode(item, raw, self.ring.buffers(slot),
                                        lo, hi, slot)
                with self._rate_lock:
                    self._decode_s += time.perf_counter() - t0
                    self._decode_n += 1
                self._count("decoded_images", hi - lo)
                self.ring.part_done(slot, meta)
                self._count("ready_batches", 1.0 / self.parts)
            except BaseException as e:  # noqa: BLE001 — surfaces at consumer
                self._fail(e)
                return

    # -- metrics helpers ---------------------------------------------------
    def _count(self, key: str, n: float = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc(f"{self._name}.{key}", n)

    def _gauge(self, key: str, v: float) -> None:
        if self._metrics is not None:
            self._metrics.gauge(f"{self._name}.{key}", v)

    def stage_rates(self) -> Dict[str, float]:
        """Per-stage throughput over the MEASURED window plus busy-time
        capacity — what the bench and the ``data.rate.*`` gauges read.

        ``*_batches_per_s`` is count / wall since the pipeline started (in
        steady state every stage converges on the pipeline rate);
        ``*_capacity_batches_per_s`` is count / stage-busy-seconds — what
        the stage COULD do if never blocked (the autotuning signal).
        Counts and busy seconds ride along so the window is auditable."""
        wall = max(time.perf_counter() - self._t0, 1e-9)
        out: Dict[str, float] = {"window_s": wall}
        if self._read_n:
            out["read_batches"] = float(self._read_n)
            out["read_busy_s"] = self._read_s
            out["read_batches_per_s"] = self._read_n / wall
            if self._read_s > 0:
                out["read_capacity_batches_per_s"] = (
                    self._read_n / self._read_s)
        if self._decode_n:
            batches = self._decode_n / self.parts
            out["decode_batches"] = batches
            out["decode_busy_s"] = self._decode_s
            out["decode_batches_per_s"] = batches / wall
            if self._decode_s > 0:
                out["decode_capacity_batches_per_s"] = (
                    batches / self._decode_s * self.workers)
        return out

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> Iterator[RingBatch]:
        seq = 0
        try:
            while True:
                if self._n_planned is not None and seq >= self._n_planned:
                    return
                popped = self.ring.pop(
                    seq, self._stop, self._get_error,
                    drained=lambda s=seq: (self._n_planned is not None
                                           and s >= self._n_planned))
                if popped is None:
                    return  # plan ran dry while we were parked
                slot, bufs, meta = popped
                if self._finalize is not None:
                    fields = self._finalize(bufs, meta)
                else:
                    n = int(meta.get("n", self.rows))
                    fields = {k: (v[:n] if n != self.rows else v)
                              for k, v in bufs.items()}
                    fields.update(
                        {k: v for k, v in meta.items()
                         if k != "n" and isinstance(v, np.ndarray)})
                mb = RingBatch(lambda s=slot: self.ring.release(s), **fields)
                self._rows_out += int(meta.get("n_real", self.rows)
                                      if meta else self.rows)
                yield mb
                # a consumer that moved on without releasing (it copied the
                # data, or won't touch the arrays again) must not wedge the
                # ring; release() is idempotent for the ones that did
                mb.release()
                seq += 1
                if self._metrics is not None and seq % 8 == 0:
                    self._emit_gauges()
        finally:
            self.close()

    def _emit_gauges(self) -> None:
        """Live per-stage throughput next to the queue-depth gauges: a
        scrape can see WHICH stage caps the pipeline (the attribution
        layer's data component says the run is input-bound; these say
        why).  Emitted every 8 batches during iteration and once more
        from :meth:`close` after the stage threads have joined, so short
        epochs (the full-geometry bench runs 2 batches per epoch) land
        their gauges without racing the read thread's plan-drained
        flag."""
        for rk, rv in self.stage_rates().items():
            if rk.endswith("_per_s"):
                self._gauge(f"rate.{rk}", rv)
        wall = max(time.perf_counter() - self._t0, 1e-9)
        # fraction of stage wall spent blocked on a neighbour:
        # backpressure.read high → decode/consumer is the bottleneck;
        # backpressure.decode high → read is
        self._gauge("backpressure.read",
                    min(1.0, self._read_blocked_s / wall))
        with self._rate_lock:
            starved = self._decode_starved_s
        self._gauge("backpressure.decode",
                    min(1.0, starved / (wall * self.workers)))
        # per-host shard rate: genuine (unpadded) rows this host fed per
        # wall second — the multi-host ingest headline, one per process
        self._gauge("rate.shard_img_per_s", self._rows_out / wall)

    def close(self) -> None:
        """Stop every stage thread and drop queued work.  Idempotent; also
        runs when a consumer abandons the iterator (generator close)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.ring._wake_all()
        for t in self._threads:
            t.join(timeout=5)
        if self._metrics is not None:
            # final gauge flush with every stage thread quiesced — the
            # epoch's complete counters, however short the plan was
            self._emit_gauges()
        close = getattr(self._plan, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # pragma: no cover — best-effort cleanup
                pass
        if self._on_close is not None:
            # adapter-owned resources (native pipes, a shared-memory decode
            # pool) — released only after every stage thread has joined
            self._on_close()


def bundle_batches(batches: Iterable,
                   span: Callable[[], int]) -> Iterator[List[Any]]:
    """Group a device-ready batch iterator into bundles for fused
    multi-step dispatch: each pull asks ``span()`` how many steps the next
    bundle may cover and yields up to that many batches — fewer at the
    epoch tail, which becomes the remainder bundle.  On the card the
    driver replays a captured step for each batch
    (``TrainStep.train_bundle``), copying it into the graph's static
    inputs on the step's stream, which already waits on this feed's
    copy event (ROADMAP C.8).

    Ring economics: the batches come out of :func:`dispatch_to_device`,
    which released each ring slot the moment its host→device copy landed
    (or detached on the CPU), so lending K slots to one bundle needs no
    extra ring depth and no host-side super-batch copy."""
    it = iter(batches)
    try:
        while True:
            group: List[Any] = []
            for _ in range(max(1, int(span()))):
                try:
                    group.append(next(it))
                except StopIteration:
                    break
            if not group:
                return
            yield group
    finally:
        # an abandoned consumer (end_when mid-epoch, an
        # exception in the training loop) must still shut the upstream
        # pipeline's stage threads down
        close = getattr(batches, "close", None)
        if close is not None:
            close()


def _tree_map(fn, x):
    """``fn`` over the array leaves of a batch (dicts, tuples, lists)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return MiniBatch({k: _tree_map(fn, v) for k, v in x.items()})
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _host_array(a) -> np.ndarray:
    """A batch leaf as numpy; float64 becomes float32, as on the JAX
    side without x64."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


class _PageLocks:
    """Host buffers page-locked with the CUDA runtime, by pointer.  The
    feed registers a ring slot's array the first time it copies from it,
    so the copy is a DMA straight out of the slot; the registration lasts
    until the array is freed (``weakref.finalize`` unregisters first).
    Registration belongs to the process's CUDA runtime, so the table is
    the process's too."""

    _ALREADY_REGISTERED = 712  # cudaErrorHostMemoryAlreadyRegistered

    def __init__(self):
        self._lock = threading.Lock()
        self._ranges: Dict[int, int] = {}  # root pointer -> bytes

    def pin(self, a: np.ndarray) -> None:
        root = a
        while isinstance(root.base, np.ndarray):
            root = root.base
        ptr, nbytes = root.ctypes.data, root.nbytes
        with self._lock:
            if self._ranges.get(ptr) == nbytes:
                return
            err = int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0))
            if err == self._ALREADY_REGISTERED:
                return  # page-locked by its owner
            if err != 0:
                raise RuntimeError(
                    f"cudaHostRegister of a {nbytes}-byte ring slot failed "
                    f"(CUDA error {err})")
            self._ranges[ptr] = nbytes
        weakref.finalize(root, self._unpin, ptr).atexit = False

    def _unpin(self, ptr: int) -> None:
        with self._lock:
            if self._ranges.pop(ptr, None) is not None:
                torch.cuda.cudart().cudaHostUnregister(ptr)


PAGE_LOCKS = _PageLocks()


def _copy_to_card(a, device, from_slot: bool) -> torch.Tensor:
    """Issue the host-to-device copy of one leaf on the current (side)
    stream.  A ring slot's C-contiguous array is copied straight from the
    slot, page-locked once; anything else is staged through pinned
    memory from PyTorch's caching host allocator."""
    a = np.asarray(a)
    if from_slot and a.dtype != np.float64 and a.flags.c_contiguous \
            and a.flags.writeable and a.size:
        PAGE_LOCKS.pin(a)
        host = torch.from_numpy(a)
    else:
        a = _host_array(a)
        if not a.flags.writeable:
            a = a.copy()
        host = torch.from_numpy(a).pin_memory()
    return host.to(device, non_blocking=True)


def dispatch_to_device(batches: Iterable, put: Callable[[Any], Any],
                       size: int = 2, inflight: int = 2, metrics=None,
                       name: str = "data", device=None) -> Iterator:
    """Device-feed stage: ``put(mb)`` picks a batch's host arrays (a
    tuple, list or dict of them), and every array is copied to ``device``
    (``cuda`` unless the caller asks for the CPU) with a ``size``-deep
    lookahead (:func:`~bigdl_tpu_torch.data.prefetch.prefetch_to_device`).
    Yields the same structure of tensors.

    On a CUDA device:

    - each ring slot's arrays are page-locked once (``PAGE_LOCKS``, by
      pointer) and copied straight out of the slot — no host copy of the
      batch — with ``non_blocking`` copies on a side stream; a plain
      (non-ring) batch is staged through pinned memory;
    - a CUDA event is recorded after the batch's copies; when the batch
      is yielded, the consumer's current stream waits on that event and
      every tensor is ``record_stream``-ed on it, so the caching allocator
      cannot hand its memory to the next copy while the step reads it;
    - up to ``inflight`` copies ride at once: issuing copy ``k`` first
      waits for the event of copy ``k - inflight + 1`` and only then gives
      that batch's ring slot back (``RingBatch.defer_release``), so a slot
      is never refilled while its copy still reads it.

    On the CPU the batch is detached with a real copy before its slot is
    released.

    ``inflight - 1`` ring slots stay lent between copies, so ``inflight``
    must not exceed the upstream ring depth (at least 2).  ``metrics``
    receives the ``<name>.dispatch.in_flight`` gauge (window depth) and
    the ``<name>.dispatch_overlapped_total`` counter (copies issued while
    an earlier one was still in the window; 0 means the double buffer
    never engaged)."""
    import collections

    from bigdl_tpu_torch.data.prefetch import prefetch_to_device
    from bigdl_tpu_torch.ops.common import resolve_device

    if inflight < 1:
        raise ValueError(f"inflight must be >= 1, got {inflight}")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None
    pending: "collections.deque" = collections.deque()  # (event, release)

    def _drain(keep: int) -> None:
        while len(pending) > keep:
            event, release = pending.popleft()
            if event is not None:
                # the slot's own copy has landed: only now may it refill
                event.synchronize()
            if release is not None:
                release()
        if metrics is not None:
            metrics.gauge(f"{name}.dispatch.in_flight", len(pending))

    def _put(mb):
        defer = getattr(mb, "defer_release", None)
        host = put(mb)
        if metrics is not None and pending:
            metrics.inc(f"{name}.dispatch_overlapped_total")
        if not on_card:
            dev = _tree_map(lambda a: torch.tensor(_host_array(a)), host)
            if defer is not None:
                mb.release()  # detached: the slot may refill now
            pending.append((None, None))
            _drain(inflight - 1)
            return dev, None
        # take over the slot's release: the stream's auto-release (when
        # the consumer pulls the next batch) becomes a no-op, and only
        # _drain, after this copy's event, frees the slot
        release = defer() if defer is not None else None
        with torch.cuda.stream(side):
            dev = _tree_map(lambda a: _copy_to_card(
                a, device, release is not None), host)
            event = torch.cuda.Event()
            event.record(side)
        pending.append((event, release))
        _drain(inflight - 1)
        return dev, event

    def _consume(dev, event):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        _tree_map(lambda t: t.record_stream(stream), dev)

    def _run():
        try:
            for dev, event in prefetch_to_device(batches, _put, size=size):
                if event is not None:
                    _consume(dev, event)
                yield dev
        finally:
            # exhaustion AND abandonment: the window's tail must land and
            # give its slots back before the next epoch's stream over the
            # same cached ring reuses them
            _drain(0)

    return _run()


# ---------------------------------------------------------------------------
# Shared-memory multiprocessing decode (the PIL fallback's parallel path)
# ---------------------------------------------------------------------------

_MP_STATE: Dict[str, Any] = {}


def _mp_init(shm_name: str, shape, dtype_str: str) -> None:
    """Worker-process initializer: attach the ring's shared-memory block
    once; jobs then index straight into it (decoded pixels cross the
    process boundary through shared memory, never pickles)."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    _MP_STATE["shm"] = shm
    _MP_STATE["out"] = np.ndarray(shape, dtype=np.dtype(dtype_str),
                                  buffer=shm.buf)


def _mp_decode_rows(args) -> int:
    """Decode+transform rows [lo, lo+len) of one ring slot (PIL + numpy —
    the no-native path), writing into the attached shared block."""
    (slot, lo, encoded, out_hw, mean, std, resize_hw, crops, flips) = args
    from bigdl_tpu_torch.native import lib as nat

    out = _MP_STATE["out"]
    oh, ow = out_hw
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    for i, data in enumerate(encoded):
        img = nat.decode_jpeg(data)
        if resize_hw is not None:
            img = nat.resize_bilinear(img, *resize_hw)
        cy, cx = crops[i]
        img = img[cy:cy + oh, cx:cx + ow]
        if flips is not None and flips[i]:
            img = img[:, ::-1]
        out[slot, lo + i] = (img.astype(np.float32) / 255.0 - mean) / std
    return len(encoded)


class SharedMemoryDecodePool:
    """Process-pool JPEG decode writing into a shared-memory buffer ring —
    the decode stage for hosts where the native lib (or its libjpeg) is
    missing and PIL inside one GIL-bound process cannot keep up.

    Allocates ONE shared block holding ``depth`` ring slots of shape
    ``(rows, oh, ow, 3)`` float32; worker processes attach it at pool start
    and write their sub-ranges directly, so per-job IPC is the encoded
    bytes in and a row count back.  :meth:`ring_slots` hands the slot views
    to a :class:`BufferRing`, :meth:`submit_rows` is the decode stage."""

    def __init__(self, rows: int, out_hw, depth: int = 4,
                 workers: Optional[int] = None):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import shared_memory

        self.rows = rows
        self.oh, self.ow = out_hw
        self.depth = depth
        self.shape = (depth, rows, self.oh, self.ow, 3)
        nbytes = int(np.prod(self.shape)) * 4
        self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self.out = np.ndarray(self.shape, np.float32, buffer=self._shm.buf)
        # sized to the host's SCHEDULABLE cores (affinity/cgroup-aware)
        self.workers = max(1, workers or host_core_count())
        # never plain fork: the parent runs torch's and the pipeline's
        # threads, and forking a multithreaded process deadlocks;
        # forkserver forks from a clean helper process instead
        ctx = mp.get_context(
            "forkserver" if "forkserver" in mp.get_all_start_methods()
            else "spawn")
        self._pool = ProcessPoolExecutor(
            max_workers=self.workers, mp_context=ctx,
            initializer=_mp_init,
            initargs=(self._shm.name, self.shape, "float32"))

    def ring_slots(self, names=("input",)) -> List[Dict[str, np.ndarray]]:
        (name,) = names
        return [{name: self.out[i]} for i in range(self.depth)]

    def submit_rows(self, slot: int, lo: int, encoded: List[bytes], mean,
                    std, resize_hw=None, crops=None, flips=None) -> int:
        """Decode ``encoded`` into rows ``[lo, lo+len)`` of ``slot`` on a
        worker process; blocks until written (the caller is already a
        pipeline worker thread).  Re-raises worker exceptions."""
        n = len(encoded)
        crops = crops if crops is not None else [(0, 0)] * n
        fut = self._pool.submit(_mp_decode_rows, (
            slot, lo, encoded, (self.oh, self.ow), mean, std,
            resize_hw, crops, flips))
        done = fut.result()
        if done != n:
            raise PipelineError(
                f"decode pool wrote {done}/{n} rows of slot {slot}")
        return done

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        try:
            self._shm.close()
            self._shm.unlink()
        except FileNotFoundError:  # pragma: no cover — double close
            pass

    def __enter__(self) -> "SharedMemoryDecodePool":
        return self

    def __exit__(self, *a) -> bool:
        self.close()
        return False
