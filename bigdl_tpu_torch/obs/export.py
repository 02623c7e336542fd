"""Prometheus text-format export over the ``Metrics`` registry.

The port of ``bigdl_tpu.obs.export``: the same names, wire
formats and semantics.

- monotonic ``counters``        -> ``# TYPE n counter`` single lines
- timer ``sums``/``counts``     -> ``# TYPE n summary`` ``n_sum``/``n_count``
- log-bucketed histograms       -> ``# TYPE n histogram`` cumulative
                                   ``n_bucket{le="..."}`` lines + ``+Inf``
                                   + ``n_sum``/``n_count``

Metric names are sanitized to the Prometheus grammar
(``[a-zA-Z_:][a-zA-Z0-9_:]*``) — the registry's dotted names
(``serving.shed_requests``) become underscored
(``serving_shed_requests``).

Serving exposes this at ``GET /metrics`` on the ``HttpFrontend`` and the
pool proxy; training jobs (no HTTP surface of their own) start a
standalone :class:`MetricsServer`.
"""

import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple


log = logging.getLogger("bigdl_tpu_torch.obs")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Map an arbitrary registry key onto the Prometheus metric-name
    grammar: invalid characters become ``_``; a leading digit gets a ``_``
    prefix."""
    out = _INVALID.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def split_label_key(key: str) -> Tuple[str, str]:
    """Split a registry key into (base name, label body).  Keys built by
    :func:`bigdl_tpu_torch.optim.metrics.label_key` look like
    ``name{k="v",...}``; the label body is returned WITHOUT braces (empty
    for plain keys) and rides verbatim into the sample line."""
    if key.endswith("}") and "{" in key:
        base, _, rest = key.partition("{")
        return base, rest[:-1]
    return key, ""


def _merge_label_bodies(*bodies: str) -> str:
    """Join label bodies (brace-less ``k="v"`` lists), dropping empties."""
    return ",".join(b for b in bodies if b)


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


# help strings for the framework's own metric families, emitted as
# ``# HELP`` lines when the registry carries no explicit describe();
# keyed by the registry's dotted names
DEFAULT_HELP = {
    "train.step_time_s": "step wall time (window mean at coarse log "
                         "cadence)",
    "train.data_wait_s": "host time blocked on the input pipeline per "
                         "fetch (input-bound signal)",
    "train.attr.data_s": "per-step attributed time: input-pipeline wait",
    "train.attr.dispatch_s": "per-step attributed time: host dispatch of "
                             "the jitted step",
    "train.attr.device_s": "per-step attributed time: device compute "
                           "(residual at the log-point sync)",
    "train.attr.overhead_s": "per-step attributed time: trigger work "
                             "(validation/checkpoint/callbacks)",
    "train.mfu": "live model-flop utilization (analytic cost model over "
                 "the device-kind bf16 peak); DENSE-EQUIVALENT under "
                 "block sparsity — see train.effective_mfu",
    "train.effective_mfu": "live MFU counting only executed "
                           "(nonzero-block) FLOPs — the honest chip "
                           "utilization under block-sparse layers; "
                           "equals train.mfu for dense models",
    "train.flops_per_step": "analytic training FLOPs of one global step "
                            "(3x forward)",
    "train.effective_flops_per_step": "analytic training FLOPs of one "
                                      "global step counting only "
                                      "nonzero-block (executed) work",
    "ops.autotune_trials": "kernel-autotuner timing trials executed in "
                           "this process",
    "ops.autotune_cache_hits": "kernel tile lookups answered from the "
                               "autotune cache",
    "ops.autotune_cache_misses": "kernel tile lookups that fell back to "
                                 "hand-picked defaults (no cache entry)",
    "parallel.layout.replicated_params": "parameters the declarative "
                                         "layout silently replicated "
                                         "(matched no table rule / rank-"
                                         "rejected); 0 for covered model "
                                         "families — the paths ride the "
                                         "flight recorder",
    "parallel.layout.data_bytes_per_step": "analytic per-step gradient-"
                                           "allreduce bytes over the "
                                           "layout's data axes",
    "parallel.layout.fsdp_bytes_per_step": "analytic per-step param-"
                                           "gather + grad-scatter bytes "
                                           "over the fsdp axis",
    "parallel.layout.tp_bytes_per_step": "analytic per-step tp param-"
                                         "side bytes (activations price "
                                         "separately)",
    "parallel.layout.seq_bytes_per_step": "analytic per-step seq-axis "
                                          "param-side bytes",
    "parallel.layout.param_bytes_per_chip": "per-chip parameter bytes "
                                            "under the layout (the fits-"
                                            "on-one-chip meter fsdp x tp "
                                            "shrinks)",
    "train.achieved_flops_per_chip": "achieved FLOP/s per chip over the "
                                     "last log window",
    "train.collective_ici_bytes_per_step": "per-step ICI collective bytes "
                                           "of the ZeRO-1 cycle in the "
                                           "actual wire dtype (grad_comm "
                                           "payload + quantization scales "
                                           "+ f32 param gather)",
    "train.collective_dcn_bytes_per_step": "per-step cross-slice (DCN) "
                                           "collective bytes in the "
                                           "actual wire dtype",
    "train.collective_grad_ici_bytes_per_step":
        "per-step ICI bytes of the GRADIENT reduce-scatter alone (the "
        "compressible half; int8 counts payload + per-block scales)",
    "train.collective_param_ici_bytes_per_step":
        "per-step ICI bytes of the f32 updated-param all_gather",
    "train.grad_comm_buckets": "gradient-sync buckets per step (1 = "
                               "monolithic transfer)",
    "train.comm_overlap_efficiency": "fraction of gradient-sync "
                                     "collective time hidden under "
                                     "compute (startup audit; 1.0 = "
                                     "fully overlapped)",
    "train.comm_exposed_collective_s": "per-step collective time NOT "
                                       "hidden under compute (startup "
                                       "audit)",
    "train.collective_ici_bytes_total": "run-lifetime ICI collective "
                                        "bytes moved by training steps",
    "train.collective_dcn_bytes_total": "run-lifetime DCN collective "
                                        "bytes moved by training steps",
    "train.xla_compiles_total": "XLA backend compiles observed in this "
                                "process",
    "train.compile_time_s": "XLA backend compile durations",
    "train.unexpected_recompiles_total": "compiles after the run went "
                                         "steady (mid-run cache misses)",
    "train.step_time_skew_s": "max-min step time across hosts (straggler "
                              "skew)",
    "train.step_time_max_s": "slowest host's window step time",
    "train.step_time_min_s": "fastest host's window step time",
    "serving.latency_s": "admission-to-publish latency per request",
    "serving.queue_wait_s": "admission-to-predict queue wait per request "
                            "(the wait half of the tail decomposition)",
    "serving.batch_occupancy": "cumulative avg batch fill / batch_size "
                               "(continuous batching health)",
    "serving.queue_depth": "requests queued across all model heaps",
    "serving.backlog": "admitted requests not yet in predict (heaps + "
                       "handoff slot) — the autoscaling pressure signal",
    # token-level decode serving (docs/serving.md §Autoregressive decode)
    "serving.decode.tokens_per_s": "generated tokens/s over the recent "
                                   "decode-step window",
    "serving.decode.ttft_s": "time to first token per generate request "
                             "(admission -> first token out)",
    "serving.decode.inter_token_s": "gap between consecutive streamed "
                                    "tokens of one sequence",
    "serving.decode.step_s": "one decode model step (all active slots, "
                             "one token each)",
    "serving.decode.prefill_s": "one prompt prefill chunk through the "
                                "prefill program",
    "serving.decode.slot_occupancy": "occupied decode slots / slot pool "
                                     "size",
    "serving.decode.page_utilization": "allocated KV-cache pages / page "
                                       "pool size",
    "serving.decode.queue_depth": "generate requests queued for a free "
                                  "slot (deadline-heap ordered)",
    "serving.decode.tokens_total": "generated tokens, engine lifetime",
    "serving.decode.requests": "generate requests admitted into slots",
    "serving.decode.completed": "generate requests finished (eos or "
                                "length)",
    "serving.decode.expired": "generate requests dropped by per-token "
                              "deadline enforcement (queued or "
                              "mid-decode)",
    "serving.decode.steps": "decode model steps executed",
    "serving.decode.prefill_chunks": "prompt prefill chunks executed",
    "serving.decode.spec_accept_rate": "speculative decode: accepted / "
                                       "adjudicated draft tokens over "
                                       "the recent window "
                                       "(docs/serving.md §Speculative "
                                       "decoding) — 1.0 means every "
                                       "draft the target scored agreed",
    "serving.decode.spec_drafted_tokens": "speculative decode: tokens "
                                          "drafted by the block-sparse "
                                          "twin, engine lifetime",
    "serving.decode.spec_accepted_tokens": "speculative decode: drafted "
                                           "tokens the target verify "
                                           "accepted",
    "serving.decode.spec_rejected_tokens": "speculative decode: drafted "
                                           "tokens rejected by a verify "
                                           "mismatch (drafts past an "
                                           "eos/length finish count as "
                                           "neither)",
    "serving.decode.spec_draft_step_s": "one draft-model k-token scan "
                                        "(all active slots, one "
                                        "program call)",
    "serving.decode.spec_verify_step_s": "one target-model verify call "
                                         "scoring the drafted chunk",
    "serving.decode.kv_bytes_per_page": "HBM bytes one KV page costs in "
                                        "its stored dtype (int8 pages "
                                        "include the per-page scale "
                                        "pair; docs/quantization.md "
                                        "§Serving memory hierarchy) — "
                                        "page_dtype itself rides "
                                        "/health decode_pressure as a "
                                        "string",
    # label-form per-tenant serving families (docs/observability.md
    # §Federation): one family, one series per tenant="..." label — the
    # name-embedded serving.tenant.<name>.* families stay as deprecated
    # aliases for one release
    "serving.tenant_latency_seconds": "admission-to-publish latency per "
                                      "request, by tenant= label "
                                      "(labeled alias of "
                                      "serving.tenant.<name>.latency_s)",
    "serving.tenant_queue_wait_seconds": "admission-to-predict queue wait "
                                         "per request, by tenant= label",
    "serving.tenant_ttft_seconds": "generate time-to-first-token per "
                                   "request, by tenant= label",
    "serving.tenant_queue_depth": "requests queued in the tenant's "
                                  "admission heap, by tenant= label",
    "serving.tenant_requests_total": "requests answered, by tenant= label",
    "serving.tenant_expired_total": "requests dropped on deadline, by "
                                    "tenant= label",
    "serving.tenant_failed_total": "requests failed by predict errors, by "
                                   "tenant= label",
    # declarative SLOs (docs/observability.md §SLOs & burn rates)
    "slo.burn_rate": "error-budget burn rate over the objective's short "
                     "window, by tenant=/objective= labels (1.0 = burning "
                     "exactly the budget; >1 exhausts it early)",
    "slo.burn_rate_long": "burn rate over the long (6x) window — the "
                          "sustained-burn half of multi-window alerting",
    "slo.budget_remaining": "fraction of the window's error budget left "
                            "(clamped at 0), by tenant=/objective=",
    "slo.health": "pool health score in [0,1]: 1 - max burn rate across "
                  "tenants/objectives, clamped — the autoscaler/"
                  "degradation input",
    "slo.tenant_health": "per-tenant health score in [0,1], by tenant=",
    "slo.burn_events_total": "slo_burn flight events recorded (burn rate "
                             "crossed the alert threshold)",
    "serving_pool.workers": "serving pool size (autoscaler-managed)",
    "serving_pool.federation_stale": "federated /metrics scrapes that "
                                     "dropped a worker's series (dead or "
                                     "unreachable mid-scrape)",
    "serving_pool.conn_reuse": "proxy forwards served over a reused "
                               "keep-alive worker connection",
    "serving_pool.scale_up": "autoscaler worker additions",
    "serving_pool.scale_down": "autoscaler worker removals (drained "
                               "before exit)",
    # decode fleet (docs/serving.md §Decode fleet)
    "serving_pool.fleet_routed": "generate requests placed by the "
                                 "KV-aware fleet router (vs round-robin "
                                 "fallback)",
    "serving_pool.fleet_split": "generate requests routed through a "
                                "dedicated prefill worker (KV handoff)",
    "serving_pool.stream_relays": "streaming /generate token streams "
                                  "relayed through the pool proxy",
    "serving.fleet.prefix_cache_hits": "generate admissions that attached "
                                       "to cached prefix KV pages",
    "serving.fleet.prefix_cache_misses": "generate admissions with no "
                                         "cached prefix to attach",
    "serving.fleet.prefix_cache_evicted_pages": "prefix-cache pages "
                                                "LRU-evicted back to the "
                                                "engine's free pool",
    "serving.fleet.prefix_cache_pages": "KV pages currently held by the "
                                        "prefix cache",
    "serving.fleet.prefix_cache_entries": "distinct token prefixes "
                                          "currently cached",
    "serving.fleet.kv_exports": "prefill KV handoffs exported for a "
                                "decode worker",
    "serving.fleet.kv_imports": "prefill KV handoffs imported from a "
                                "prefill worker",
    # fleet fault tolerance (docs/serving.md §Fleet fault tolerance)
    "serving.fleet.failovers": "streams re-placed on a surviving decode "
                               "worker after their worker died "
                               "mid-stream",
    "serving.fleet.migrations": "live decode slots migrated (KV exported "
                                "and adopted by a peer) during a drain",
    "serving.fleet.resumed_tokens": "tokens already delivered to clients "
                                    "at failover time (resumed, not "
                                    "regenerated client-side)",
    "serving.fleet.orphaned_requests": "streams terminated with an error "
                                       "after every re-placement attempt "
                                       "failed within the budget",
    "serving.fleet.recovery_s": "client-visible failover recovery "
                                "latency: worker loss detected to the "
                                "resumed stream's first byte",
    "serving.fleet.hedged_prefills": "remote prefills abandoned at the "
                                     "hedge deadline and recomputed "
                                     "locally",
    "serving.fleet.parked_handoffs": "migration handoffs parked on this "
                                     "worker awaiting their resumed "
                                     "request",
    "serving.fleet.resumes": "generate requests carrying resume_from "
                             "(failover re-placements)",
    "serving.fleet.resume_adopted": "resumed requests that attached to a "
                                    "parked migration handoff (no "
                                    "re-prefill)",
    "serving.fleet.resume_reprefill": "resumed requests that rebuilt KV "
                                      "by chunked re-prefill",
    "serving.decode.cancelled": "live decode requests cancelled "
                                "(client disconnect, migration eviction, "
                                "explicit cancel)",
    "serving.decode.client_disconnects": "streaming clients that hung up "
                                         "mid-generate (slot and pages "
                                         "freed immediately)",
    "serving_pool.fleet_failovers": "proxy-side count of mid-stream "
                                    "failovers (see "
                                    "serving.fleet.failovers)",
    "serving_pool.fleet_migrations": "proxy-side count of drain "
                                     "migrations recorded",
    "serving_pool.fleet_resumed_tokens": "proxy-side count of tokens "
                                         "carried across failovers",
    "serving_pool.fleet_orphans": "proxy-side count of orphaned streams",
    # cluster control plane (docs/resilience.md §Multi-host recovery)
    "cluster.view_epoch": "current membership view epoch",
    "cluster.members": "live members in the current view",
    "cluster.leader": "leader rank of the current view (lowest live)",
    "cluster.mttr_s": "gang recovery wall time, detection to resumed",
    "cluster.recoveries_total": "coordinated recoveries completed",
    "cluster.recovery_bytes_total": "bytes restored across recoveries",
    "cluster.publish_bytes_total": "peer-shard store bytes published",
    "cluster.aborts_total": "gang abort flags posted by this process",
    "cluster.preempt_notices_total": "cluster-wide preemption notices "
                                     "posted or propagated",
    # training-side metric federation (docs/observability.md §Federation):
    # the leader re-exports each host's snapshot under cluster.host.*
    # families with a host= label — one scrape shows the whole gang
    "cluster.hosts_reporting": "hosts whose metric snapshots the leader "
                               "merged in the last sweep (self included)",
    "cluster.host.age_s": "staleness of one host's merged metric "
                          "snapshot, by host= label — a straggler shows "
                          "up as a growing age, not a missing series",
    # streaming input pipeline (docs/data.md §Reading the data.* metrics
    # + §Multi-host ingest)
    "data.read_batches": "batches fetched by the pipeline's read stage",
    "data.decoded_images": "rows decoded into ring slots by the worker "
                           "pool",
    "data.ready_batches": "ring slots turned READY (all decode parts "
                          "reported)",
    "data.queue_depth.raw": "raw-queue occupancy in decode part-jobs "
                            "(full = decode is the bottleneck)",
    "data.queue_depth.ring": "buffer-ring slots not FREE (assigned, "
                             "ready, or lent to the consumer)",
    "data.backpressure.read": "fraction of pipeline wall the read stage "
                              "spent blocked on a free slot or queue "
                              "space — high means decode or the "
                              "consumer caps the pipeline",
    "data.backpressure.decode": "fraction of decode-pool wall spent "
                                "starved for read work WHILE ring slots "
                                "were free — high means the read stage "
                                "caps the pipeline (a full ring, i.e. a "
                                "slow consumer, does not count here)",
    "data.dispatch.in_flight": "host-to-device transfers still unsynced "
                               "in the dispatch double-buffer window",
    "data.dispatch_overlapped_total": "transfers issued while a previous "
                                      "one was still in flight — 0 "
                                      "means the dispatch double buffer "
                                      "never engaged",
    "data.rate.shard_img_per_s": "genuine (unpadded) rows THIS host's "
                                 "shard fed per wall second — the "
                                 "per-host multi-host ingest rate",
    "data.rate.read_batches_per_s": "read-stage batches per wall second "
                                    "over the measured window",
    "data.rate.decode_batches_per_s": "decoded batches per wall second "
                                      "over the measured window",
    "data.rate.read_capacity_batches_per_s":
        "read-stage capacity (count / stage-busy seconds) — what the "
        "stage could do if never blocked",
    "data.rate.decode_capacity_batches_per_s":
        "decode-pool capacity (count / busy seconds, scaled by pool "
        "width) — the worker-autosizing signal",
    # recsys serving pipeline (docs/recsys.md): per-stage latency of the
    # feature -> recall -> ranking path; the recall/ranking tenants'
    # queue/SLO series ride the generic serving.tenant.* families
    "serving.recsys.feature_s": "recommend feature-fetch stage latency "
                                "(user history lookup)",
    "serving.recsys.recall_s": "recommend recall stage latency (tenant "
                               "admission + MXU top-k)",
    "serving.recsys.rank_s": "recommend ranking stage latency (inline "
                             "candidate scoring, no re-admission)",
    "serving.recsys.recommend_s": "end-to-end recommend latency across "
                                  "all three stages",
    "serving.recsys.candidates": "recall candidates handed to ranking "
                                 "per recommend request",
    "serving.recsys.requests": "recommend requests completed by the "
                               "pipeline",
    # sharded friesian feature engineering (docs/recsys.md §Sharded
    # feature tables): pickled-stat bytes through the cross-process
    # merge allgather — the payload the merge cap bounds
    "friesian.sharded.merge_bytes_total": "pickled stat-merge payload "
                                          "bytes offered to the "
                                          "cross-process allgather "
                                          "(bounded per op by the "
                                          "merge-bytes cap)",
}


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(metrics=None) -> str:
    """One scrape: the full registry in text exposition format.  With no
    argument, renders the process-wide registry — the union every
    subsystem's counters mirror into.

    ``# HELP`` rides next to ``# TYPE`` (registry ``describe()`` strings
    first, the framework catalog as fallback), and a family's header is
    emitted at most ONCE per scrape — two dotted names that sanitize to
    the same family must not re-declare it.  The colliding LATER name's
    samples are dropped too: duplicate name+labels series make the whole
    scrape unparseable to a real Prometheus, which is strictly worse than
    losing the shadowed series."""
    if metrics is None:
        from bigdl_tpu_torch.optim.metrics import global_metrics

        metrics = global_metrics()
    snap = metrics.snapshot()
    helps = dict(DEFAULT_HELP)
    helps.update(snap.get("helps", {}))
    lines = []
    emitted = set()
    owner: Dict[str, str] = {}  # family -> raw BASE name that claimed it

    def header(raw_base: str, n: str, typ: str) -> bool:
        """Declare family ``n`` once; False when ``raw_base`` lost the
        family to an earlier colliding name (caller skips its samples).
        Labeled series of ONE base name share the family — only a
        DIFFERENT base colliding onto the same sanitized family is
        dropped."""
        if owner.setdefault(n, raw_base) != raw_base:
            return False
        if n in emitted:
            return True  # family already declared this scrape
        emitted.add(n)
        h = helps.get(raw_base) or helps.get(n)
        if h:
            lines.append(f"# HELP {n} {_escape_help(h)}")
        lines.append(f"# TYPE {n} {typ}")
        return True

    def series(key: str) -> Tuple[str, str, str]:
        """(raw base, family, rendered sample suffix) of one registry
        key — ``suffix`` is ``{labels}`` or empty."""
        base, labels = split_label_key(key)
        n = sanitize_metric_name(base)
        return base, n, (f"{{{labels}}}" if labels else "")

    for name in sorted(snap["counters"]):
        base, n, sfx = series(name)
        if not header(base, n, "counter"):
            continue
        lines.append(f"{n}{sfx} {_fmt(snap['counters'][name])}")
    # gauges: point-in-time levels (queue depths, ring occupancy);
    # .get() tolerates snapshots from pre-gauge Metrics objects
    for name in sorted(snap.get("gauges", {})):
        base, n, sfx = series(name)
        if not header(base, n, "gauge"):
            continue
        lines.append(f"{n}{sfx} {_fmt(snap['gauges'][name])}")
    for name in sorted(snap["sums"]):
        base, n, sfx = series(name)
        if not header(base, n, "summary"):
            continue
        lines.append(f"{n}_sum{sfx} {_fmt(snap['sums'][name])}")
        lines.append(f"{n}_count{sfx} {snap['counts'].get(name, 0)}")
    for name in sorted(snap["hists"]):
        h = snap["hists"][name]
        base, n, sfx = series(name)
        if not header(base, n, "histogram"):
            continue
        _, labels = split_label_key(name)
        acc = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            acc += count
            lb = _merge_label_bodies(labels, f'le="{_fmt(bound)}"')
            lines.append(f'{n}_bucket{{{lb}}} {acc}')
        lb = _merge_label_bodies(labels, 'le="+Inf"')
        lines.append(f'{n}_bucket{{{lb}}} {h["n"]}')
        lines.append(f"{n}_sum{sfx} {_fmt(h['sum'])}")
        lines.append(f"{n}_count{sfx} {h['n']}")
    return "\n".join(lines) + "\n"


# -- metrics federation (docs/observability.md §Federation) -----------------

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+(\S+))?$')


def parse_exposition(text: str) -> List[Dict]:
    """Parse one Prometheus text exposition into ordered families:
    ``[{"name", "type", "help", "samples": [(metric, labels, value)]}]``
    with ``labels`` the brace-less label body (may carry ``le=``).
    Samples are grouped under the family whose ``# TYPE`` header they
    follow (the exposition-format contract); a sample with no preceding
    header opens an untyped family of its own name.  Tolerant by design
    — a malformed line is skipped, never fatal: this is the proxy's read
    path over worker scrapes."""
    families: List[Dict] = []
    by_name: Dict[str, Dict] = {}
    current: Optional[Dict] = None

    def family(name: str, typ: Optional[str], help_text: Optional[str]
               ) -> Dict:
        fam = by_name.get(name)
        if fam is None:
            fam = {"name": name, "type": typ, "help": help_text,
                   "samples": []}
            by_name[name] = fam
            families.append(fam)
        else:
            if typ is not None and fam["type"] is None:
                fam["type"] = typ
            if help_text is not None and fam["help"] is None:
                fam["help"] = help_text
        return fam

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            current = family(name, None, help_text)
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, typ = rest.partition(" ")
            current = family(name, typ.strip() or None, None)
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        metric, labels, value = m.group(1), m.group(2) or "", m.group(3)
        fam = current
        if fam is None or not metric.startswith(fam["name"]):
            fam = family(metric, None, None)
            current = fam
        fam["samples"].append((metric, labels, value))
    return families


def _render_extra_labels(extra: Dict[str, str]) -> str:
    # THE label-body renderer is optim.metrics.label_key (imported
    # lazily — metrics imports obs.hist, so a module-level import here
    # would re-enter the obs package mid-init); an empty name yields
    # just the braced body, which this strips
    from bigdl_tpu_torch.optim.metrics import label_key

    return label_key("", **extra)[1:-1] if extra else ""


def federate(parts: List[Tuple[Dict[str, str], str]]) -> str:
    """Merge several expositions into ONE parse-clean scrape — the pool
    proxy's federated ``GET /metrics`` (docs/observability.md
    §Federation).  ``parts`` is ``[(extra_labels, exposition_text)]``;
    every sample of a part gets its extra labels (``worker="worker-0"``)
    appended, which is what keeps same-named series from two workers
    distinct.  Each family is DECLARED exactly once (first part wins the
    ``# HELP``/``# TYPE``); a later part whose declared type disagrees
    has that family's samples dropped — a type-flapping family would make
    the whole scrape unparseable, which is strictly worse."""
    merged: List[Dict] = []
    by_name: Dict[str, Dict] = {}
    for extra, text in parts:
        sfx = _render_extra_labels(extra) if extra else ""
        for fam in parse_exposition(text):
            out = by_name.get(fam["name"])
            if out is None:
                out = {"name": fam["name"], "type": fam["type"],
                       "help": fam["help"], "samples": []}
                by_name[fam["name"]] = out
                merged.append(out)
            elif (fam["type"] is not None and out["type"] is not None
                    and fam["type"] != out["type"]):
                continue  # type conflict: drop the later part's samples
            for metric, labels, value in fam["samples"]:
                lb = _merge_label_bodies(labels, sfx)
                out["samples"].append(
                    (f"{metric}{{{lb}}}" if lb else metric, value))
    lines = []
    for fam in merged:
        if fam["help"]:
            lines.append(f"# HELP {fam['name']} {fam['help']}")
        if fam["type"]:
            lines.append(f"# TYPE {fam['name']} {fam['type']}")
        for metric, value in fam["samples"]:
            lines.append(f"{metric} {value}")
    return "\n".join(lines) + "\n"


def reply_metrics(handler: BaseHTTPRequestHandler, metrics=None) -> None:
    """Write one ``/metrics`` response on a stdlib handler — shared by the
    serving frontend, the pool proxy, and :class:`MetricsServer` so the
    exposition surface cannot drift between them."""
    try:
        body = render_prometheus(metrics).encode()
        handler.send_response(200)
        handler.send_header("Content-Type", CONTENT_TYPE)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass  # scraper hung up; never kill the serving handler thread


class MetricsServer:
    """Standalone ``GET /metrics`` endpoint for jobs with no HTTP surface
    of their own (training drivers).  ``port=0`` picks a free port —
    ``url`` is the scrape target."""

    def __init__(self, metrics=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.metrics = metrics

        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "bigdl-tpu-metrics/1"

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def do_GET(self):
                if self.path != "/metrics":
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                reply_metrics(self, outer.metrics)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("metrics server listening on %s", self.url)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
