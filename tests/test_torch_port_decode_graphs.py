"""The port's decode engine restructured as a closed program set (fixed
shapes, packed inputs, sink pages, the eager plain version of its CUDA
graphs) against the JAX engine on the CPU, at the small LM of
``test_torch_port_serving.py``.

- Sink semantics: inactive rows, a row at the cap and padded positions
  leave every live page and int8 scale unchanged, target and draft pools.
- The int8 prefill write-back (a fixed ``ceil(chunk / page) + 1`` pages a
  row) equals the touched-page write it replaced, bit for bit, on
  chunks that straddle pages and the cap.
- The scheduler, its events and its ``serving.decode.*`` metric surface
  equal the JAX engine's on the same requests (both queued before the
  engine's first iteration, so both schedules are the same): the event
  ring, the counters, ``decode_pressure``; speculation's acceptance
  accounting; cancellation (queued, in flight with ``partial_tokens``,
  and the JAX spec ``test_cancel_frees_draft_pages_with_target_pages``).
- ``cuda_graphs=True`` is refused on the CPU.

Tokens equal the JAX engine's, summed log-probs within 1e-4 (as the port's
serving tests)."""

import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.optim.metrics import Metrics as JaxMetrics
from bigdl_tpu.serving import decode_engine as jde
import bigdl_tpu_torch.serving.decode_engine as pde
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                     DecodeRequest, InferenceModel, LMAdapter,
                                     RequestCancelledError, SpecConfig)
from bigdl_tpu_torch.utils import load_jax_params

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2)
SPEC = dict(k=3, sparsity=0.5)


@pytest.fixture(scope="module")
def lm():
    model = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                           num_layers=2, dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0),
                   np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    return model, params


def _prompts(ns=(3, 5, 9, 2, 7, 11), seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(2, 32, (n,)).astype(np.int32) for n in ns]


def _port(lm, spec=False, **over):
    model = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                        dropout=0.0), lm[1])
    cfg = DecodeConfig(**dict(GEOMETRY, **over),
                       speculative=SpecConfig(**SPEC) if spec else None)
    return DecodeEngine(LMAdapter(model, cfg.cap), cfg, metrics=Metrics())


def _jax(lm, spec=False, **over):
    """A JAX engine whose draft prefill waits for its call (its host
    scratch block is refilled by the next call: see
    test_torch_port_spec.py)."""
    model, params = lm
    cfg = jde.DecodeConfig(**dict(GEOMETRY, **over),
                           speculative=jde.SpecConfig(**SPEC)
                           if spec else None)
    eng = jde.DecodeEngine(jde.LMAdapter(model, params, cap=cfg.cap), cfg,
                           metrics=JaxMetrics())
    if spec:
        draft_prefill_fn = eng._draft_prefill_fn

        def blocking(nb):
            fn = draft_prefill_fn(nb)
            return lambda *a: jax.block_until_ready(fn(*a))

        eng._draft_prefill_fn = blocking
    return eng


def _requests(mod, prompts, prefix="r", **kw):
    return [mod.DecodeRequest(tokens=p, seed=100 + i, rid=f"{prefix}{i}",
                              **kw) for i, p in enumerate(prompts)]


def _queued_together(eng, reqs):
    """Queue every request before the engine's first iteration (the
    iteration lock held), so both engines run the same schedule."""
    with eng._iter_lock:
        for r in reqs:
            eng.submit(r)
    return reqs


def _wait_all(reqs):
    out = []
    for r in reqs:
        try:
            out.append(r.wait(timeout=120))
        except RequestCancelledError as e:
            out.append(e)
        except jde.RequestCancelledError as e:
            out.append(e)
    return out


def _same_results(got, want):
    for a, b in zip(got, want):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert a.finish_reason == b.finish_reason
        assert abs(a.logp - b.logp) <= 1e-4


def _events(eng):
    return [tuple(e) for e in eng.events]


def _steady(gauges):
    return sorted(set(gauges) - {"serving.decode.tokens_per_s",
                                 "serving.decode.spec_accept_rate"})


@pytest.fixture(scope="module")
def jax_runs(lm):
    """The JAX engines' runs, one engine each, plain and speculative:
    a greedy wave, then a seeded sampled wave (the speculative engine),
    each queued before the first iteration; results, events, stats,
    counters and decode_pressure after each."""
    out = {}
    for spec in (False, True):
        eng = _jax(lm, spec)
        try:
            waves = []
            for wave, kw in enumerate(
                    ({}, dict(temperature=1.3, top_k=5, top_p=0.9))):
                if wave and not spec:
                    break
                eng.metrics = JaxMetrics()
                eng.events.clear()
                before = dict(eng.stats)
                res = _wait_all(_queued_together(
                    eng, _requests(jde, _prompts(), f"w{wave}-", **kw)))
                waves.append({
                    "results": res, "events": _events(eng),
                    "stats": {k: v - before[k] for k, v in eng.stats.items()},
                    "counters": dict(eng.metrics.counters),
                    "hists": sorted(eng.metrics.hists),
                    "gauges": sorted(eng.metrics.gauges),
                    "pressure": eng.decode_pressure()})
            out[spec] = waves
        finally:
            eng.stop()
    return out


# ---------------------------------------------------------------------------
# the scheduler and its metric surface against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True])
def test_schedule_events_and_metrics_equal_jax(lm, jax_runs, spec):
    """The same requests queued together: the port's results, its event
    ring (admissions, prefill chunks, decode or speculative steps with
    their buckets, releases), its stats and its serving.decode counters
    equal the JAX engine's; its histograms and gauges carry the JAX
    names; the idle decode_pressure equals JAX's."""
    eng = _port(lm, spec)
    try:
        for wave, kw in enumerate(({}, dict(temperature=1.3, top_k=5,
                                             top_p=0.9))):
            if wave and not spec:
                break
            want = jax_runs[spec][wave]
            eng.metrics = Metrics()
            eng.events.clear()
            before = dict(eng.stats)
            res = _wait_all(_queued_together(
                eng, _requests(pde, _prompts(), f"w{wave}-", **kw)))
            _same_results(res, want["results"])
            assert _events(eng) == want["events"]
            stats = {k: v - before[k] for k, v in eng.stats.items()}
            assert {k: stats[k] for k in want["stats"]} == want["stats"]
            assert stats["prefill_calls"] > 0
            assert dict(eng.metrics.counters) == want["counters"]
            assert sorted(eng.metrics.hists) == want["hists"]
            if wave == 0:
                # the gauges the first export sets (later exports, and the
                # rates, wait on a 50 ms throttle and a window: timing)
                assert _steady(eng.metrics.gauges) == \
                    _steady(want["gauges"])
            assert eng.decode_pressure() == want["pressure"]
    finally:
        eng.stop()


def test_acceptance_accounting_and_metric_surface(lm, jax_runs):
    """The JAX spec of test_spec_decode.py on the port: adjudicated drafts
    never exceed drafted, every accepted draft was emitted, and the
    serving.decode.spec_* counters, histograms and the acceptance gauge
    exist — with the JAX engine's counts on the same requests."""
    eng = _port(lm, spec=True)
    try:
        _wait_all(_queued_together(eng, _requests(pde, _prompts(), "w0-")))
        st = eng.stats
        assert st["spec_drafted"] > 0
        assert st["spec_accepted"] + st["spec_rejected"] \
            <= st["spec_drafted"]
        assert st["tokens"] >= st["spec_accepted"]
        m = eng.metrics
        for name in ("spec_drafted_tokens", "spec_accepted_tokens",
                     "spec_rejected_tokens"):
            assert f"serving.decode.{name}" in m.counters
        for name in ("spec_draft_step_s", "spec_verify_step_s"):
            assert f"serving.decode.{name}" in m.hists
        assert "serving.decode.spec_accept_rate" in m.gauges
        want = jax_runs[True][0]["stats"]
        for k in ("spec_drafted", "spec_accepted", "spec_rejected",
                  "tokens"):
            assert st[k] == want[k], k
        assert "serving.decode.tokens_per_s" in m.helps
    finally:
        eng.stop()


def test_decode_pressure_honest_under_spec(lm):
    """The JAX spec on the port, and the port's idle pressure equal to the
    JAX engine's for the same configs."""
    on, off = _port(lm, spec=True), _port(lm)
    jon, joff = _jax(lm, spec=True), _jax(lm)
    try:
        p_on, p_off = on.decode_pressure(), off.decode_pressure()
        assert p_on["speculative"] is True and p_on["spec_k"] == 3
        assert p_off["speculative"] is False and p_off["spec_k"] == 0
        assert on.kv_bytes_per_page() > off.kv_bytes_per_page()
        assert p_on == jon.decode_pressure()
        assert p_off == joff.decode_pressure()
        assert on.queue_depth() == 0 and on.active_slots() == 0
    finally:
        for e in (on, off, jon, joff):
            e.stop()


# ---------------------------------------------------------------------------
# cancellation against the JAX engine
# ---------------------------------------------------------------------------

def _cancel_run(eng, mod, cancel_at=2):
    """Three requests queued together; the third is cancelled while
    queued, the first from its own token stream at its
    ``cancel_at + 1``-th token (in flight).  Returns the outcomes and the
    events."""
    reqs = _requests(mod, _prompts()[:3], "c")
    reqs[0].on_token = (lambda rid, tok, idx: eng.cancel(
        rid, reason="client_disconnect") if idx == cancel_at else None)
    with eng._iter_lock:
        for r in reqs:
            eng.submit(r)
        eng.cancel("c2", reason="gone")
    out = _wait_all(reqs)
    deadline = time.time() + 30
    while len(eng._free_pages) != eng.cfg.total_pages \
            or eng._reserved_pages:
        assert time.time() < deadline, "pages never came back"
        time.sleep(0.01)
    return out, _events(eng)


@pytest.mark.parametrize("spec", [False, True])
def test_queued_and_in_flight_cancel_equal_jax(lm, spec):
    """A queued cancel answers RequestCancelledError without tokens; an
    in-flight cancel frees the slot's target (and draft) pages at once
    and carries the tokens streamed so far as ``partial_tokens``; the
    events, counters and the uncancelled request's result equal the JAX
    engine's."""
    jeng, eng = _jax(lm, spec), _port(lm, spec)
    try:
        want, want_ev = _cancel_run(jeng, jde)
        got, got_ev = _cancel_run(eng, pde)
    finally:
        jeng.stop()
        eng.stop()
    assert got_ev == want_ev
    assert ("cancel_queued", "c2", "gone") in got_ev
    assert isinstance(got[2], RequestCancelledError) and got[2].reason == \
        "gone" and not hasattr(got[2], "partial_tokens")
    assert isinstance(got[0], RequestCancelledError)
    assert got[0].reason == "client_disconnect"
    assert got[0].partial_tokens.tolist() == want[0].partial_tokens.tolist()
    assert len(got[0].partial_tokens) >= 3
    _same_results([got[1]], [want[1]])
    assert eng.stats["cancelled"] == jeng.stats["cancelled"] == 2
    for name in ("cancelled", "client_disconnects"):
        key = f"serving.decode.{name}"
        assert eng.metrics.counter(key) == jeng.metrics.counter(key)
    assert eng.metrics.counter("serving.decode.client_disconnects") == 1


def test_cancel_frees_draft_pages_with_target_pages(lm, jax_runs):
    """The JAX spec of test_spec_decode.py on the port: a mid-stream
    disconnect under speculation restores the exact free-page count (the
    draft pool shares the page table), and a fresh wave through the same
    slots gives the JAX engine's answers."""
    eng = _port(lm, spec=True)
    try:
        eng.warmup()
        total = eng.cfg.total_pages
        assert len(eng._free_pages) == total
        orig_step = eng._decode_step
        eng._decode_step = lambda: (time.sleep(0.15), orig_step())[1]
        req = DecodeRequest(tokens=_prompts()[2], max_new_tokens=200,
                            on_token=lambda rid, tok, idx: None)
        eng.submit(req)
        deadline = time.time() + 30
        while not any(s is not None for s in eng._slots):
            assert time.time() < deadline, "request never took a slot"
            time.sleep(0.01)
        assert (total - len(eng._free_pages)) + eng._reserved_pages > 0
        eng.cancel(req.rid, reason="client_disconnect")
        eng._decode_step = orig_step
        deadline = time.time() + 30
        while len(eng._free_pages) != total or eng._reserved_pages:
            assert time.time() < deadline, "draft/target page leak"
            time.sleep(0.01)
        with pytest.raises(RequestCancelledError):
            req.wait(timeout=1)
        assert eng.metrics.counter("serving.decode.client_disconnects") == 1
        got = eng.generate(_prompts(), seed=0)
        want = [r.tokens.tolist() for r in jax_runs[False][0]["results"]]
        assert [g.tokens.tolist() for g in got] == want
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# fixed shapes: the sink page and the int8 write-back
# ---------------------------------------------------------------------------

def _dirty(eng, seed=0):
    """Random live pages (and int8 scales) in every pool."""
    g = torch.Generator().manual_seed(seed)
    for name in ("_kv_k", "_kv_v", "_dr_k", "_dr_v"):
        t = getattr(eng, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    for name in ("_kv_sk", "_kv_sv"):
        t = getattr(eng, name)
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=g) * 0.1 + 0.01)


def _live(eng):
    P = eng.cfg.total_pages
    return {n: getattr(eng, n)[:, :P].clone()
            for n in ("_kv_k", "_kv_v", "_kv_sk", "_kv_sv", "_dr_k", "_dr_v")
            if getattr(eng, n) is not None}


def _fill_rows(eng, x, lengths, active):
    S = eng.cfg.slots
    W = eng.cfg.pages_per_slot
    x["pt"][:] = np.arange(S * W, dtype=np.int32).reshape(S, W) \
        % eng.cfg.total_pages
    x["lengths"][:] = lengths
    x["last"][:] = 5
    x["active"][:] = active
    x["fresh"][:] = eng._sink


@pytest.mark.parametrize("int8", [False, True])
def test_masked_writes_land_in_the_sink(lm, int8):
    """Inactive rows and an active row at the cap write only the sink:
    every live page (and int8 scale) of the target pool, and of the
    draft pool under speculation, keeps its bytes through a decode step,
    a speculative iteration (both verify forms) and a prefill call of
    inactive rows."""
    eng = _port(lm, spec=True, kv_dtype="int8" if int8 else "float32",
                use_flash_decode=True)
    cap = eng.cfg.cap
    _dirty(eng)
    before = _live(eng)
    calls = [("step", False), ("spec", False), ("spec", True),
             ("prefill", False)]
    for name, sampled in calls:
        prog = eng._programs[name]
        prog.reset()
        if name != "prefill":
            # slot 0 active at the cap, the others inactive at stale
            # lengths
            _fill_rows(eng, prog.x, [cap, 3, 9, 0], [1, 0, 0, 0])
        else:
            prog.x["position"][:] = [cap - 2, 4]
            prog.x["pt"][:] = np.arange(2 * eng.cfg.pages_per_slot
                                        ).reshape(2, -1)
        out = eng._call(name, eng.cfg.pages_per_slot, sampled)
        assert all(np.isfinite(v).all() for v in out.values())
    after = _live(eng)
    for n in before:
        assert torch.equal(before[n], after[n]), n


def test_prefill_padded_tail_writes_inside_the_cap_only(lm):
    """A final chunk running past the cap: its positions inside the cap
    (the prompt and its padded tail) reach the pages, those past it the
    sink; no other live page changes."""
    eng = _port(lm)
    _dirty(eng)
    before = _live(eng)["_kv_k"]
    prog = eng._programs["prefill"]
    prog.reset()
    x = prog.x
    cap, page = eng.cfg.cap, eng.cfg.page_size
    x["position"][0] = cap - 2             # the chunk covers cap-2 .. cap+1
    x["active"][0] = 1
    x["tokens"][0, :2] = [7, 9]
    x["last_index"][0] = 1
    x["pt"][0] = [3, 5, 7, 9]
    eng._call("prefill", eng.cfg.pages_per_slot, False)
    after = _live(eng)["_kv_k"]
    changed = sorted({(p, o) for p, o in zip(*np.nonzero(
        (after != before).any(dim=(0, 2, 4)).numpy()))})
    last = int(x["pt"][0, -1])
    assert changed == [(last, page - 2), (last, page - 1)]


def _old_write_back(eng, kbuf, vbuf, pt_rows, position, active, n_blocks):
    """The int8 prefill write-back before the fixed-width one: the pages
    the chunk touched, found on the host (kbuf/vbuf without sink row)."""
    from bigdl_tpu_torch.ops.quantized import quantize_pages

    cfg = eng.cfg
    page, C = cfg.page_size, cfg.prompt_chunk
    a = eng.adapter
    B = kbuf.shape[0]
    pg0 = np.arange(n_blocks)[None, :] * page
    lim = np.minimum(position + C, cfg.cap)[:, None]
    touched = (active[:, None] & (pg0 < lim)
               & (pg0 + page > position[:, None]))
    b_idx, j_idx = np.nonzero(touched)
    bi = torch.from_numpy(b_idx)
    ji = torch.from_numpy(j_idx)
    pids = torch.from_numpy(pt_rows[b_idx, j_idx].astype(np.int64))
    L, h, hd = a.num_layers, a.num_heads, a.head_dim
    for buf, pool, scales in ((kbuf, eng._kv_k, eng._kv_sk),
                              (vbuf, eng._kv_v, eng._kv_sv)):
        pages = buf.reshape(B, L, h, n_blocks, page, hd)[
            bi, :, :, ji].permute(1, 0, 2, 3, 4)
        q, sc = quantize_pages(pages, floor_scales=scales[:, pids])
        pool[:, pids] = q
        scales[:, pids] = sc


@pytest.mark.parametrize("page,chunk,positions", [
    (4, 4, [3, 6]), (4, 6, [1, 10]), (4, 6, [14, 0]), (2, 5, [7, 3])])
def test_int8_write_back_equals_the_touched_page_write(lm, page, chunk,
                                                       positions):
    """Chunks that straddle pages (and one crossing the cap): the
    fixed-width write-back leaves every live page and scale as the
    touched-page write did, bit for bit."""
    eng = _port(lm, kv_dtype="int8", page_size=page, prompt_chunk=chunk,
                pages_per_slot=16 // page)
    _dirty(eng, seed=3)
    cfg = eng.cfg
    B, W = cfg.prefill_batch, cfg.pages_per_slot
    g = torch.Generator().manual_seed(4)
    a = eng.adapter
    kbuf = torch.randn((B + 1, a.num_layers, a.num_heads, W * page,
                        a.head_dim), generator=g)
    vbuf = torch.randn(kbuf.shape, generator=g)
    pt_rows = np.random.RandomState(5).permutation(cfg.total_pages)[
        :B * W].reshape(B, W).astype(np.int32)
    position = np.asarray(positions)
    active = np.array([True, True])
    ref = {n: t.clone() for n, t in _live(eng).items()}
    saved = [getattr(eng, n).clone() for n in ("_kv_k", "_kv_v", "_kv_sk",
                                                "_kv_sv")]
    _old_write_back(eng, kbuf[:B], vbuf[:B], pt_rows, position, active, W)
    want = _live(eng)
    for n, t in zip(("_kv_k", "_kv_v", "_kv_sk", "_kv_sv"), saved):
        getattr(eng, n).copy_(t)
    assert all(torch.equal(ref[n], _live(eng)[n]) for n in ref)
    eng._write_back_int8(kbuf, vbuf, torch.from_numpy(pt_rows).long(),
                         torch.from_numpy(position).long(),
                         torch.from_numpy(active))
    got = _live(eng)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert any(not torch.equal(got[n], ref[n]) for n in got)


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------

def test_cuda_graphs_refused_on_the_cpu(lm):
    model = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                        dropout=0.0), lm[1])
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        InferenceModel(model, decode=DecodeConfig(**GEOMETRY,
                                                  cuda_graphs=True),
                       device="cpu")
    for graphs in (None, False):
        eng = InferenceModel(model, decode=DecodeConfig(
            **GEOMETRY, cuda_graphs=graphs), device="cpu").decode_engine
        assert not eng._graphs_on
        eng.warmup()
        assert eng.graphs_captured == 0 and eng.graph_pool_bytes() is None
        assert eng.metrics.counter("serving.decode.graph_captures") == 0


def test_concurrent_submit_and_cancel(lm):
    """Eight client threads submit and cancel (every other request, some
    while queued, some in flight) under a shortened switch interval:
    every request ends with a result or a RequestCancelledError, the
    engine counts exactly the cancels that landed, and every page comes
    back."""
    import sys
    import threading

    eng = _port(lm, spec=True)
    outcomes, lock = [], threading.Lock()

    def client(w):
        rs = np.random.RandomState(w)
        for i in range(4):
            r = eng.submit(DecodeRequest(
                tokens=rs.randint(2, 32, int(rs.randint(1, 12))).astype(
                    np.int32), seed=10 * w + i, rid=f"t{w}-{i}",
                temperature=1.1 * (i % 2)))
            if i % 2:
                eng.cancel(r.rid, reason="client_disconnect")
            try:
                out = len(r.wait(timeout=60).tokens)
            except RequestCancelledError:
                out = "cancelled"
            with lock:
                outcomes.append(out)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        cancelled = outcomes.count("cancelled")
        assert len(outcomes) == 32 and 0 < cancelled <= 16
        assert all(o == "cancelled" or o >= 1 for o in outcomes)
        assert eng.stats["cancelled"] == cancelled
        assert eng.stats["completed"] + cancelled == 32
        assert eng.metrics.counter("serving.decode.client_disconnects") \
            == cancelled
        deadline = time.time() + 30
        while len(eng._free_pages) != eng.cfg.total_pages \
                or eng._reserved_pages:
            assert time.time() < deadline, "pages never came back"
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
