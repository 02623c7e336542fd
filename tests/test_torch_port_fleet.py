"""The decode engine's fleet half in the port against the JAX package:
``serving.fleet`` (``PrefixCache``, ``FleetRouter``, the handoff wire
format), ``DecodeConfig.prefix_cache_pages``, ``export_kv`` /
``submit_prefilled`` and ``migrate_live_slots``.

The pure specs are tests/test_fleet.py's, on the port's modules.  Blobs
cross the packages byte for byte.  The engine specs drive both engines
by hand (one engine iteration at a time on the test thread, the JAX
engine's loop body and the port's), so both run the same schedule: the
same admissions, attaches, donations and events.  Tokens are equal;
summed log-probs within 1e-4 of the JAX engine's (float32 sums in
another order, as test_torch_port_serving.py) and within 1e-5 of the
port's own cold or static run (the port's continuous-vs-static
tolerance: torch's CPU reductions change order with the cache bucket's
width).  Int8 page payloads may differ from JAX's by one quantization
step where a float32 value lies on a rounding boundary."""

import json

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu.serving import fleet as jfleet
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                     DecodeRequest, LMAdapter)
from bigdl_tpu_torch.serving.fleet import (FleetRouter, PrefixCache,
                                           pack_handoff, unpack_handoff)
from bigdl_tpu_torch.serving.fleet.handoff import HANDOFF_MAGIC, HandoffError
from bigdl_tpu_torch.utils import load_jax_params

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2,
                prefix_cache_pages=8)
SAMPLE_KW = dict(temperature=0.8, top_k=8, top_p=0.9, seed=13)


# ---------------------------------------------------------------------------
# PrefixCache units (tests/test_fleet.py's)


def test_prefix_cache_match_is_page_aligned_and_strict():
    c = PrefixCache(max_pages=8, page_size=4)
    key = list(range(2, 10))
    assert c.insert(key, [0, 1])
    e = c.match(key + [30])
    assert e is not None and e.pages == [0, 1]
    assert c.match(key) is None           # strict: the final chunk runs
    assert c.match([31] * 12) is None
    assert c.insert(key[:4], [2])
    e = c.match(key + [30])
    assert e is not None and len(e.key) == 8


def test_prefix_cache_insert_validation():
    c = PrefixCache(max_pages=4, page_size=4)
    assert not c.insert([2, 3, 4], [0])
    assert not c.insert([], [])
    assert c.insert([2, 3, 4, 5], [0])
    assert not c.insert([2, 3, 4, 5], [1])
    assert c.stats()["rejected_insertions"] == 1
    with pytest.raises(ValueError, match="dtype mismatch"):
        c.insert([6, 7, 8, 9], [1], page_dtype="int8")


def test_prefix_cache_eviction_never_frees_live_pages():
    c = PrefixCache(max_pages=8, page_size=4)
    assert c.insert([2, 3, 4, 5], [0])
    assert c.insert([6, 7, 8, 9], [1])
    e1 = c.match([2, 3, 4, 5, 10])
    c.attach(e1)
    assert c.evict(5) == [1]
    assert c.match([2, 3, 4, 5, 10]) is e1
    assert c.evict(1) == []
    c.detach(e1)
    assert sorted(c.evict(1)) == [0]
    assert len(c) == 0 and c.pages_held == 0


def test_prefix_cache_evict_protect_shields_pending_attach():
    c = PrefixCache(max_pages=8, page_size=4)
    assert c.insert([2, 3, 4, 5], [0])
    e = c.match([2, 3, 4, 5, 9])
    assert c.evict(4, protect=e) == []
    assert c.match([2, 3, 4, 5, 9]) is e


def test_prefix_cache_budget_bounded_with_lru_turnover():
    c = PrefixCache(max_pages=2, page_size=4)
    assert not c.insert(list(range(2, 14)), [0, 1, 2])
    assert c.insert([2, 3, 4, 5], [0])
    assert c.insert([6, 7, 8, 9], [1])
    assert c.pages_held == 2
    c.attach(c.match([6, 7, 8, 9, 30]))
    assert c.insert([10, 11, 12, 13], [2])
    assert c.pages_held == 2
    assert c.match([2, 3, 4, 5, 30]) is None
    s = c.stats()
    assert s["evictions"] == 1 and s["evicted_pages"] == 1


# ---------------------------------------------------------------------------
# FleetRouter units (tests/test_fleet.py's) and agreement with the JAX one


def _health(role="both", slots=2, pages=10, total=16, queued=0,
            inflight=0, prefill_backlog=0, slo=1.0, alive=True,
            page_dtype=None):
    d = {"free_slots": slots, "free_pages": pages, "total_pages": total,
         "queued": queued, "generate_inflight": inflight,
         "prefill_backlog": prefill_backlog}
    if page_dtype is not None:
        d["page_dtype"] = page_dtype
    return {"alive": alive, "role": role, "slo_health": slo, "decode": d}


def test_router_routes():
    r = FleetRouter()
    assert r.route([_health(slots=0, pages=0),
                    _health(slots=3, pages=12)]) == (1, None)
    assert r.route([_health(queued=4, inflight=4), _health()])[0] == 1
    assert r.route([_health(), _health(slo=0.2)])[0] == 0
    assert r.route([_health(alive=False), _health(role="prefill"),
                    _health(role="decode")]) == (2, 1)
    assert r.route([_health(role="prefill")]) == (None, None)
    assert r.route([]) == (None, None)
    assert r.route([_health(), _health()]) == (0, None)
    assert r.route([_health(role="prefill", prefill_backlog=5),
                    _health(role="prefill", prefill_backlog=0),
                    _health(role="decode")]) == (2, 1)


@pytest.mark.parametrize("seed", range(4))
def test_router_scores_equal_jax(seed):
    rs = np.random.RandomState(seed)
    hs = [_health(role=rs.choice(["both", "decode", "prefill"]),
                  slots=int(rs.randint(0, 4)), pages=int(rs.randint(0, 16)),
                  queued=int(rs.randint(0, 3)),
                  inflight=int(rs.randint(0, 3)),
                  prefill_backlog=int(rs.randint(0, 4)),
                  slo=float(rs.rand()), alive=bool(rs.rand() > 0.2),
                  page_dtype=rs.choice(["float32", "int8", "bfloat16"]))
          for _ in range(6)]
    j = jfleet.FleetRouter()
    assert FleetRouter().route(hs) == j.route(hs)
    for h in hs:
        assert FleetRouter.decode_score(h) == j.decode_score(h)
        assert FleetRouter.prefill_score(h) == j.prefill_score(h)


# ---------------------------------------------------------------------------
# the handoff wire format, and blobs across the packages


def _fake_handoff(kv_dtype="float32"):
    rs = np.random.RandomState(3)
    h = {"tokens": [4, 9, 2, 7, 5], "first_token": 12,
         "first_logp": -1.25, "temperature": 0.8, "top_k": 8,
         "top_p": 0.9, "seed": 13, "request_id": "req-1"}
    if kv_dtype == "int8":
        h.update(kv_dtype="int8",
                 k=rs.randint(-127, 128, (2, 2, 2, 4, 3)).astype(np.int8),
                 v=rs.randint(-127, 128, (2, 2, 2, 4, 3)).astype(np.int8),
                 k_scales=rs.rand(2, 2).astype(np.float32),
                 v_scales=rs.rand(2, 2).astype(np.float32))
    else:
        h.update(k=rs.randn(2, 2, 2, 4, 3).astype(np.float32),
                 v=rs.randn(2, 2, 2, 4, 3).astype(np.float32))
    return h


def test_handoff_roundtrip_is_exact():
    h = _fake_handoff()
    out = unpack_handoff(pack_handoff(h))
    assert out["k"].tobytes() == h["k"].tobytes()
    assert out["v"].tobytes() == h["v"].tobytes()
    assert out["tokens"].dtype == np.int32
    assert list(out["tokens"]) == h["tokens"]
    assert out["first_token"] == 12
    assert np.float32(out["first_logp"]) == np.float32(-1.25)
    assert out["request_id"] == "req-1" and out["seed"] == 13


def test_handoff_rejects_bad_payloads():
    h = _fake_handoff()
    data = pack_handoff(h)
    with pytest.raises(ValueError, match="magic"):
        unpack_handoff(b"nope" + data)
    with pytest.raises(ValueError, match="truncated"):
        unpack_handoff(data[:-8])
    with pytest.raises(ValueError, match="required"):
        pack_handoff({k: v for k, v in h.items() if k != "first_token"})
    with pytest.raises(ValueError, match="5-d page-pool shape"):
        pack_handoff(dict(h, v=h["v"][:1]))
    with pytest.raises(HandoffError, match="bound"):
        unpack_handoff(data, max_bytes=len(data) - 1)
    with pytest.raises(HandoffError, match="pages"):
        unpack_handoff(data, max_pages=1)


def test_handoff_kv_dtype_roundtrip():
    h8 = _fake_handoff("int8")
    blob = pack_handoff(h8)
    assert len(blob) < len(pack_handoff(_fake_handoff())) / 2
    out = unpack_handoff(blob)
    assert out["kv_dtype"] == "int8" and out["k"].dtype == np.int8
    assert out["k"].tobytes() == h8["k"].tobytes()
    np.testing.assert_array_equal(out["v_scales"], h8["v_scales"])
    with pytest.raises(ValueError, match="scale tables"):
        pack_handoff(dict(h8, k_scales=None))


def test_handoff_unknown_kv_dtype_rejected_by_name():
    h = _fake_handoff()
    with pytest.raises(ValueError, match="fp4"):
        pack_handoff(dict(h, kv_dtype="fp4"))
    data = pack_handoff(h)
    off = len(HANDOFF_MAGIC)
    hlen = int.from_bytes(data[off:off + 8], "big")
    hdr = json.loads(data[off + 8:off + 8 + hlen].decode())

    def reforge(hdr):
        enc = json.dumps(hdr, sort_keys=True).encode()
        return (HANDOFF_MAGIC + len(enc).to_bytes(8, "big") + enc
                + data[off + 8 + hlen:])

    with pytest.raises(HandoffError, match="fp4"):
        unpack_handoff(reforge(dict(hdr, kv_dtype="fp4", dtype="fp4")))
    with pytest.raises(HandoffError, match="contradicts"):
        unpack_handoff(reforge(dict(hdr, kv_dtype="int8", dtype="float32")))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_handoff_blobs_cross_the_packages(kv_dtype):
    h = _fake_handoff(kv_dtype)
    blob = pack_handoff(h)
    assert blob == jfleet.pack_handoff(h)
    for out in (unpack_handoff(jfleet.pack_handoff(h)),
                jfleet.unpack_handoff(blob)):
        assert pack_handoff(out) == blob
        for key in ("k", "v", "k_scales", "v_scales"):
            if key in h:
                assert out[key].tobytes() == np.asarray(h[key]).tobytes()


# ---------------------------------------------------------------------------
# the engines, driven by hand


@pytest.fixture(scope="module")
def lm():
    model = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                           num_layers=2, dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    return model, params


def _port_engine(lm, **over):
    model = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                        dropout=0.0), lm[1])
    cfg = DecodeConfig(**dict(GEOMETRY, **over))
    eng = DecodeEngine(LMAdapter(model, cap=cfg.cap), cfg,
                       metrics=Metrics())
    eng._ensure_thread = lambda: None
    return eng


def _jax_engine(lm, **over):
    cfg = jde.DecodeConfig(**dict(GEOMETRY, **over))
    eng = jde.DecodeEngine(jde.LMAdapter(lm[0], lm[1], cap=cfg.cap), cfg)
    eng._ensure_thread = lambda: None
    return eng


def _iterate(eng) -> None:
    """One engine iteration of either package's loop, on this thread."""
    import time

    with eng._iter_lock:
        now = time.time()
        eng._sweep_cancelled()
        eng._expire(now)
        if isinstance(eng, jde.DecodeEngine):
            eng._admit(now)
        else:
            eng._admit()
        eng._decode_step()
        eng._prefill_one()


def _drive(eng, reqs, until=None, limit=200, submit=True):
    """Submit ``reqs`` (the port's or JAX's requests; ``submit=False``:
    queued already), then iterate until every one is done (or ``until()``
    holds); returns the results."""
    for r in reqs if submit else ():
        eng.submit(r)
    for _ in range(limit):
        if (until() if until is not None
                else all(r._event.is_set() for r in reqs)):
            break
        _iterate(eng)
    else:
        raise AssertionError("the engine did not finish")
    return [r.wait(0) for r in reqs] if until is None else None


def _shared_prompts():
    rs = np.random.RandomState(0)
    common = rs.randint(2, 32, size=9).tolist()
    return (np.asarray(common + [5, 7], np.int32),
            np.asarray(common + [9, 3, 11], np.int32))


def _same(got, want, tol):
    assert got.tokens.tolist() == want.tokens.tolist()
    assert got.finish_reason == want.finish_reason
    assert abs(got.logp - want.logp) <= tol


def _events(eng):
    return [tuple(e) for e in eng.events]


@pytest.fixture(scope="module", params=["float32", "int8"])
def prefix_runs(lm, request):
    """Cold then attached runs (greedy, then seeded) on a JAX engine with
    the prefix cache, and the JAX engine's state after them."""
    kv = request.param
    eng = _jax_engine(lm, kv_dtype=kv)
    p1, p2 = _shared_prompts()
    res = []
    for i, (p, kw) in enumerate(((p1, {}), (p2, {}), (p2, SAMPLE_KW))):
        res += _drive(eng, [jde.DecodeRequest(tokens=p, max_new_tokens=6,
                                              rid=f"r{i}", **kw)])
    out = (kv, res, eng._prefix_cache.stats(), _events(eng),
           len(eng._free_pages), dict(eng.stats))
    eng.stop()
    return out


def test_prefix_cache_engine_matches_jax(lm, prefix_runs):
    kv, want, jstats, jevents, jfree, jengine = prefix_runs
    eng = _port_engine(lm, kv_dtype=kv)
    p1, p2 = _shared_prompts()
    got, snap = [], None
    for i, (p, kw) in enumerate(((p1, {}), (p2, {}), (p2, SAMPLE_KW))):
        got += _drive(eng, [DecodeRequest(tokens=p, max_new_tokens=6,
                                          rid=f"r{i}", **kw)])
        if i == 0:
            # the donated pages' bytes and scales before a neighbour
            # prefills past them
            entry, = eng._prefix_cache._entries.values()
            ids = torch.tensor(entry.pages)
            snap = [t[:, ids].clone() for t in (eng._kv_k, eng._kv_v)
                    + ((eng._kv_sk, eng._kv_sv) if kv == "int8" else ())]
    for g, w in zip(got, want):
        _same(g, w, 1e-4)
    # the attached runs against the port's own cold runs (an engine
    # without the cache, the same page type)
    cold_eng = _port_engine(lm, kv_dtype=kv, prefix_cache_pages=0)
    cold = [_drive(cold_eng, [DecodeRequest(tokens=p2, max_new_tokens=6,
                                            **kw)])[0]
            for kw in ({}, SAMPLE_KW)]
    cold_eng.stop()
    _same(got[1], cold[0], 1e-5)
    _same(got[2], cold[1], 1e-5)
    st = eng._prefix_cache.stats()
    assert st == jstats
    assert st["hits"] == 2 and st["misses"] == 1 and st["insertions"] == 1
    assert _events(eng) == jevents
    assert ("prefix_attach", "r1", 0, 8) in _events(eng)
    assert ("prefix_donate", "r0", 2) in _events(eng)
    m = eng.metrics
    assert m.counter("serving.fleet.prefix_cache_hits") == 2
    assert m.counter("serving.fleet.prefix_cache_misses") == 1
    # a shared page is never written: bytes and scales as donated
    entry, = eng._prefix_cache._entries.values()
    ids = torch.tensor(entry.pages)
    now = [t[:, ids] for t in (eng._kv_k, eng._kv_v)
           + ((eng._kv_sk, eng._kv_sv) if kv == "int8" else ())]
    for a, b in zip(snap, now):
        assert torch.equal(a, b)
    # exact page accounting, the JAX engine's, and the sink never held
    held = eng._prefix_cache.pages_held
    assert len(eng._free_pages) == jfree
    assert len(eng._free_pages) + held == eng.cfg.total_pages
    assert eng._reserved_pages == 0
    assert eng._sink not in entry.pages and eng._sink not in eng._free_pages
    pressure = eng.decode_pressure()
    assert pressure["prefix_cache"] == st
    eng._free_pages.extend(eng._prefix_cache.evict(held))
    assert sorted(eng._free_pages) == list(range(eng.cfg.total_pages))


def test_prefix_cache_evicts_when_admission_runs_short(lm):
    """A pool of 5 pages: the cached prefix (2 pages) is evicted for a
    request that needs 4 pages, more than the 3 free; both engines
    alike."""
    p1, _ = _shared_prompts()
    other = np.asarray([3] * 13, np.int32)
    outs = []
    for make, req in ((_jax_engine, jde.DecodeRequest),
                      (_port_engine, DecodeRequest)):
        eng = make(lm, num_pages=5)
        res = _drive(eng, [req(tokens=p1, max_new_tokens=4, rid="a")])
        res += _drive(eng, [req(tokens=other, max_new_tokens=8, rid="b")])
        stats = eng._prefix_cache.stats()
        outs.append((res, stats, len(eng._free_pages)))
        eng.stop()
    (jres, jst, jfree), (res, st, free) = outs
    for g, w in zip(res, jres):
        _same(g, w, 1e-4)
    assert st == jst and st["evicted_pages"] == 2 and free == jfree


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_handoff_across_engines_and_packages(lm, kv):
    """A prefill-only request, its blob packed and unpacked, and the
    decode from the imported pages: the tokens of a run on one engine
    (greedy and seeded) and its first token; a JAX engine's blob imported
    by the port gives the same continuation, and the port's blob
    imported by JAX.  Each engine exports and imports (its pool starts
    every import from fresh pages)."""
    _, p2 = _shared_prompts()
    a = b = _port_engine(lm, kv_dtype=kv, prefix_cache_pages=0)
    ja = jb = _jax_engine(lm, kv_dtype=kv, prefix_cache_pages=0)
    try:
        for kw in ({}, SAMPLE_KW):
            pre = DecodeRequest(tokens=p2, max_new_tokens=1, export_kv=True,
                                **kw)
            jpre = jde.DecodeRequest(tokens=p2, max_new_tokens=1,
                                     export_kv=True, **kw)
            _drive(a, [pre])
            _drive(ja, [jpre])
            exp, jexp = pre.kv_export, jpre.kv_export
            assert exp["first_token"] == jexp["first_token"]
            assert exp["k"].dtype == jexp["k"].dtype
            assert exp["k"].shape == jexp["k"].shape == (2, 3, 2, 4, 8)
            if kv == "int8":
                assert np.abs(exp["k"].astype(int)
                              - jexp["k"].astype(int)).max() <= 1
                np.testing.assert_allclose(exp["k_scales"],
                                           jexp["k_scales"], rtol=1e-5)
            else:
                np.testing.assert_allclose(exp["k"], jexp["k"], atol=1e-5)
            blob = pack_handoff(exp)
            # the one-engine run of the same page type
            ref = _drive(b, [DecodeRequest(tokens=p2, max_new_tokens=6,
                                           **kw)])[0]
            assert exp["first_token"] == int(ref.tokens[0])
            got = _drive(b, [b.submit_prefilled(unpack_handoff(blob),
                                                max_new_tokens=6)],
                         submit=False)
            _same(got[0], ref, 1e-5)
            from_jax = _drive(b, [DecodeRequest(
                tokens=p2, handoff=unpack_handoff(
                    jfleet.pack_handoff(jexp)), max_new_tokens=6,
                **{k: v for k, v in kw.items()})])[0]
            jgot = _drive(jb, [jde.DecodeRequest(
                tokens=p2, handoff=jfleet.unpack_handoff(blob),
                max_new_tokens=6, **kw)])[0]
            _same(from_jax, ref, 1e-4)
            _same(jgot, ref, 1e-4)
        assert b.stats["kv_exports"] == 2 and b.stats["kv_imports"] == 4
        assert b.metrics.counter("serving.fleet.kv_imports") == 4
        assert b.decode_pressure()["kv_imports"] == 4
        assert sorted(b._free_pages) == list(range(b.cfg.total_pages))
    finally:
        b.stop()
        jb.stop()


def test_fleet_request_validation(lm):
    _, p2 = _shared_prompts()
    eng = _port_engine(lm)
    pre = DecodeRequest(tokens=p2, max_new_tokens=1, export_kv=True)
    _drive(eng, [pre])
    h = pre.kv_export
    other = np.asarray(list(p2[:-1]) + [30], np.int32)
    with pytest.raises(ValueError, match="tokens do not match"):
        eng.submit(DecodeRequest(tokens=other, handoff=h, max_new_tokens=4))
    with pytest.raises(ValueError, match="geometry"):
        eng.submit_prefilled(dict(h, k=h["k"][:, :1], v=h["v"][:, :1]))
    i8 = _port_engine(lm, kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype 'float32' does not "
                                         "match this engine's kv_dtype "
                                         "'int8'"):
        i8.submit_prefilled(h)
    pre8 = DecodeRequest(tokens=p2, max_new_tokens=1, export_kv=True)
    _drive(i8, [pre8])
    with pytest.raises(ValueError, match="kv_dtype 'int8'"):
        eng.submit_prefilled(unpack_handoff(pack_handoff(pre8.kv_export)))
    with pytest.raises(ValueError, match="scale shape"):
        i8.submit_prefilled(dict(pre8.kv_export,
                                 k_scales=pre8.kv_export["k_scales"][:1]))
    with pytest.raises(ValueError, match="continuous"):
        _port_engine(lm, continuous=False).submit(
            DecodeRequest(tokens=p2, export_kv=True))
    # the sink page is never exported
    with pytest.raises(AssertionError, match="sink"):
        eng._export_pages([0, eng._sink])
    assert eng._sink not in [p for e in eng._prefix_cache._entries.values()
                             for p in e.pages]
    eng.stop()
    i8.stop()


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_migrate_live_slots_matches_jax(lm, kv):
    """Three requests, one queued behind a prefilling one: after the
    slots emitted tokens, ``migrate_live_slots`` on both engines gives
    the same exports (tokens, first token, resume length, pages), frozen
    rids and leftovers; each export imported into a fresh engine
    continues as the run that was never migrated."""
    prompts = [np.asarray(p, np.int32) for p in
               ([5, 9, 2, 7, 3], [4, 4, 8, 2, 6, 11, 3, 9, 2],
                [7, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2], [9, 8])]
    kws = [{}, SAMPLE_KW, {}, SAMPLE_KW]
    common = dict(prefix_cache_pages=0, kv_dtype=kv, slots=3,
                  max_new_tokens=10, pages_per_slot=6)
    eng, jeng = _port_engine(lm, **common), _jax_engine(lm, **common)
    reqs = [DecodeRequest(tokens=p, rid=f"m{i}", **kw)
            for i, (p, kw) in enumerate(zip(prompts, kws))]
    jreqs = [jde.DecodeRequest(tokens=p, rid=f"m{i}", **kw)
             for i, (p, kw) in enumerate(zip(prompts, kws))]
    for e, rs in ((eng, reqs), (jeng, jreqs)):
        _drive(e, rs, until=lambda e=e: e.stats["steps"] >= 3)
    exports, frozen, left = eng.migrate_live_slots()
    jexports, jfrozen, jleft = jeng.migrate_live_slots()
    assert (frozen, left) == (jfrozen, jleft)
    assert frozen and left
    assert len(exports) == len(jexports)
    for e, j in zip(exports, jexports):
        for key in ("tokens", "first_token", "resume_len", "seed",
                    "request_id", "migrated", "kv_dtype"):
            assert np.array_equal(e[key], j[key]), key
        assert abs(e["first_logp"] - j["first_logp"]) <= 1e-5
        assert e["k"].shape == j["k"].shape
        if kv == "int8":
            assert np.abs(e["v"].astype(int) - j["v"].astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(e["v"], j["v"], atol=1e-5)
    # a frozen slot emits nothing more
    before = {r.rid: len(eng._slots[s].generated)
              for s, r in ((s, q.req) for s, q in enumerate(eng._slots)
                           if q is not None and q.frozen)}
    _iterate(eng)
    for s, seq in enumerate(eng._slots):
        if seq is not None and seq.frozen:
            assert len(seq.generated) == before[seq.req.rid]
    for rid in frozen + left:
        eng.cancel(rid, reason="migrated")
    _iterate(eng)
    assert all(s is None for s in eng._slots)
    assert sorted(eng._free_pages) == list(range(eng.cfg.total_pages))
    # each export continues on a fresh engine as the unmigrated run
    # on the engine the slots left, whose pages are all free again
    refs = dict(zip([r.rid for r in reqs], _drive(eng, [
        DecodeRequest(tokens=p, rid=f"n{i}", **kw)
        for i, (p, kw) in enumerate(zip(prompts, kws))])))
    b = eng
    for e in exports:
        done = e["resume_len"] - 1
        got = _drive(b, [b.submit_prefilled(
            unpack_handoff(pack_handoff(e)),
            max_new_tokens=10 - done)], submit=False)[0]
        ref = refs[e["request_id"]]
        assert list(got.tokens) == list(ref.tokens[done:])
    for e in (eng, jeng):
        e.stop()


def test_speculative_migration_keeps_the_tokens(lm):
    """A speculative slot migrated into a speculative engine: the import
    fills no draft pages (as the JAX engine's ``_import_handoff``), so
    the draft starts cold and only the acceptance can move; the tokens
    are the unmigrated run's (ROADMAP C.19)."""
    from bigdl_tpu_torch.serving import SpecConfig

    prompts = [np.asarray(p, np.int32) for p in
               ([5, 9, 2, 7, 3], [4, 4, 8, 2, 6, 11, 3, 9, 2])]
    common = dict(prefix_cache_pages=0, slots=2, max_new_tokens=10,
                  pages_per_slot=6, speculative=SpecConfig(k=3, sparsity=0.5))
    eng = _port_engine(lm, **common)
    ref = _drive(eng, [DecodeRequest(tokens=p) for p in prompts])
    reqs = [DecodeRequest(tokens=p, rid=f"s{i}")
            for i, p in enumerate(prompts)]
    _drive(eng, reqs, until=lambda: all(r.rid and eng._slots[i] is not None
                                        and eng._slots[i].generated
                                        for i, r in enumerate(reqs)))
    exports, frozen, _ = eng.migrate_live_slots()
    assert frozen == ["s0", "s1"]
    b = _port_engine(lm, **common)
    for e in exports:
        i = int(e["request_id"][1:])
        done = e["resume_len"] - 1
        got = _drive(b, [b.submit_prefilled(unpack_handoff(pack_handoff(e)),
                                            max_new_tokens=10 - done)],
                     submit=False)[0]
        assert list(e["tokens"][len(prompts[i]):]) + list(got.tokens) \
            == list(ref[i].tokens)
    assert b.stats["spec_drafted"] > 0
    eng.stop()
    b.stop()
