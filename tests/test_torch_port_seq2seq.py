"""Translation serving in the port against the JAX package: the decode
engine over a ``Seq2SeqAdapter`` (the encoder as the "prefill", per-slot
cross-attention context read by every step) and ``Seq2SeqService``
(continuous, static, beam), on a two-layer translation Transformer with
the JAX weights.

Contracts: tokens equal to the JAX engine's and service's (greedy,
seeded sampling, beam 4); summed log-probs within 1e-4 of JAX's (float32
sums in another order, as test_torch_port_serving.py), within 1e-5 of
the port's own static reference, and the engine's greedy tokens equal to
``nn.attention.transformer_decode_cached`` on sources of one length (its
encoder has no padding mask)."""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu.serving.seq2seq import Seq2SeqService as JaxSeq2SeqService
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.attention import transformer_decode_cached
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                     DecodeRequest, Seq2SeqAdapter,
                                     Seq2SeqService, SpecConfig)
from bigdl_tpu_torch.utils import load_jax_params

BOS, EOS = 0, 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=3, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2)
SRC_BUCKETS = (4, 8)
SAMPLE_KW = dict(temperature=2.0, top_k=6, top_p=0.9)


@pytest.fixture(scope="module")
def s2s():
    model = JaxTransformer(vocab_size=16, hidden_size=16, num_heads=2,
                           num_layers=2, dropout=0.0, mode="translation")
    src = np.array([[2, 5, 6, 3], [2, 3, 4, 5], [7, 8, 9, 10]], np.int32)
    v = model.init(jax.random.PRNGKey(0), src, src)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    port = load_jax_params(Transformer(16, 16, 2, num_layers=2, dropout=0.0,
                                       mode="translation"), params)
    return model, params, port, src


def _sources():
    """Sources of 2 to 8 tokens: both source buckets, padded encodes."""
    rs = np.random.RandomState(1)
    return [rs.randint(2, 16, (n,)).astype(np.int32)
            for n in (3, 7, 2, 5, 8, 4)]


def _same(got, want, tol):
    assert got.tokens.tolist() == want.tokens.tolist()
    assert got.finish_reason == want.finish_reason
    assert abs(got.logp - want.logp) <= tol


def _port_engine(s2s, **over):
    cfg = DecodeConfig(**dict(GEOMETRY, **over))
    return DecodeEngine(Seq2SeqAdapter(s2s[2], cap=cfg.cap, bos_id=BOS,
                                       src_buckets=SRC_BUCKETS), cfg)


@pytest.fixture(scope="module")
def jax_engine_results(s2s):
    model, params = s2s[:2]
    cfg = jde.DecodeConfig(**GEOMETRY)
    eng = jde.DecodeEngine(jde.Seq2SeqAdapter(model, params, cap=cfg.cap,
                                              bos_id=BOS,
                                              src_buckets=SRC_BUCKETS), cfg)
    out = []
    try:
        for kw in ({}, SAMPLE_KW):
            with eng._iter_lock:
                reqs = [eng.submit(jde.DecodeRequest(tokens=p, seed=100 + i,
                                                     **kw))
                        for i, p in enumerate(_sources())]
            out.append([r.wait(timeout=120) for r in reqs])
        return out
    finally:
        eng.stop()


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("sample", [False, True])
def test_engine_matches_jax_engine(s2s, jax_engine_results, sample,
                                   use_flash):
    """Every decode step of every layer through the paged wiring (the
    kernel's plain version on the CPU) or the gathered path."""
    eng = _port_engine(s2s, use_flash_decode=use_flash)
    kw = SAMPLE_KW if sample else {}
    before = dict(LAUNCHES)
    try:
        reqs = eng.submit_many([DecodeRequest(tokens=p, seed=100 + i, **kw)
                                for i, p in enumerate(_sources())])
        got = [r.wait(timeout=120) for r in reqs]
        static = eng.static_generate([
            DecodeRequest(tokens=p, seed=100 + i, **kw)
            for i, p in enumerate(_sources())])
    finally:
        eng.stop()
    assert dict(LAUNCHES) == before        # the CPU takes the plain versions
    for g, w, st in zip(got, jax_engine_results[int(sample)], static):
        _same(g, w, 1e-4)
        _same(g, st, 1e-5)
        assert g.prompt_len == 1
    assert sorted(eng._free_pages) == list(range(eng.cfg.total_pages))
    assert all(s is None for s in eng._slots)


def test_service_translates_sources_of_several_lengths(s2s,
                                                      jax_engine_results):
    """``translate`` of a list of sources of different lengths (each
    encoded at its own bucket, queued together): the JAX engine's greedy
    tokens, EOS-padded to ``max_len``, and its summed log-probs."""
    svc = Seq2SeqService(s2s[2], BOS, EOS, max_len=8, src_buckets=SRC_BUCKETS,
                         device="cpu")
    try:
        toks, scores = svc.translate(_sources())
    finally:
        svc.stop()
    assert toks.shape == (6, 9) and (toks[:, 0] == BOS).all()
    for row, score, want in zip(toks, scores, jax_engine_results[0]):
        n = len(want.tokens)
        assert row[1:1 + n].tolist() == want.tokens.tolist()
        assert (row[1 + n:] == EOS).all()
        assert abs(float(score) - want.logp) <= 1e-4


def test_engine_greedy_matches_cached_decoder(s2s):
    """The engine's greedy tokens against ``transformer_decode_cached``
    on sources of one length, which need no padding mask."""
    src = s2s[3]
    max_len = GEOMETRY["max_new_tokens"]
    want, _ = transformer_decode_cached(s2s[2], torch.from_numpy(src), BOS,
                                        EOS, max_len=max_len)
    eng = _port_engine(s2s)
    try:
        got = eng.generate(list(src))
    finally:
        eng.stop()
    for g, w in zip(got, want.numpy()):
        gen = w[1:]
        n = len(g.tokens)
        assert g.tokens.tolist() == gen[:n].tolist()
        assert g.finish_reason == "length" or g.tokens[-1] == EOS


@pytest.mark.parametrize("sample", [False, True])
def test_service_continuous_matches_jax_and_static(s2s, sample):
    model, params, port, src = s2s
    kw = dict(max_len=8, sample=sample, temperature=2.0, top_k=6, top_p=0.9)
    jsvc = JaxSeq2SeqService(model, params, BOS, EOS, **kw)
    svc = Seq2SeqService(port, BOS, EOS, device="cpu", **kw)
    static = Seq2SeqService(port, BOS, EOS, device="cpu", continuous=False,
                            **kw)
    try:
        jt, js = jsvc.translate(src)
        tt, ts = svc.warmup().translate(src)
        st, ss = static.translate(src)
        assert svc.decode_engine.active_slots() == 0
    finally:
        for s in (jsvc, svc, static):
            s.stop()
    assert tt.shape == (3, 9) and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tt, st)
    np.testing.assert_allclose(ts, ss, rtol=0, atol=1e-5)


def test_service_beam_matches_jax(s2s):
    model, params, port, src = s2s
    src5 = np.concatenate([src, src[:2, ::-1]])    # 5 rows: bucket 16
    jt, js = JaxSeq2SeqService(model, params, BOS, EOS, max_len=8,
                               beam_size=4).translate(src5)
    svc = Seq2SeqService(port, BOS, EOS, max_len=8, beam_size=4,
                         device="cpu")
    tt, ts = svc.translate(src5)
    assert svc.decode_engine is None         # beams skip the engine
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-4)


def test_seq2seq_refusals(s2s):
    port = s2s[2]
    with pytest.raises(ValueError, match="LM adapters only"):
        _port_engine(s2s, speculative=SpecConfig(k=2))
    eng = _port_engine(s2s)
    try:
        with pytest.raises(ValueError, match="KV handoff/export supports "
                                             "LM adapters only"):
            eng.submit(DecodeRequest(tokens=_sources()[0], export_kv=True))
        # a source past the largest bucket fails that request alone
        bad = eng.submit(DecodeRequest(tokens=np.full((9,), 3, np.int32)))
        with pytest.raises(ValueError, match="src bucket"):
            bad.wait(timeout=60)
        ok = eng.generate([_sources()[0]])[0]
        assert ok.prompt_len == 1
        # a seq2seq slot never migrates: it is a leftover
        assert eng.migrate_live_slots()[0] == []
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="translation-mode"):
        Seq2SeqService(Transformer(16, 16, 2, num_layers=1, dropout=0.0),
                       BOS, EOS, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        Seq2SeqService(port, BOS, EOS, sample=True, beam_size=4,
                       device="cpu")
