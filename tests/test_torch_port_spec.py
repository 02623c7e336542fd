"""Speculative serving in the port (``DecodeConfig(speculative=
SpecConfig(...))``) against the JAX package: the verify kernel's plain
version, spec-on against spec-off, and the port's speculative engine
against the JAX speculative engine.

Contracts: the plain ``paged_verify_attention`` within 1e-5 of the
Pallas kernel in interpret mode (float32 and int8 pages); a dense twin
(sparsity 0) gives spec-off's tokens with no rejected draft; a
0.5-sparse draft gives spec-off's tokens and the JAX speculative
engine's tokens (greedy and seeded sampling); the chunk verify (through
the plain verify) gives spec-off's tokens; int8 pages under speculation
give the JAX engine's tokens.

Summed log-probs: within 1e-5 of spec-off (the scan verify repeats the
decode step's math, but over a cache bucket up to k positions wider,
and torch's CPU reductions change order with the width — the tolerance
the port's continuous-vs-static check uses), within 2e-5 for the chunk
form, within 1e-4 of the JAX engine (as the greedy serving tests), int8
pages included: with the same drafts both engines write the same
rejected K/V into the pages (the largest gap measured on these prompts
is 1.9e-6).  Int8 spec-on against int8 spec-off: within 0.15, the budget
the JAX package holds its own int8 speculation to
(tests/test_spec_decode.py), since a rejected draft's K/V is written and
the monotone page scales remember it (4.1e-3 measured here, in both
packages).

The JAX engine dispatches its draft prefill asynchronously over a host
scratch block that the next prefill call refills; on the CPU the device
call can read the refilled block, and a slot's draft pool then holds
another chunk's K/V: from run to run its drafts change, its tokens do
not, and under int8 pages its log-probs move by up to 1.4e-3 (the
rejected drafts' K/V differ).  The reference engine here waits for each
draft prefill call, so its drafts are those of the draft model."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.ops.flash_attention import \
    paged_verify_attention as jax_paged_verify_attention
from bigdl_tpu.ops.quantized import quantize_pages
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.ops.flash_attention import (paged_verify_attention,
                                                 paged_verify_attention_ref)
from bigdl_tpu_torch.serving import (DecodeConfig, DecodeRequest,
                                     InferenceModel, SpecConfig)
from bigdl_tpu_torch.serving.decode_engine import DeadlineExceededError
from bigdl_tpu_torch.utils import load_jax_params

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2)
SAMPLE_KW = dict(temperature=1.3, top_k=5, top_p=0.9)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [1, 4])
def test_plain_verify_matches_jax_kernel(int8, C):
    rs = np.random.RandomState(3)
    S, h, d, P, nb, page = 4, 2, 8, 16, 4, 4
    q = rs.randn(S, h, C, d).astype(np.float32)
    kp = jnp.asarray(rs.randn(P, h, page, d).astype(np.float32))
    vp = jnp.asarray(rs.randn(P, h, page, d).astype(np.float32))
    scales, jscales = {}, {}
    if int8:
        kp, ks = quantize_pages(kp)
        vp, vs = quantize_pages(vp)
        jscales = dict(k_scales=ks, v_scales=vs)
        scales = dict(k_scales=_t(ks), v_scales=_t(vs))
    pt = rs.permutation(P)[:S * nb].reshape(S, nb).astype(np.int32)
    pos = np.array([0, 3, 7, nb * page - C], np.int32)
    want = jax_paged_verify_attention(jnp.asarray(q), kp, vp,
                                      jnp.asarray(pt), jnp.asarray(pos),
                                      block_h=1, interpret=True, **jscales)
    args = [_t(q), _t(kp), _t(vp), _t(pt), _t(pos)]
    before = dict(LAUNCHES)
    got = paged_verify_attention(*args, **scales)
    assert dict(LAUNCHES) == before            # the CPU takes the plain one
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, paged_verify_attention_ref(*args, **scales))
    with pytest.raises(ValueError, match="chunk"):
        paged_verify_attention(args[0][:, :, 0], *args[1:], **scales)


@pytest.fixture(scope="module")
def lm():
    model = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                           num_layers=2, dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    return model, params


def _prompts(ns=(3, 5, 9, 2, 7, 11), seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(2, 32, (n,)).astype(np.int32) for n in ns]


def _port(lm, spec=None, **over):
    return InferenceModel(
        load_jax_params(Transformer(32, 16, 2, num_layers=2, dropout=0.0),
                        lm[1]),
        decode=DecodeConfig(**dict(GEOMETRY, speculative=spec, **over)),
        device="cpu")


def _run(im, sample=False, prompts=None):
    kw = SAMPLE_KW if sample else {}
    try:
        return im.generate(prompts or _prompts(),
                           seeds=[100 + i for i in range(6)],
                           return_results=True, **kw)
    finally:
        im.stop()


def _jax_spec(lm, samples=(False,), **over):
    """The JAX speculative engine's results, one wave per entry of
    ``samples`` (greedy or sampled) on one engine."""
    model, params = lm
    cfg = jde.DecodeConfig(**dict(GEOMETRY, **over),
                           speculative=jde.SpecConfig(k=3, sparsity=0.5))
    eng = jde.DecodeEngine(jde.LMAdapter(model, params, cap=cfg.cap), cfg)
    draft_prefill_fn = eng._draft_prefill_fn

    def blocking_draft_prefill_fn(nb):
        fn = draft_prefill_fn(nb)
        return lambda *a: jax.block_until_ready(fn(*a))

    eng._draft_prefill_fn = blocking_draft_prefill_fn
    waves = []
    try:
        for sample in samples:
            kw = SAMPLE_KW if sample else {}
            reqs = [eng.submit(jde.DecodeRequest(tokens=p, seed=100 + i,
                                                 **kw))
                    for i, p in enumerate(_prompts())]
            waves.append([r.wait(timeout=120) for r in reqs])
        return waves
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_spec(lm):
    return _jax_spec(lm, (False, True))


def _same(got, want, logp_tol):
    for a, b in zip(got, want):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert a.finish_reason == b.finish_reason
        assert abs(a.logp - b.logp) <= logp_tol


@pytest.fixture(scope="module")
def spec_off(lm):
    return _run(_port(lm)), _run(_port(lm), sample=True)


def test_dense_twin_parity_full_acceptance(lm, spec_off):
    im = _port(lm, SpecConfig(k=3, sparsity=0.0))
    eng = im.decode_engine
    draft = eng._draft_model
    # the twin holds the served model's own parameters, not copies
    assert all(a is b for a, b in zip(draft.parameters(),
                                      im.model.parameters()))
    got = _run(im)
    _same(got, spec_off[0], 1e-5)
    assert eng.stats["spec_drafted"] > 0 and eng.stats["spec_accepted"] > 0
    assert eng.stats["spec_rejected"] == 0


@pytest.mark.parametrize("sample", [False, True])
def test_sparse_draft_matches_spec_off_and_jax_spec_engine(lm, spec_off,
                                                           jax_spec, sample):
    want = jax_spec[int(sample)]
    im = _port(lm, SpecConfig(k=3, sparsity=0.5))
    eng = im.decode_engine
    got = _run(im, sample)
    _same(got, want, 1e-4)
    _same(got, spec_off[int(sample)], 1e-4)
    assert eng.stats["spec_accepted"] > 0
    assert eng.stats["spec_accepted"] + eng.stats["spec_rejected"] \
        <= eng.stats["spec_drafted"]
    assert eng.stats["tokens"] == sum(len(r.tokens) - 1 for r in got)
    assert sorted(eng._free_pages) == list(range(eng.cfg.total_pages))


@pytest.mark.parametrize("over", [dict(use_flash_decode=True),
                                  dict(spec=dict(verify_impl="chunk"))])
def test_chunk_verify_tokens_and_sampled_scan_routing(lm, spec_off, over):
    """The chunk form (auto with the paged wiring, or asked for) gives
    spec-off's greedy tokens; a sampled iteration routes to the scan
    form and gives spec-off's sampled tokens (top-k/top-p would not
    survive the chunk pass's last-ulp drift)."""
    spec_kw = dict(k=3, sparsity=0.5, **over.get("spec", {}))
    eng_kw = {k: v for k, v in over.items() if k != "spec"}
    _same(_run(_port(lm, SpecConfig(**spec_kw), **eng_kw)), spec_off[0],
          2e-5)
    _same(_run(_port(lm, SpecConfig(**spec_kw), **eng_kw), sample=True),
          spec_off[1], 2e-5)


def test_int8_pages_under_speculation_match_jax(lm):
    want = _jax_spec(lm, kv_dtype="int8")[0]
    got = _run(_port(lm, SpecConfig(k=3, sparsity=0.5), kv_dtype="int8"))
    _same(got, want, 1e-4)
    _same(got, _run(_port(lm, kv_dtype="int8")), 0.15)


def test_mid_flight_admission_and_expiry_free_draft_pages(lm):
    im = _port(lm, SpecConfig(k=3, sparsity=0.5))
    eng = im.decode_engine
    try:
        want = eng.static_generate([DecodeRequest(tokens=p, seed=100 + i,
                                                  **SAMPLE_KW)
                                    for i, p in enumerate(_prompts())])
        reqs = [DecodeRequest(tokens=p, seed=100 + i, **SAMPLE_KW)
                for i, p in enumerate(_prompts())]
        for r in reqs[:3]:
            eng.submit(r)
        time.sleep(0.05)
        for r in reqs[3:]:
            eng.submit(r)
        got = [r.wait(timeout=120) for r in reqs]
        _same(got, want, 1e-5)
    finally:
        im.stop()
    assert eng.kv_bytes_per_page() == 2 * (2 * 2 * 2 * 4 * 8 * 4)
    # a deadline passing mid-generation frees draft and target pages
    # together (one page table)
    im = _port(lm, SpecConfig(k=3, sparsity=0.5), pages_per_slot=64,
               max_new_tokens=240)
    eng = im.decode_engine
    try:
        late = eng.submit(DecodeRequest(tokens=_prompts()[4],
                                        deadline_t=time.time() + 0.3))
        with pytest.raises(DeadlineExceededError):
            late.wait(timeout=60)
        assert 0 < len(late.error.partial_tokens) < 240
        deadline = time.time() + 30
        while len(eng._free_pages) != eng.cfg.total_pages \
                or eng._reserved_pages:
            assert time.time() < deadline, "page leak after expiry"
            time.sleep(0.01)
    finally:
        im.stop()


def test_spec_config_validation(lm):
    with pytest.raises(ValueError, match="continuous"):
        _port(lm, SpecConfig(k=3), continuous=False)
    with pytest.raises(ValueError, match="SpecConfig.k"):
        _port(lm, SpecConfig(k=0))
    with pytest.raises(ValueError, match="SpecConfig.k"):
        _port(lm, SpecConfig(k=16))    # >= cap (4*4)
    for impl in ("magic", "masked"):
        with pytest.raises(ValueError, match="draft_impl"):
            _port(lm, SpecConfig(k=2, sparsity=0.5, draft_impl=impl))
    with pytest.raises(ValueError, match="verify_impl"):
        _port(lm, SpecConfig(k=2, verify_impl="magic"))
    with pytest.raises(ValueError, match="float32 KV"):
        _port(lm, SpecConfig(k=2, verify_impl="chunk"), kv_dtype="int8")
    # the draft window is ported (test_draft_window_matches_jax); a
    # window under one position is refused, as in the JAX package
    with pytest.raises(ValueError, match="draft_window"):
        _port(lm, SpecConfig(k=2, draft_window=0))


def _windowed_jax(lm, window, sample):
    """The JAX speculative engine with ``draft_window``: its results, its
    stats and every spec call's drafts of the active slots."""
    model, params = lm
    cfg = jde.DecodeConfig(**GEOMETRY, speculative=jde.SpecConfig(
        k=3, sparsity=0.5, draft_window=window))
    eng = jde.DecodeEngine(jde.LMAdapter(model, params, cap=cfg.cap), cfg)
    draft_prefill_fn, draft_fn = eng._draft_prefill_fn, eng._draft_fn
    drafts = []

    def blocking_draft_prefill_fn(nb):
        fn = draft_prefill_fn(nb)
        return lambda *a: jax.block_until_ready(fn(*a))

    def logged_draft_fn(nb):
        fn = draft_fn(nb)

        def run(*a):
            out = fn(*a)
            active = np.asarray(a[5])
            drafts.append(np.asarray(out[2])[active].tolist())
            return out
        return run

    eng._draft_prefill_fn = blocking_draft_prefill_fn
    eng._draft_fn = logged_draft_fn
    kw = SAMPLE_KW if sample else {}
    try:
        with eng._iter_lock:
            reqs = [eng.submit(jde.DecodeRequest(tokens=p, seed=100 + i,
                                                 **kw))
                    for i, p in enumerate(_prompts())]
        return [r.wait(timeout=120) for r in reqs], dict(eng.stats), drafts
    finally:
        eng.stop()


@pytest.mark.parametrize("sample", [False, True])
def test_draft_window_matches_jax(lm, spec_off, sample):
    """``SpecConfig.draft_window`` (W = 5: the ring windows every bucket
    of 8 and 16 positions): spec-off's tokens, and the JAX windowed
    engine's tokens, drafts and acceptance."""
    want, jstats, jdrafts = _windowed_jax(lm, 5, sample)
    im = _port(lm, SpecConfig(k=3, sparsity=0.5, draft_window=5))
    eng = im.decode_engine
    drafts = []
    call = eng._call

    def logged_call(name, n_blocks, sampled):
        out = call(name, n_blocks, sampled)
        if name == "spec":
            active = eng._active_mask.copy()
            drafts.append(out["d_toks"][active].tolist())
        return out

    eng._call = logged_call
    got = _run(im, sample)
    _same(got, want, 1e-4)
    _same(got, spec_off[int(sample)], 1e-4)
    assert drafts == jdrafts
    for key in ("spec_drafted", "spec_accepted", "spec_rejected", "tokens"):
        assert eng.stats[key] == jstats[key], key
