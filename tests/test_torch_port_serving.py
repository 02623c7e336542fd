"""The port's serving slice (bigdl_tpu_torch.serving) end to end on the
CPU: ``InferenceModel.generate`` -> ``DecodeEngine`` -> ``LMAdapter`` on
the same weights as the JAX engine.

Greedy tokens must be identical to the JAX ``DecodeEngine``'s on both
attention paths (the paged wiring through the kernel's plain version,
and the gathered path), with each request's summed log-prob within
1e-4 (float32 sums taken in another order over at most 8 tokens).
Inside the port, continuous decoding must give the tokens of
``static_generate``."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.serving.decode_engine import DecodeConfig as JaxDecodeConfig
from bigdl_tpu.serving.decode_engine import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving.decode_engine import DecodeRequest as JaxDecodeRequest
from bigdl_tpu.serving.decode_engine import LMAdapter as JaxLMAdapter
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.serving import (DecodeConfig, DecodeRequest,
                                     InferenceModel)
from bigdl_tpu_torch.serving.decode_engine import DeadlineExceededError
from bigdl_tpu_torch.utils import load_jax_params

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2)


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


def _port(lm, **over):
    _, params = lm
    model = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                        dropout=0.0), params)
    return InferenceModel(model, decode=DecodeConfig(**dict(GEOMETRY,
                                                            **over)),
                          device="cpu")


@pytest.fixture(scope="module")
def jax_results(lm):
    model, params = lm
    cfg = JaxDecodeConfig(**GEOMETRY)
    eng = JaxDecodeEngine(JaxLMAdapter(model, params, cap=cfg.cap), cfg)
    try:
        reqs = [eng.submit(JaxDecodeRequest(tokens=p))
                for p in _prompts()]
        return [r.wait(timeout=120) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("use_flash", [True, False])
def test_greedy_tokens_match_jax_engine(lm, jax_results, use_flash):
    im = _port(lm, use_flash_decode=use_flash)
    try:
        before = LAUNCHES["paged_decode_attention"]
        toks = im.generate(_prompts())
        res = im.generate(_prompts(), return_results=True)
    finally:
        im.stop()
    # on the CPU the wrapper takes the plain version: no kernel launch
    assert LAUNCHES["paged_decode_attention"] == before
    for t, r, want in zip(toks, res, jax_results):
        assert t.tolist() == want.tokens.tolist()
        assert r.tokens.tolist() == want.tokens.tolist()
        assert r.finish_reason == want.finish_reason
        assert abs(r.logp - want.logp) <= 1e-4


@pytest.mark.parametrize("use_flash", [True, False])
def test_continuous_matches_static(lm, use_flash):
    im = _port(lm, use_flash_decode=use_flash)
    eng = im.decode_engine
    try:
        static = eng.static_generate(
            [DecodeRequest(tokens=p) for p in _prompts()])
        # a second wave inserted while the first decodes
        first = [eng.submit(DecodeRequest(tokens=p))
                 for p in _prompts()[:3]]
        time.sleep(0.05)
        rest = [eng.submit(DecodeRequest(tokens=p))
                for p in _prompts()[3:]]
        res = [r.wait(timeout=120) for r in first + rest]
    finally:
        im.stop()
    for a, b in zip(res, static):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert a.finish_reason == b.finish_reason
        assert abs(a.logp - b.logp) <= 1e-5
    # every page and reservation came back
    assert sorted(eng._free_pages) == list(range(eng.cfg.total_pages))
    assert eng._reserved_pages == 0
    assert eng.stats["completed"] == len(res)


def test_whole_batch_restart_mode_same_answers(lm, jax_results):
    im = _port(lm, continuous=False)
    try:
        res = im.generate(_prompts(), return_results=True)
    finally:
        im.stop()
    for r, want in zip(res, jax_results):
        assert r.tokens.tolist() == want.tokens.tolist()


def test_page_pressure_admission(lm, jax_results):
    """A pool smaller than slots * pages_per_slot admits only what it
    can reserve; the rest waits for released pages and still gets the
    same answers."""
    im = _port(lm, num_pages=6)
    try:
        res = im.generate(_prompts(), return_results=True)
    finally:
        im.stop()
    for r, want in zip(res, jax_results):
        assert r.tokens.tolist() == want.tokens.tolist()


def test_chunk_not_dividing_cap(lm):
    """prompt_chunk 6 against a cap of 16: a 15-token prompt's final
    chunk pads past the cap, and the answers still match JAX's."""
    model, params = lm
    prompts = _prompts((15, 4, 13))
    cfg = JaxDecodeConfig(**dict(GEOMETRY, prompt_chunk=6))
    eng = JaxDecodeEngine(JaxLMAdapter(model, params, cap=cfg.cap), cfg)
    try:
        want = [eng.submit(JaxDecodeRequest(tokens=p)) for p in prompts]
        want = [r.wait(timeout=120) for r in want]
    finally:
        eng.stop()
    im = _port(lm, prompt_chunk=6)
    try:
        got = im.generate(prompts)
    finally:
        im.stop()
    assert [g.tolist() for g in got] == [w.tokens.tolist() for w in want]


def test_generate_stream_and_warmup(lm, jax_results):
    im = _port(lm).warmup()
    try:
        eng = im.decode_engine
        # warm calls write no live page: only the sink, id total_pages
        assert not eng._kv_k[:, :eng.cfg.total_pages].any()
        got = list(im.generate_stream(_prompts()[2]))
    finally:
        im.stop()
    assert got == jax_results[2].tokens.tolist()


def test_deadline_expires_request(lm):
    im = _port(lm)
    try:
        with pytest.raises(DeadlineExceededError):
            im.generate(_prompts()[:1], deadline_s=-1.0)
    finally:
        im.stop()
    assert im.decode_engine.stats["expired"] == 1


@pytest.mark.parametrize("kw, match", [
    # int8 pages are ported; another page type is still refused
    (dict(kv_dtype="int4"), "int8"),
    # speculation is ported; only a SpecConfig turns it on
    (dict(speculative=object()), "speculative"),
    (dict(prefix_cache_pages=4), "prefix cache"),
    (dict(slots=1), ">= 2"),
])
def test_config_refuses_unported(kw, match):
    with pytest.raises(ValueError, match=match):
        DecodeConfig(**kw)


def test_sampling_and_bad_prompts_refused(lm):
    """Sampling is served now (its parity with JAX is in
    test_torch_port_prng.py); bad prompts are still refused."""
    im = _port(lm)
    try:
        got = im.generate(_prompts()[:2], temperature=0.8, top_k=5,
                          seeds=[3, 4])
        again = im.generate(_prompts()[:2], temperature=0.8, top_k=5,
                            seeds=[3, 4])
        assert [g.tolist() for g in got] == [a.tolist() for a in again]
        with pytest.raises(ValueError, match="empty prompt"):
            im.generate([np.zeros((0,), np.int32)])
        with pytest.raises(ValueError, match="cap"):
            im.generate([np.full((16,), 3, np.int32)])
    finally:
        im.stop()


def test_missing_gpu_raises_unless_cpu_asked(lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Transformer(32, 16, 2, num_layers=1, dropout=0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceModel(model, decode=DecodeConfig(**GEOMETRY))
    InferenceModel(model, decode=DecodeConfig(**GEOMETRY),
                   device="cpu").stop()


def test_port_imports_no_jax():
    code = ("import sys, bigdl_tpu_torch.serving.decode_engine, "
            "bigdl_tpu_torch.serving, bigdl_tpu_torch.utils, "
            "bigdl_tpu_torch.optim, bigdl_tpu_torch.data, "
            "bigdl_tpu_torch.nn.criterion, bigdl_tpu_torch.ops;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bigdl_tpu'));"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
