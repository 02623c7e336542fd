"""The port's int8 serving pieces against the JAX package: the int8
quantization helpers (``ops.quantized``), weight-only int8 params
(``nn.quantized``), the int8 paged decode's plain version, and the int8
decode engine (``kv_dtype="int8"``, ``weight_quant="int8"``).

Payloads and scales must equal the JAX ones exactly (atol 0: the same
float32 divisions, round half to even).  The plain int8 decode must be
within 1e-5 of the Pallas kernel in interpret mode (float32 sums in
another order).  The int8 engine must give the JAX int8 engine's greedy
tokens with each request's summed log-prob within 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn import quantized as jnq
from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.ops import quantized as jq
from bigdl_tpu.ops.flash_attention import \
    paged_decode_attention as jax_paged_decode_attention
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn import quantized as nq
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.ops import quantized as q8
from bigdl_tpu_torch.ops.flash_attention import (paged_decode_attention,
                                                 paged_decode_attention_ref)
from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel
from bigdl_tpu_torch.utils import export_params, load_jax_params

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=8, prompt_chunk=4,
                max_new_tokens=16, eos_id=EOS, prefill_batch=2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_quantize_helpers_equal_jax(scale):
    rs = np.random.RandomState(0)
    w = (rs.randn(24, 40) * scale).astype(np.float32)
    for axis in (0, 1):
        jw, js = jq.quantize_int8(jnp.asarray(w), axis=axis)
        tw, ts = q8.quantize_int8(_t(w), axis=axis)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            q8.dequantize_int8(tw, ts, axis).numpy(),
            np.asarray(jq.dequantize_int8(jw, js, axis)))
    jb, jbs = jq.quantize_blockwise(jnp.asarray(w), 8)
    tb, tbs = q8.quantize_blockwise(_t(w), 8)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tbs.numpy(), np.asarray(jbs))
    np.testing.assert_array_equal(q8.dequantize_blockwise(tb, tbs).numpy(),
                                  np.asarray(jq.dequantize_blockwise(jb, jbs)))
    with pytest.raises(ValueError, match="multiple"):
        q8.quantize_blockwise(_t(w), 7)


def test_quantize_pages_equal_jax_with_monotone_floor():
    rs = np.random.RandomState(1)
    pages = (rs.randn(2, 5, 2, 4, 8) * 3).astype(np.float32)
    jp, js = jq.quantize_pages(jnp.asarray(pages))
    tp, ts = q8.quantize_pages(_t(pages))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # floors: fresh (0), below and above the page's own abs-max scale
    floors = np.array([[0.0, 0.01, 1.0, 0.0, 0.05]] * 2, np.float32)
    jp, js = jq.quantize_pages(jnp.asarray(pages), floor_scales=floors)
    tp, ts = q8.quantize_pages(_t(pages), floor_scales=_t(floors))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the write-back invariant: content from the grid requantizes exactly
    deq = q8.dequantize_pages(tp, ts)
    tp2, ts2 = q8.quantize_pages(deq, floor_scales=ts)
    assert torch.equal(tp2, tp) and torch.equal(ts2, ts)
    # a fresh page's stale payload reads as zeros; zeros keep scale 0
    stale = torch.randint(-127, 128, (3, 2, 4, 8), dtype=torch.int8)
    assert not q8.dequantize_pages(stale, torch.zeros(3)).any()
    _, s0 = q8.quantize_pages(torch.zeros(3, 2, 4, 8),
                              floor_scales=torch.zeros(3))
    assert not s0.any()


@pytest.fixture(scope="module")
def lm():
    model = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                           num_layers=2, dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    return model, params


def _port_model(params):
    return load_jax_params(Transformer(32, 16, 2, num_layers=2, dropout=0.0),
                           params)


def test_quantize_params_equal_jax(lm):
    _, params = lm
    want = jax.tree_util.tree_map(np.asarray, jnq.quantize_params(params))
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  params)
    got = nq.quantize_params(tree)
    assert nq.is_quantized_params(got) and not nq.is_quantized_params(tree)
    assert nq.quantize_params(got) == got          # idempotent
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), got)))
    assert flat_w.keys() == flat_g.keys()
    n_q = 0
    for path, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], w,
                                      err_msg=jax.tree_util.keystr(path))
        n_q += path[-1].key == "__w8__"
    assert n_q == 1 + 2 * 6        # embedding; wq wk wv wo l1 l2 per layer
    deq = nq.dequantize_params(got)
    jdeq = jnq.dequantize_params(jnq.quantize_params(params))
    for path, w in jax.tree_util.tree_leaves_with_path(jdeq):
        g = deq
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_int8_weights_at_rest_and_view(lm):
    _, params = lm
    model = _port_model(params)
    want = export_params(model)
    w8 = nq.Int8Weights(model)
    # the caller's module keeps its float32 weights; the copy holds int8
    for path, w in jax.tree_util.tree_leaves_with_path(export_params(model)):
        d = want
        for k in path:
            d = d[k.key]
        np.testing.assert_array_equal(w, d)
    assert w8.module is not model
    named = dict(w8.module.named_parameters())
    assert len(w8.names) == 13
    assert all(named[n].numel() == 0 for n in w8.names)      # released
    assert named["ln_out.weight"].numel() == 16              # kept
    with w8.view():
        with w8.view():                                      # re-entrant
            got = export_params(w8.module)
        assert named["embedding"].numel() == 32 * 16
    assert named["embedding"].numel() == 0
    deq = nq.dequantize_params(nq.quantize_params(
        jax.tree_util.tree_map(torch.from_numpy, want)))
    for path, w in jax.tree_util.tree_leaves_with_path(got):
        d = deq
        for k in path:
            d = d[k.key]
        np.testing.assert_array_equal(w, d.numpy())


def test_plain_int8_decode_matches_jax_kernel():
    rs = np.random.RandomState(3)
    S, h, p, d, P, nb = 4, 2, 4, 8, 16, 4
    q = rs.randn(S, h, d).astype(np.float32)
    kq, ks = jq.quantize_pages(jnp.asarray(rs.randn(P, h, p, d), jnp.float32))
    vq, vs = jq.quantize_pages(jnp.asarray(rs.randn(P, h, p, d), jnp.float32))
    pt = rs.permutation(P)[:S * nb].reshape(S, nb).astype(np.int32)
    ln = np.array([0, 3, 9, 15], np.int32)
    want = jax_paged_decode_attention(
        jnp.asarray(q), kq, vq, jnp.asarray(pt), jnp.asarray(ln),
        k_scales=ks, v_scales=vs, block_h=1, interpret=True)
    args = [_t(q), _t(kq), _t(vq), _t(pt), _t(ln)]
    scales = dict(k_scales=_t(ks), v_scales=_t(vs))
    before = dict(LAUNCHES)
    got = paged_decode_attention(*args, **scales)
    assert dict(LAUNCHES) == before            # the CPU takes the plain one
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, paged_decode_attention_ref(*args, **scales))
    with pytest.raises(ValueError, match="k_scales"):
        paged_decode_attention(*args)
    with pytest.raises(ValueError, match="only apply to int8"):
        paged_decode_attention(args[0], args[1].float(), args[2].float(),
                               *args[3:], **scales)


def _prompts(n=6, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(2, 32, (int(rs.randint(2, 11)),)).astype(np.int32)
            for _ in range(n)]


def _jax_run(lm, weight_quant=None, **over):
    model, params = lm
    cfg = jde.DecodeConfig(**dict(GEOMETRY, kv_dtype="int8", **over))
    eng = jde.DecodeEngine(jde.LMAdapter(model, params, cap=cfg.cap,
                                         weight_quant=weight_quant), cfg)
    try:
        return eng.generate(_prompts(), max_new_tokens=12)
    finally:
        eng.stop()


def _port(lm, weight_quant=None, **over):
    return InferenceModel(_port_model(lm[1]),
                          decode=DecodeConfig(**dict(GEOMETRY,
                                                     kv_dtype="int8", **over)),
                          device="cpu", weight_quant=weight_quant)


@pytest.fixture(scope="module")
def jax_int8(lm):
    return _jax_run(lm)


@pytest.mark.parametrize("use_flash", [True, False])
def test_int8_engine_matches_jax_int8_engine(lm, jax_int8, use_flash):
    """Both attention paths of the port (the paged wiring through the
    plain int8 decode, and the dequantized gather) against the JAX int8
    engine."""
    want = jax_int8
    im = _port(lm, use_flash_decode=use_flash)
    try:
        got = im.generate(_prompts(), max_new_tokens=12, return_results=True)
    finally:
        im.stop()
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist()
        assert abs(g.logp - w.logp) <= 1e-4
    assert im.decode_engine._kv_k.dtype == torch.int8


def test_int8_weights_and_pages_match_jax(lm):
    want = _jax_run(lm, weight_quant="int8")
    model = _port_model(lm[1])
    im = InferenceModel(model, decode=DecodeConfig(**dict(GEOMETRY,
                                                          kv_dtype="int8")),
                        device="cpu", weight_quant="int8")
    try:
        got = im.generate(_prompts(), max_new_tokens=12, return_results=True)
        # the served copy keeps no float32 weights between calls; the
        # caller's model is left as it was
        assert im.model.embedding.numel() == 0
        assert model.embedding.shape == (32, 16)
        with im.weights():
            assert im.model.embedding.shape == (32, 16)
    finally:
        im.stop()
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist()
        assert abs(g.logp - w.logp) <= 1e-4


def test_int8_slot_reuse_no_stale_scale_aliasing(lm):
    """A second wave through the same int8 engine (reused slots and
    pages) answers as a fresh engine does: a reused page's stale scale
    and payload never leak."""
    wave1, wave2 = _prompts(6, seed=5), _prompts(6, seed=6)
    reused, fresh = _port(lm, slots=3), _port(lm, slots=3)
    try:
        reused.generate(wave1, max_new_tokens=12)
        assert reused.decode_engine._kv_sk.any()       # the pool is dirty
        out = reused.generate(wave2, max_new_tokens=12, return_results=True)
        ref = fresh.generate(wave2, max_new_tokens=12, return_results=True)
    finally:
        reused.stop()
        fresh.stop()
    for r, o in zip(ref, out):
        assert r.tokens.tolist() == o.tokens.tolist()
        assert r.logp == o.logp


def test_kv_bytes_per_page_and_rejections(lm):
    e32 = InferenceModel(_port_model(lm[1]), decode=DecodeConfig(**GEOMETRY),
                         device="cpu").decode_engine
    e8 = _port(lm).decode_engine
    L, h, hd, page = 2, 2, 8, 4
    assert e32.kv_bytes_per_page() == 2 * L * h * page * hd * 4
    assert e8.kv_bytes_per_page() == 2 * L * h * page * hd + 2 * L * 4
    with pytest.raises(ValueError, match="weight_quant"):
        _port(lm, weight_quant="int4")
    with pytest.raises(ValueError, match="kv_dtype"):
        DecodeConfig(kv_dtype="int4")
