"""The port's translation Transformer and its decoders against the JAX
package: ``MultiHeadAttention(context=...)``, ``TransformerDecoderLayer``
and ``Transformer(mode="translation")`` forward and gradients, three
training steps through each package's ``Optimizer``, ``nn/decode.py``
(tests/test_decode.py's specs, run on both packages), greedy, beam and
sampled tokens of ``transformer_decode`` / ``transformer_decode_cached``
equal to JAX's for the same key, cached decoding equal to uncached, and
``models/transformer_zoo.py``.

Both packages run the same numpy inputs on the same weights (the JAX
variables perturbed from a numpy seed, copied by ``utils.convert``).
Tolerance 1e-5 of the largest |value| (float32 sums in another order).
The attention key bias ``bk`` has an exact gradient of 0, rounding noise
in both packages (ROADMAP C.4): its gradient is not compared, and the
trajectory compares the trained logits as well as the losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data import ArrayDataSet as JArrayDataSet
from bigdl_tpu.nn import attention as jatt
from bigdl_tpu.nn import decode as jdec
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import models, nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.nn import decode as pdec
from bigdl_tpu_torch.utils import (export_params, load_jax_params,
                                   load_jax_variables, prng)
from bigdl_tpu_torch.utils.convert import jax_path

TOL = 1e-5
V, D, HEADS, FFN, LAYERS = 24, 16, 2, 32, 2
BOS, EOS = 1, 2


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _perturbed(params, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rs.randn(*np.shape(a))).astype(
            np.float32), params)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(3, V, shape).astype(np.int32)


def _translation(seed=0, **kw):
    """(JAX Transformer, its perturbed params, the port's with them)."""
    cfg = dict(num_layers=LAYERS, ffn_size=FFN, dropout=0.0, **kw)
    jm = jatt.Transformer(V, D, HEADS, mode="translation", **cfg)
    src, tgt = _tokens((2, 7), 1), _tokens((2, 5), 2)
    p = _perturbed(jm.init(jax.random.PRNGKey(seed), src, tgt)["params"],
                   seed + 1)
    tm = load_jax_params(nn.Transformer(V, D, HEADS, mode="translation",
                                        **cfg), p)
    return jm, p, tm


def _grads_match(gp, tm, tol=TOL):
    by_path = {jax_path(n): t for n, t in tm.named_parameters()}
    assert set(by_path) == {k for k, _ in _leaves(gp)}
    for path, g in _leaves(gp):
        if path[-1] != "bk":                       # ROADMAP C.4
            _close(by_path[path].grad, g, tol)


@pytest.mark.parametrize("use_flash", [False, True])
def test_cross_attention_and_decoder_layer_match_jax(use_flash):
    """The decoder block (causal self-attention, cross-attention over a
    longer memory, FFN): output and gradients of every parameter, the
    input and the memory.  ``use_flash=True`` runs the flash kernel's
    plain version at sq != skv on the CPU."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, D).astype(np.float32)
    mem = rs.randn(2, 9, D).astype(np.float32)
    jl = jatt.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0)
    p = _perturbed(jl.init(jax.random.PRNGKey(0), x, mem)["params"], 4)
    tl = load_jax_params(nn.TransformerDecoderLayer(D, HEADS, FFN,
                                                    dropout=0.0), p)
    for attn in (tl.self_attn, tl.cross_attn):
        attn.use_flash = use_flash

    def jf(params, a, m):
        y, _ = jl.forward(params, {}, a, m)
        return jnp.sum(jnp.sin(y)), y

    (_, want), (gp, gx, gm) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(p, x, mem)
    tx, tmem = (torch.tensor(a, requires_grad=True) for a in (x, mem))
    y = tl(tx, tmem)
    torch.sin(y).sum().backward()
    _close(y, want)
    _grads_match(gp, tl)
    _close(tx.grad, gx)
    _close(tmem.grad, gm)
    # cross-attention alone, with a memory mask: the plain path
    mask = np.ones((2, 1, 1, 9), bool)
    mask[1, ..., 6:] = False
    ja = jatt.MultiHeadAttention(D, HEADS)
    pa = _perturbed(ja.init(jax.random.PRNGKey(1), x, mem)["params"], 5)
    ta = load_jax_params(nn.MultiHeadAttention(D, HEADS), pa)
    _close(ta(torch.from_numpy(x), context=torch.from_numpy(mem),
              mask=torch.from_numpy(mask)),
           ja.forward(pa, {}, x, context=mem, mask=mask)[0])
    # a context narrower than the queries' width: wk, wv (12, D)
    narrow = mem[..., :12].copy()
    pn = _perturbed(ja.init(jax.random.PRNGKey(2), x, narrow)["params"], 6)
    tn = load_jax_params(nn.MultiHeadAttention(D, HEADS, context_size=12),
                         pn)
    assert tuple(tn.wk.shape) == (12, D)
    _close(tn(torch.from_numpy(x), context=torch.from_numpy(narrow)),
           ja.forward(pn, {}, x, context=narrow)[0])


def test_translation_forward_and_gradients_match_jax():
    jm, p, tm = _translation()
    assert {f"enc{i}" for i in range(LAYERS)} <= set(p)
    assert sorted(export_params(tm)) == sorted(p)
    src, tgt = _tokens((3, 7), 6), _tokens((3, 5), 7)

    def jf(params):
        y, _ = jm.forward(params, {}, src, tgt)
        return jnp.sum(jnp.sin(y)), y

    (_, want), gp = jax.jit(jax.value_and_grad(jf, has_aux=True))(p)
    y = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert y.dtype == torch.float32 and y.shape == (3, 5, V)
    torch.sin(y).sum().backward()
    _close(y, want)
    _grads_match(gp, tm)
    with pytest.raises(ValueError, match="needs \\(src, tgt\\)"):
        tm(torch.from_numpy(src))
    with pytest.raises(ValueError, match="translation \\| lm"):
        nn.Transformer(V, D, HEADS, mode="seq2seq")


def test_translation_dropout_keys_match_jax():
    """In training with dropout, a key splits as the JAX rng splits: one
    for the source embedding, one a layer (encoder, then decoder)."""
    jm, p, tm = _translation(seed=3)
    jm = jatt.Transformer(V, D, HEADS, mode="translation",
                          num_layers=LAYERS, ffn_size=FFN, dropout=0.2)
    tm2 = load_jax_params(nn.Transformer(V, D, HEADS, mode="translation",
                                         num_layers=LAYERS, ffn_size=FFN,
                                         dropout=0.2), p).train()
    src, tgt = _tokens((2, 7), 8), _tokens((2, 5), 9)
    want = jax.jit(lambda params: jm.forward(
        params, {}, src, tgt, training=True,
        rng=jax.random.PRNGKey(5))[0])(p)
    got = tm2(torch.from_numpy(src), torch.from_numpy(tgt),
              key=prng.PRNGKey(5))
    _close(got, want)


def test_translation_trains_to_jax_trajectory(tmp_path):
    """Three Adam steps on the reverse task of
    examples/transformer_translation.py through each package's
    Optimizer: the losses, and the trained model's logits on a held-out
    batch (C.4: not the parameters)."""
    jm, p, tm = _translation(seed=5)
    rs = np.random.RandomState(10)
    src = rs.randint(3, V, (24, 6)).astype(np.int32)
    tgt = src[:, ::-1].copy()
    tgt_in = np.concatenate([np.full((24, 1), BOS, np.int32), tgt[:, :-1]],
                            axis=1)
    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(jm, JArrayDataSet((src, tgt_in), tgt),
                               jnn.CrossEntropyCriterion(), batch_size=8,
                               seed=3)
        opt.set_optim_method(joptim.Adam(learning_rate=1e-2))
        opt.set_end_when(joptim.Trigger.max_iteration(3))
        opt.set_initial_variables({"params": p, "state": {}})
        opt.set_train_summary(str(tmp_path))
        trained = opt.optimize()
        want = [v for _, v in opt._train_summary.read_scalar("loss")]
        want_logits = jm.forward(trained.variables["params"], {},
                                 src[:4], tgt_in[:4])[0]
    finally:
        Engine.reset()
    popt = optim.Optimizer(tm, DataSet.array((src, tgt_in), tgt),
                           nn.CrossEntropyCriterion(), batch_size=8, seed=3,
                           device="cpu")
    popt.set_optim_method(optim.Adam(learning_rate=1e-2)).set_end_when(
        optim.Trigger.max_iteration(3))
    popt.optimize()
    assert len(want) == 3
    _close(popt.losses, want)
    with torch.no_grad():
        _close(tm(torch.from_numpy(src[:4]), torch.from_numpy(tgt_in[:4])),
               want_logits)


# ---------------------------------------------------------------------------
# nn/decode.py: tests/test_decode.py's specs on both packages
# ---------------------------------------------------------------------------

VT = 5
TBOS, TEOS = 0, 1


def _markov(tr):
    """(JAX step, port step) of a stateless Markov LM."""
    tj = jnp.asarray(tr, jnp.float32)
    tt = torch.from_numpy(np.asarray(tr, np.float32))
    return ((lambda last, s: (jnp.log(tj[last] + 1e-12), s)),
            (lambda last, s: (torch.log(tt[last.long()] + 1e-12), s)))


def _chain():
    tr = np.full((VT, VT), 1e-9, np.float32)
    tr[TBOS, 2] = tr[2, 3] = tr[3, TEOS] = tr[TEOS, TEOS] = 1.0
    return tr


def _trap():
    tr = np.full((VT, VT), 1e-9, np.float32)
    tr[TBOS, 2], tr[TBOS, 3] = 0.6, 0.4
    tr[2, 2] = tr[2, 3] = tr[2, 4] = tr[2, TEOS] = 0.25
    tr[3, TEOS] = tr[TEOS, TEOS] = 1.0
    return tr


def _longer():
    tr = np.full((VT, VT), 1e-9, np.float32)
    tr[TBOS, TEOS], tr[TBOS, 2] = 0.5, 0.3
    tr[2, 3] = tr[3, 4] = tr[4, TEOS] = tr[TEOS, TEOS] = 1.0
    return tr


def _spread():
    tr = np.full((VT, VT), 1e-9, np.float32)
    tr[TBOS, 2], tr[TBOS, 3], tr[TBOS, 4] = 0.5, 0.3, 0.2
    tr[2, TEOS] = tr[3, TEOS] = tr[4, TEOS] = tr[TEOS, TEOS] = 1.0
    return tr


def _same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            _close(g, w)


@pytest.mark.parametrize("tr", [_chain, _trap, _longer, _spread])
def test_greedy_decode_matches_jax(tr):
    js, ps = _markov(tr())
    want = jdec.greedy_decode(js, {}, 2, TBOS, TEOS, max_len=6)
    _same(pdec.greedy_decode(ps, {}, 2, TBOS, TEOS, max_len=6), want)


def test_greedy_follows_argmax_chain_and_falls_in_the_trap():
    _, ps = _markov(_chain())
    tokens, logp, lengths = pdec.greedy_decode(ps, {}, 2, TBOS, TEOS,
                                               max_len=6)
    assert tokens[0, :4].tolist() == [0, 2, 3, 1] and int(lengths[0]) == 3
    assert abs(float(logp[0])) < 1e-3
    _, ps = _markov(_trap())
    assert int(pdec.greedy_decode(ps, {}, 1, TBOS, TEOS,
                                  max_len=4)[0][0, 1]) == 2


@pytest.mark.parametrize("tr,beam,alpha", [(_trap, 3, 0.0),
                                           (_longer, 3, 0.0),
                                           (_longer, 3, 4.0),
                                           (_spread, 4, 0.6)])
def test_beam_search_matches_jax(tr, beam, alpha):
    js, ps = _markov(tr())
    want = jdec.beam_search(js, {}, 2, VT, TBOS, TEOS, beam_size=beam,
                            max_len=6, length_penalty=alpha)
    got = pdec.beam_search(ps, {}, 2, VT, TBOS, TEOS, beam_size=beam,
                           max_len=6, length_penalty=alpha)
    _same(got, want)


def test_beam_search_specs():
    _, ps = _markov(_trap())
    res = pdec.beam_search(ps, {}, 1, VT, TBOS, TEOS, beam_size=3,
                           max_len=4, length_penalty=0.0)
    assert res.tokens[0, 0, :3].tolist() == [0, 3, 1]
    np.testing.assert_allclose(float(res.log_probs[0, 0]), np.log(0.4),
                               atol=1e-4)
    assert int(res.lengths[0, 0]) == 2
    _, ps = _markov(_longer())
    assert int(pdec.beam_search(ps, {}, 1, VT, TBOS, TEOS, beam_size=3,
                                max_len=6, length_penalty=0.0)
               .lengths[0, 0]) == 1
    assert int(pdec.beam_search(ps, {}, 1, VT, TBOS, TEOS, beam_size=3,
                                max_len=6, length_penalty=4.0)
               .lengths[0, 0]) == 4
    # rows independent: a per-row bias in the state
    tr1 = np.full((VT, VT), 1e-9, np.float32)
    tr1[TBOS, 2] = tr1[2, TEOS] = tr1[TEOS, TEOS] = 1.0
    t1 = torch.from_numpy(tr1)
    bias = torch.tensor([[0.0] * VT, [0., 0., -50., 0., 0.]])
    res = pdec.beam_search(
        lambda last, s: (torch.log(t1[last.long()] + 1e-12) + s, s), bias,
        2, VT, TBOS, TEOS, beam_size=2, max_len=4)
    assert int(res.tokens[0, 0, 1]) == 2 and int(res.tokens[1, 0, 1]) != 2


def test_beam_search_reorders_a_state_as_jax():
    """A stateful (LSTM-like) step: the state (B*K, H) is gathered with
    the surviving beams; tokens, scores and lengths equal JAX's."""
    H = 8
    w = np.random.RandomState(0).randn(H, VT).astype(np.float32) * 0.3
    wt = torch.from_numpy(w)

    def jstep(last, state):
        h = jnp.tanh(state + jax.nn.one_hot(last, VT) @ w.T)
        return h @ jnp.asarray(w), h

    def pstep(last, state):
        h = torch.tanh(state + torch.nn.functional.one_hot(
            last.long(), VT).float() @ wt.T)
        return h @ wt, h

    want = jdec.beam_search(jstep, jnp.zeros((2, H)), 2, VT, TBOS, TEOS,
                            beam_size=4, max_len=10)
    got = pdec.beam_search(pstep, torch.zeros(2, H), 2, VT, TBOS, TEOS,
                           beam_size=4, max_len=10)
    _same(got, want)
    assert (np.diff(got.scores.numpy(), axis=1) <= 1e-6).all()


@pytest.mark.parametrize("kw", [dict(temperature=0.0),
                                dict(temperature=1.0, top_k=1),
                                dict(temperature=1.0),
                                dict(temperature=0.7, top_k=2),
                                dict(temperature=1.0, top_p=0.5),
                                dict(temperature=1.3, top_k=3, top_p=0.8)])
def test_sample_decode_draws_jax_tokens(kw):
    js, ps = _markov(_spread())
    want = jdec.sample_decode(js, {}, 64, TBOS, TEOS, jax.random.PRNGKey(7),
                              max_len=3, **kw)
    got = pdec.sample_decode(ps, {}, 64, TBOS, TEOS, prng.PRNGKey(7),
                             max_len=3, **kw)
    _same(got, want)
    if kw.get("top_p") == 0.5:                 # only token 2 survives
        assert set(got[0][:, 1].tolist()) == {2}
    if kw.get("temperature") == 1.0 and len(kw) == 1:
        first = got[0][:, 1].numpy()
        assert len(set(first.tolist())) == 3      # all three drawn


# ---------------------------------------------------------------------------
# the translation model's decoders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoding():
    jm, p, tm = _translation(seed=11)
    src = _tokens((3, 6), 12)
    return jm, p, tm, src


@pytest.mark.parametrize("beam", [0, 4])
def test_transformer_decode_matches_jax(decoding, beam):
    jm, p, tm, src = decoding
    want = jax.jit(lambda params: jatt.transformer_decode(
        jm, params, src, BOS, EOS, max_len=8, beam_size=beam))(p)
    got = nn.transformer_decode(tm, torch.from_numpy(src), BOS, EOS,
                                max_len=8, beam_size=beam)
    _same(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=1.0, top_k=6),
                                dict(temperature=0.8, top_p=0.9)])
def test_transformer_decode_cached_matches_jax(decoding, kw):
    jm, p, tm, src = decoding
    jkw, pkw = dict(kw), dict(kw)
    if kw:
        jkw["rng"], pkw["key"] = jax.random.PRNGKey(4), prng.PRNGKey(4)
    want = jax.jit(lambda params: jatt.transformer_decode_cached(
        jm, params, src, BOS, EOS, max_len=8, **jkw))(p)
    got = nn.transformer_decode_cached(tm, torch.from_numpy(src), BOS, EOS,
                                       max_len=8, **pkw)
    _same(got, want)


def test_cached_decode_equals_uncached(decoding):
    _, _, tm, src = decoding
    s = torch.from_numpy(src)
    tok_u, lp_u = nn.transformer_decode(tm, s, BOS, EOS, max_len=8)
    tok_c, lp_c = nn.transformer_decode_cached(tm, s, BOS, EOS, max_len=8)
    assert torch.equal(tok_u, tok_c)
    _close(lp_c, lp_u.numpy())
    a, _ = nn.transformer_decode_cached(tm, s, BOS, EOS, max_len=8,
                                        key=prng.PRNGKey(1),
                                        temperature=0.0)
    assert torch.equal(a, tok_c)
    with pytest.raises(ValueError, match="translation"):
        nn.transformer_decode(nn.Transformer(V, D, HEADS, num_layers=1),
                              s, BOS, EOS)
    assert not tm.training


# ---------------------------------------------------------------------------
# models/transformer_zoo.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["encoder", "encoder_head", "bert",
                                  "bert_classifier"])
def test_transformer_zoo_matches_jax(name):
    rs = np.random.RandomState(13)
    tokens = rs.randint(0, 30, (2, 6)).astype(np.int32)
    segments = rs.randint(0, 2, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0

    def make(M):
        if name.startswith("encoder"):
            return M.TransformerEncoder(
                30, hidden=16, layers=2, heads=2, max_len=8, dropout=0.0,
                num_classes=3 if name == "encoder_head" else None)
        bert = M.BERT(30, hidden=16, layers=2, heads=2, max_position=8,
                      dropout=0.0)
        return M.BERTClassifier(bert, 3) if name == "bert_classifier" \
            else bert

    jm = make(jmodels)
    args = (tokens,) if name.startswith("encoder") else (tokens, segments)
    v = jm.init(jax.random.PRNGKey(0), *args)
    v = {"params": _perturbed(v["params"], 14), "state": {}}
    tm = load_jax_variables(make(models).eval(), v)
    assert sorted(export_params(tm)) == sorted(v["params"])
    if name.startswith("encoder"):
        want = jm.forward(v["params"], {}, tokens)[0]
        got = tm(torch.from_numpy(tokens))
        _close(got, want)
        with pytest.raises(ValueError, match="max_len"):
            tm(torch.zeros(1, 9, dtype=torch.int32))
        return
    want = jm.forward(v["params"], {}, tokens, segments, mask=mask)[0]
    got = tm(torch.from_numpy(tokens), torch.from_numpy(segments),
             mask=torch.from_numpy(mask))
    if name == "bert":
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)
