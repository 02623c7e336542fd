"""The port's counter-based random bits (bigdl_tpu_torch.utils.prng)
against ``jax.random`` under the partitionable threefry layout, and the
two repairs that rest on them: seeded sampling in the decode engine and
seeded dropout in training.

Keys, bits, uniforms and Bernoulli masks must be bit-equal.  Sampled
tokens must be equal to the JAX engine's, with log-probs within 1e-6 per
token (1e-4 summed over a request, as the greedy serving tests).  Three
training steps of the tiny LM at dropout 0.1 must reach the JAX driver's
losses within 1e-5 (float32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn.layers import Dropout as JDropout
from bigdl_tpu.optim import optim_method as joptim
from bigdl_tpu.optim.optimizer import Optimizer as JOptimizer
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.nn import CrossEntropyCriterion, Dropout, Transformer
from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
from bigdl_tpu_torch.serving import DecodeConfig, DecodeRequest, InferenceModel
from bigdl_tpu_torch.serving.decode_engine import _select_tokens
from bigdl_tpu_torch.utils import load_jax_params, prng

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2)
SAMPLE_KW = dict(temperature=1.3, top_k=5, top_p=0.9)


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -3])
def test_keys_fold_in_split_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_u32(jk), tk.numpy())
    for d in (0, 1, 123456, 2 ** 31 - 1):
        assert np.array_equal(_u32(jax.random.fold_in(jk, d)),
                              prng.fold_in(tk, d).numpy())
    assert np.array_equal(_u32(jax.random.split(jk, 5)),
                          prng.split(tk, 5).numpy())
    # batched fold_in, as the engine folds request seeds into the root
    seeds = np.array([0, 5, 100, 2 ** 31 - 1], np.int32)
    want = jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(jk, (4, 2)), jnp.asarray(seeds))
    assert np.array_equal(_u32(want),
                          prng.fold_in(tk, torch.from_numpy(seeds)).numpy())


@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 11), (2, 4, 1024)])
def test_uniform_and_bernoulli_bit_equal(shape):
    jk, tk = jax.random.PRNGKey(42), prng.PRNGKey(42)
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          prng.uniform(tk, shape).numpy())
    tiny = float(np.finfo(np.float32).tiny)
    assert np.array_equal(
        np.asarray(jax.random.uniform(jk, shape, minval=tiny, maxval=1.0)),
        prng.uniform(tk, shape, tiny, 1.0).numpy())
    for p in (0.1, 0.5, 0.9):
        assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, shape)),
                              prng.bernoulli(tk, p, shape).numpy())


def test_dropout_mask_bit_equal():
    x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32)
    jk = jax.random.PRNGKey(9)
    want, _ = JDropout(0.3).forward({}, {}, jnp.asarray(x), training=True,
                                    rng=jk)
    d = Dropout(0.3).train()
    got = d(torch.from_numpy(x), prng.PRNGKey(9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="key"):
        d(torch.from_numpy(x))
    assert d.eval()(torch.from_numpy(x)) is not None


@pytest.mark.parametrize("temp,top_k,top_p", [(1.3, 5, 0.9), (0.7, 0, 1.0),
                                              (1.0, 3, 1.0), (2.0, 0, 0.5)])
def test_sampled_select_tokens_match_jax(temp, top_k, top_p):
    rs = np.random.RandomState(3)
    B, V = 6, 32
    logits = (rs.randn(B, V) * 2).astype(np.float32)
    seeds = rs.randint(0, 1000, B).astype(np.int32)
    positions = rs.randint(0, 64, B).astype(np.int32)
    temps = np.full(B, temp, np.float32)
    temps[0] = 0.0                       # a greedy row rides along
    top_ks = np.full(B, top_k, np.int32)
    top_ps = np.full(B, top_p, np.float32)
    base = jax.random.PRNGKey(0)
    jkeys = jax.vmap(jax.random.fold_in)(jnp.broadcast_to(base, (B, 2)),
                                         jnp.asarray(seeds))
    wt, wl = jde._select_tokens(jnp.asarray(logits), jkeys,
                                jnp.asarray(positions), jnp.asarray(temps),
                                jnp.asarray(top_ks), jnp.asarray(top_ps))
    tkeys = prng.fold_in(prng.PRNGKey(0), torch.from_numpy(seeds))
    gt, gl = _select_tokens(torch.from_numpy(logits), tkeys,
                            torch.from_numpy(positions).long(),
                            torch.from_numpy(temps), torch.from_numpy(top_ks),
                            torch.from_numpy(top_ps))
    assert gt.tolist() == np.asarray(wt).tolist()
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def lm():
    model = jattn.Transformer(vocab_size=32, hidden_size=16, num_heads=2,
                              num_layers=2, dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    return model, params


def _prompts(ns=(3, 5, 9, 2, 7, 11), seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(2, 32, (n,)).astype(np.int32) for n in ns]


def test_engine_seeded_sampling_matches_jax_engine(lm):
    """Sampled requests through the continuous engine give the JAX
    engine's tokens; the port's static reference agrees with both."""
    model, params = lm
    cfg = jde.DecodeConfig(**GEOMETRY)
    eng = jde.DecodeEngine(jde.LMAdapter(model, params, cap=cfg.cap), cfg)
    try:
        want = [eng.submit(jde.DecodeRequest(tokens=p, seed=100 + i,
                                             **SAMPLE_KW))
                for i, p in enumerate(_prompts())]
        want = [r.wait(timeout=120) for r in want]
    finally:
        eng.stop()
    im = InferenceModel(load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                                    dropout=0.0), params),
                        decode=DecodeConfig(**GEOMETRY), device="cpu")
    try:
        got = im.generate(_prompts(), seeds=[100 + i for i in range(6)],
                          return_results=True, **SAMPLE_KW)
        static = im.decode_engine.static_generate(
            [DecodeRequest(tokens=p, seed=100 + i, **SAMPLE_KW)
             for i, p in enumerate(_prompts())])
        greedy = im.generate(_prompts())
    finally:
        im.stop()
    for g, s, w in zip(got, static, want):
        assert g.tokens.tolist() == w.tokens.tolist()
        assert s.tokens.tolist() == w.tokens.tolist()
        assert abs(g.logp - w.logp) <= 1e-4
    # sampling really sampled: not every stream is the greedy one
    assert any(g.tolist() != w.tokens.tolist()
               for g, w in zip(greedy, want))


def test_dropout_training_matches_jax_driver(tmp_path):
    """The tiny LM at dropout 0.1 trained 3 steps by the JAX driver (one
    data replica, so its replica-0 keys cover the whole batch) and by the
    port's Optimizer from the same weights and seed: the same masks, so
    the same losses."""
    from bigdl_tpu.runtime.engine import Engine, init_engine

    lm_kw = dict(vocab_size=32, hidden_size=16, num_heads=2, num_layers=2,
                 dropout=0.1)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 32, (8, 12)).astype(np.int32)
    tgt = rs.randint(0, 32, (8, 12)).astype(np.int32)
    jm = jattn.Transformer(**lm_kw, mode="lm")
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(0), ids[:1]))
    Engine.reset()
    init_engine(data=1)
    try:
        jopt = JOptimizer(jm, JArrayDataSet(ids, tgt),
                          jcrit.CrossEntropyCriterion(), batch_size=4,
                          seed=5)
        jopt.set_optim_method(joptim.Adam(learning_rate=1e-2))
        jopt.set_end_when(JTrigger.max_iteration(3))
        jopt.set_initial_variables(init)
        jopt.set_train_summary(str(tmp_path))
        jopt.optimize()
        losses = [v for _, v in jopt._train_summary.read_scalar("loss")]
    finally:
        Engine.reset()
    opt = (Optimizer(Transformer(**lm_kw), DataSet.array(ids, tgt),
                     CrossEntropyCriterion(), batch_size=4, seed=5,
                     device="cpu")
           .set_optim_method(Adam(learning_rate=1e-2))
           .set_end_when(Trigger.max_iteration(3))
           .set_initial_variables(init))
    opt.optimize()
    assert len(losses) == 3
    np.testing.assert_allclose(opt.losses, losses, rtol=0, atol=1e-5)
    # and the masks matter: without dropout the losses differ
    opt0 = (Optimizer(Transformer(**dict(lm_kw, dropout=0.0)),
                      DataSet.array(ids, tgt), CrossEntropyCriterion(),
                      batch_size=4, seed=5, device="cpu")
            .set_optim_method(Adam(learning_rate=1e-2))
            .set_end_when(Trigger.max_iteration(3))
            .set_initial_variables(init))
    opt0.optimize()
    assert np.max(np.abs(np.asarray(opt0.losses) - losses)) > 1e-3
