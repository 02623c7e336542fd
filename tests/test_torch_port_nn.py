"""Port nn layers (bigdl_tpu_torch.nn) against the JAX package on the
same weights: the JAX params tree is copied in with
``load_jax_params`` and both forwards run on the same numpy inputs.
JAX matmuls run at "highest" precision (tests/conftest.py), so the two
agree to float32 rounding (atol 1e-5)."""

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn import layers as jlayers
from bigdl_tpu_torch.nn import (Dropout, LayerNorm, Linear, PositionwiseFFN,
                                Transformer, TransformerLayer,
                                positional_encoding)
from bigdl_tpu_torch.utils import export_params, load_jax_params

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_linear():
    x = _x((3, 5, 16))
    jm = jlayers.Linear(16, 24)
    p = _np_tree(jm.init(jax.random.PRNGKey(1), x)["params"])
    tm = load_jax_params(Linear(16, 24), p)
    _close(tm(torch.from_numpy(x)), jm.forward(p, {}, x)[0])


def test_layernorm_eps_and_affine():
    x = _x((4, 7, 16)) * 3.0 + 1.5
    jm = jlayers.LayerNorm(16)
    rs = np.random.RandomState(3)
    p = {"weight": rs.randn(16).astype(np.float32),
         "bias": rs.randn(16).astype(np.float32)}
    tm = load_jax_params(LayerNorm(16), p)
    assert tm.eps == 1e-6
    _close(tm(torch.from_numpy(x)), jm.forward(p, {}, x)[0])


def test_positionwise_ffn():
    """GELU is the tanh approximation on both sides."""
    x = _x((2, 6, 16), seed=4)
    jm = jattn.PositionwiseFFN(16, 64)
    p = _np_tree(jm.init(jax.random.PRNGKey(2), x)["params"])
    tm = load_jax_params(PositionwiseFFN(16, 64), p)
    _close(tm(torch.from_numpy(x)), jm.forward(p, {}, x)[0])


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_layer(causal):
    x = _x((2, 9, 16), seed=5)
    jm = jattn.TransformerLayer(16, 2, dropout=0.0, causal=causal)
    p = _np_tree(jm.init(jax.random.PRNGKey(3), x)["params"])
    tm = load_jax_params(TransformerLayer(16, 2, dropout=0.0, causal=causal),
                         p)
    _close(tm(torch.from_numpy(x)), jm.forward(p, {}, x)[0])


@pytest.mark.parametrize("dim", [16, 7])
def test_positional_encoding(dim):
    """sin on even columns, cos on odd; odd dims give sin the extra
    column."""
    _close(positional_encoding(12, dim), jattn.positional_encoding(12, dim))


def _jax_lm(num_layers=2):
    jm = jattn.Transformer(vocab_size=32, hidden_size=16, num_heads=2,
                           num_layers=num_layers, dropout=0.0, mode="lm")
    v = jm.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    return jm, _np_tree(v["params"])


def test_transformer_lm_logits():
    jm, p = _jax_lm()
    tm = load_jax_params(Transformer(32, 16, 2, num_layers=2, dropout=0.0),
                         p)
    ids = np.random.RandomState(6).randint(0, 32, (3, 11)).astype(np.int32)
    want = np.asarray(jm.forward(p, {}, ids)[0])
    got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (3, 11, 32)
    _close(got, want)


def test_params_round_trip():
    _, p = _jax_lm()
    tm = load_jax_params(Transformer(32, 16, 2, num_layers=2, dropout=0.0),
                         p)
    back = export_params(tm)
    flat_p = jax.tree_util.tree_flatten_with_path(p)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_p) == len(flat_b)
    for path, val in flat_p:
        np.testing.assert_array_equal(flat_b[path], val)


def test_load_rejects_mismatched_tree():
    _, p = _jax_lm()
    tm = Transformer(32, 16, 2, num_layers=2, dropout=0.0)
    bad = dict(p, embedding=np.zeros((31, 16), np.float32))
    with pytest.raises(ValueError, match="embedding"):
        load_jax_params(tm, bad)
    with pytest.raises(KeyError, match="nope"):
        load_jax_params(tm, {"nope": np.zeros(3, np.float32)})


def test_seeded_init_is_reproducible():
    a = export_params(Transformer(32, 16, 2, num_layers=1, seed=7))
    b = export_params(Transformer(32, 16, 2, num_layers=1, seed=7))
    c = export_params(Transformer(32, 16, 2, num_layers=1, seed=8))
    np.testing.assert_array_equal(a["embedding"], b["embedding"])
    assert not np.array_equal(a["embedding"], c["embedding"])
    # zero biases, xavier-bounded weights, as the JAX init
    w = a["dec0"]["attn"]["wq"]
    assert np.abs(w).max() <= np.sqrt(6.0 / 32) and w.std() > 0
    assert not a["dec0"]["attn"]["bq"].any()


def test_dropout_identity_at_inference():
    x = torch.randn(4, 8)
    d = Dropout(0.5).eval()
    assert torch.equal(d(x), x)
    assert not Transformer(32, 16, 2, num_layers=1).training


def test_translation_mode_refused():
    with pytest.raises(ValueError, match="only 'lm'"):
        Transformer(32, 16, 2, mode="translation")
