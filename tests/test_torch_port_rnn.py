"""The port's recurrent layers against the JAX package: ``nn/rnn.py``'s
cells (forward and gradients with masks, backwards in time, final
states, one decode step), ``BiRecurrent``, ``TimeDistributed``,
``RecurrentDecoder``, ``Recurrent`` and ``MultiRNNCell``; ``Maxout`` and
the keras ``MaxoutDense`` and ``Bidirectional``; and three training steps
of ``char_rnn`` and ``Seq2Seq`` through each package's ``Optimizer``.

Both packages run the same numpy inputs on the same weights (the JAX
variables, perturbed from a numpy seed so no peephole or bias is zero,
copied by ``utils.convert``).  Tolerance 1e-5 of the largest |value|
(float32 sums in another order; JAX matmuls at "highest" precision,
tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import keras as JK
from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data import ArrayDataSet as JArrayDataSet
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch import models, nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.utils import export_params, load_jax_params
from bigdl_tpu_torch.utils.convert import jax_path

TOL = 1e-5
CELLS = ["SimpleRNN", "LSTM", "LSTMPeephole", "GRU"]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _perturbed(params, seed, scale=0.2):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rs.randn(*np.shape(a))).astype(
            np.float32), params)


def _mask(b, t, seed):
    m = (np.random.RandomState(seed).rand(b, t) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


def _pair(make, *xs, seed=0):
    """(JAX module, its perturbed params, the port module loaded with
    them)."""
    jm = make(jnn)
    p = _perturbed(jm.init(jax.random.PRNGKey(seed), *xs)["params"], seed + 1)
    return jm, p, load_jax_params(make(nn), p)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _check_grads(jm, p, tm, xs, jkw=None, tkw=None, tol=TOL):
    """Forward, and the gradients of sum(sin(y)) for every parameter and
    every float input."""
    jkw, tkw = jkw or {}, tkw or {}

    def jf(params, *a):
        y, _ = jm.forward(params, {}, *a, **jkw)
        return jnp.sum(jnp.sin(y)), y

    (_, want), (gp, *gx) = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(xs) + 1)), has_aux=True))(p, *xs)
    ts = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in xs]
    y = tm(*ts, **tkw)
    torch.sin(y).sum().backward()
    _close(y, want, tol)
    by_path = {jax_path(n): t for n, t in tm.named_parameters()}
    for path, g in _leaves(gp):
        _close(by_path[path].grad, g, tol)
    for t, g in zip(ts, gx):
        if t.requires_grad:
            _close(t.grad, g, tol)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("variant", ["plain", "mask", "backwards",
                                     "final", "backwards_mask_final"])
def test_cell_forward_and_gradients_match_jax(cell, variant):
    x = _x((3, 5, 4), 1)
    back = "backwards" in variant
    seqs = "final" not in variant

    def make(m):
        return getattr(m, cell)(4, 6, return_sequences=seqs,
                                go_backwards=back)

    jm, p, tm = _pair(make, x)
    if "mask" in variant:
        mask = _mask(3, 5, 2)
        _check_grads(jm, p, tm, (x,), jkw={"mask": jnp.asarray(mask)},
                     tkw={"mask": torch.from_numpy(mask)})
    else:
        _check_grads(jm, p, tm, (x,))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_step_and_initial_state_match_jax(cell):
    """``step`` from ``init_carry`` twice equals the JAX ``step``; a
    forward from an ``initial_state`` too."""
    x = _x((2, 3, 4), 3)
    jm, p, tm = _pair(lambda m: getattr(m, cell)(4, 5), x)
    jc = jm.init_carry(2)
    tc = tm.init_carry(2)
    for t in range(2):
        jc, jh = jm.step(p, jc, jnp.asarray(x[:, t]))
        tc, th = tm.step(tc, torch.from_numpy(x[:, t]))
        _close(th, jh)
    _close(tm(torch.from_numpy(x), initial_state=tc),
           jm.forward(p, {}, x, initial_state=jc)[0])


@pytest.mark.parametrize("merge", ["concat", "sum"])
def test_birecurrent_matches_jax(merge):
    x = _x((2, 4, 3), 4)
    mask = _mask(2, 4, 5)
    jm, p, tm = _pair(lambda m: m.BiRecurrent(m.GRU(3, 5), merge=merge), x)
    assert tm.bwd.go_backwards and not tm.fwd.go_backwards
    _check_grads(jm, p, tm, (x,), jkw={"mask": jnp.asarray(mask)},
                 tkw={"mask": torch.from_numpy(mask)})


def test_keras_bidirectional_maxout_dense_and_maxout_match_jax():
    x = _x((2, 4, 3), 6)
    jm, p, tm = _pair(lambda m: (JK if m is jnn else K).Bidirectional(
        m.LSTM(3, 4), merge_mode="sum"), x)
    _check_grads(jm, p, tm, (x,))
    jm, p, tm = _pair(lambda m: (JK if m is jnn else K).MaxoutDense(
        3, 5, nb_feature=3), x)
    _check_grads(jm, p, tm, (x,))
    jm, p, tm = _pair(lambda m: m.Maxout(3, 4, pool_size=2), x[:, 0])
    _check_grads(jm, p, tm, (x[:, 0],))


def test_time_distributed_recurrent_and_multi_rnn_cell_match_jax():
    x = _x((2, 5, 3), 7)
    jm, p, tm = _pair(lambda m: m.TimeDistributed(m.Linear(3, 4)), x)
    assert set(p) == {"weight", "bias"}
    assert sorted(export_params(tm)) == ["bias", "weight"]
    _check_grads(jm, p, tm, (x,))
    jm, p, tm = _pair(lambda m: m.Recurrent().add(m.LSTM(3, 4)), x)
    assert set(p) == {"w_in", "w_rec", "bias"}
    _check_grads(jm, p, tm, (x,))
    jm, p, tm = _pair(lambda m: m.MultiRNNCell([m.GRU(3, 4),
                                                m.LSTM(4, 4)]), x)
    assert set(p) == {"cell0", "cell1"}
    mask = _mask(2, 5, 8)
    _check_grads(jm, p, tm, (x,), jkw={"mask": jnp.asarray(mask)},
                 tkw={"mask": torch.from_numpy(mask)})
    jc, tc = jm.init_carry(2), tm.init_carry(2)
    for t in range(3):
        jc, jh = jm.step(p, jc, jnp.asarray(x[:, t]))
        tc, th = tm.step(tc, torch.from_numpy(x[:, t]))
        _close(th, jh)
    with pytest.raises(RuntimeError, match="add"):
        nn.Recurrent()(torch.from_numpy(x))


@pytest.mark.parametrize("head", [False, True])
def test_recurrent_decoder_matches_jax(head):
    x = _x((3, 4), 9)

    def make(m):
        return m.RecurrentDecoder(
            m.LSTM(4, 4), seq_length=5,
            output_layer=m.Linear(4, 4) if head else None)

    jm, p, tm = _pair(make, x)
    assert set(p) == ({"cell", "out"} if head else {"cell"})
    _check_grads(jm, p, tm, (x,))


def test_lazy_width_and_birecurrent_copy():
    x = torch.from_numpy(_x((2, 3, 4), 10))
    lazy = nn.LSTM(None, 5)
    assert lazy(x).shape == (2, 3, 5) and lazy.w_in.shape == (4, 20)
    fwd = nn.LSTM(4, 5, generator=torch.Generator().manual_seed(0))
    bi = nn.BiRecurrent(fwd)
    assert not torch.equal(bi.fwd.w_in, bi.bwd.w_in)   # fresh weights
    assert bi(x).shape == (2, 3, 10)
    np.testing.assert_array_equal(
        nn.LSTM(4, 5).bias.detach().numpy()[5:10], np.ones(5))


# ---------------------------------------------------------------------------
# three training steps of the zoo's sequence models
# ---------------------------------------------------------------------------


def _jax_losses(jm, x, y, crit, method, init, n_iter, tmp_path):
    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(jm, JArrayDataSet(x, y), crit, batch_size=8,
                               seed=3)
        opt.set_optim_method(method)
        opt.set_end_when(joptim.Trigger.max_iteration(n_iter))
        opt.set_initial_variables(init)
        opt.set_train_summary(str(tmp_path))
        opt.optimize()
        return [v for _, v in opt._train_summary.read_scalar("loss")]
    finally:
        Engine.reset()


def _port_losses(tm, x, y, crit, method, n_iter):
    opt = optim.Optimizer(tm, DataSet.array(x, y), crit, batch_size=8,
                          seed=3, device="cpu")
    opt.set_optim_method(method).set_end_when(
        optim.Trigger.max_iteration(n_iter))
    opt.optimize()
    return opt.losses


def test_char_rnn_trains_to_jax_losses(tmp_path):
    rs = np.random.RandomState(11)
    ids = rs.randint(0, 20, (24, 7)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    jm = jmodels.char_rnn(20, 8, 12, layers=2)
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(0), x[:1]))
    want = _jax_losses(jm, x, y, jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion()), joptim.SGD(learning_rate=0.5), init, 3,
        tmp_path)
    tm = load_jax_params(models.char_rnn(20, 8, 12, layers=2),
                         init["params"])
    got = _port_losses(tm, x, y, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion()), optim.SGD(learning_rate=0.5), 3)
    assert len(want) == 3
    _close(got, want)


def test_seq2seq_trains_to_jax_losses(tmp_path):
    x = _x((24, 6, 5), 12)
    y = _x((24, 4, 5), 13)
    jm = jmodels.Seq2Seq(5, 7, output_len=4)
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(1), x[:1]))
    assert set(init["params"]) == {"enc", "dec", "head"}
    want = _jax_losses(jm, x, y, jnn.MSECriterion(),
                       joptim.Adam(learning_rate=1e-2), init, 3, tmp_path)
    tm = load_jax_params(models.Seq2Seq(5, 7, output_len=4), init["params"])
    got = _port_losses(tm, x, y, nn.MSECriterion(),
                       optim.Adam(learning_rate=1e-2), 3)
    assert len(want) == 3
    _close(got, want)


def test_gru_recurrent_bias_matches_jax():
    """The JAX GRU's optional ``bias_rec`` (set by its stock-keras
    importer) as the port's ``GRU(recurrent_bias=True)``."""
    x = _x((2, 4, 3), 14)
    jm = jnn.GRU(3, 5)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 15)
    p["bias_rec"] = np.random.RandomState(16).randn(15).astype(np.float32)
    tm = load_jax_params(nn.GRU(3, 5, recurrent_bias=True), p)
    _check_grads(jm, p, tm, (x,))
    with pytest.raises(KeyError, match="bias_rec"):
        load_jax_params(nn.GRU(3, 5), p)
