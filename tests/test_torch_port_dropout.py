"""Dropout keys through the port's containers against the JAX package.

The JAX ``Sequential``, ``Concat``, ``ConcatTable`` and ``ParallelTable``
hand child ``i`` ``fold_in(rng, i)``, and the JAX keras ``Model`` hands
node ``i`` of its topological order the same.  The port's containers and
keras ``Model.forward`` take an optional ``key`` and fold it the same
way, so on the same numpy inputs, weights and threefry key the
training-mode outputs drop the same elements: equal within 1e-6 (the
masks are bit-equal; only float32 products of the Linear layers differ
in order).  A few SGD steps of a small MLP with dropout through each
package's ``Optimizer`` reach the same losses within 1e-5.  Without a
key, an active Dropout in training still raises."""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import keras as JK
from bigdl_tpu import nn as jnn
from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.optim import optim_method as joptim
from bigdl_tpu.optim.optimizer import Optimizer as JOptimizer
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import (load_jax_keras_variables, load_jax_params,
                                   prng)

ATOL = 1e-6
SEED = 7


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# each container holds Dropouts at two or more child indices, so a wrong
# fold index gives another mask
CONTAINERS = {
    "sequential": (lambda m: m.Sequential([
        m.Linear(6, 8), m.Dropout(0.3), m.ReLU(), m.Linear(8, 5),
        m.Dropout(0.5)]), 1),
    "concat": (lambda m: m.Concat([
        m.Dropout(0.3), m.Sequential([m.Linear(6, 4), m.Dropout(0.4)]),
        m.Dropout(0.3)]), 1),
    "concat_table": (lambda m: m.ConcatTable([
        m.Dropout(0.5), m.Identity(), m.Dropout(0.5)]), 1),
    "parallel_table": (lambda m: m.ParallelTable([
        m.Dropout(0.3), m.Sequential([m.Dropout(0.6), m.Linear(6, 3)])]),
        2),
}


def _container_pair(kind):
    build, n_in = CONTAINERS[kind]
    xs = [_x((4, 6), SEED + i) for i in range(n_in)]
    jm = build(jnn)
    init_in = (tuple(xs),) if n_in > 1 else tuple(xs)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jm.init(jax.random.PRNGKey(0), *init_in))
    tm = build(nn)
    load_jax_params(tm, v["params"])
    return jm, v, tm, init_in


def _as_list(y):
    return list(y) if isinstance(y, (tuple, list)) else [y]


@pytest.mark.parametrize("kind", sorted(CONTAINERS))
def test_container_drops_what_jax_drops(kind):
    jm, v, tm, xs = _container_pair(kind)
    want, _ = jm.apply(v, *xs, training=True,
                       rng=jax.random.PRNGKey(SEED))
    targs = tuple(tuple(torch.from_numpy(a) for a in x)
                  if isinstance(x, tuple) else torch.from_numpy(x)
                  for x in xs)
    got = tm.train()(*targs, key=prng.PRNGKey(SEED))
    want, got = _as_list(want), _as_list(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=ATOL)
        # the dropped elements are the same ones
        np.testing.assert_array_equal(g.detach().numpy() == 0,
                                      np.asarray(w) == 0)
    # and something was dropped
    assert any((g == 0).any() for g in got)


def _keras_mlp(K, nn):
    inp = K.Input((6,))
    h = K.Dropout(0.3)(nn.ReLU()(K.Dense(6, 8)(inp)))
    side = K.Dropout(0.5)(inp)
    out = K.Dense(8, 4)(h)
    return K.Model(inp, [out, side])


def test_keras_model_drops_what_jax_drops():
    x = _x((5, 6), SEED)
    jm = _keras_mlp(JK, jnn)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jm.init(jax.random.PRNGKey(0), x))
    tm = load_jax_keras_variables(_keras_mlp(K, nn), jm, v)
    want, _ = jm.apply(v, x, training=True, rng=jax.random.PRNGKey(SEED))
    got = tm.train()(torch.from_numpy(x), key=prng.PRNGKey(SEED))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=ATOL)
        np.testing.assert_array_equal(g.detach().numpy() == 0,
                                      np.asarray(w) == 0)
    # the two Dropout nodes drew different masks
    assert (got[1] == 0).any()


@pytest.mark.parametrize("kind", sorted(CONTAINERS) + ["keras_model"])
def test_no_key_in_training_still_raises(kind):
    if kind == "keras_model":
        tm, xs = _keras_mlp(K, nn), (torch.from_numpy(_x((5, 6), SEED)),)
    else:
        _, _, tm, init_in = _container_pair(kind)
        xs = tuple(tuple(torch.from_numpy(a) for a in x)
                   if isinstance(x, tuple) else torch.from_numpy(x)
                   for x in init_in)
    with pytest.raises(ValueError, match="requires a key"):
        tm.train()(*xs)
    # eval needs no key, and a key changes nothing there
    tm.eval()
    for a, b in zip(_as_list(tm(*xs)),
                    _as_list(tm(*xs, key=prng.PRNGKey(SEED)))):
        assert torch.equal(a, b)


def _mlp(m):
    return m.Sequential([m.Linear(6, 16), m.ReLU(), m.Dropout(0.3),
                         m.Linear(16, 16), m.Tanh(), m.Dropout(0.2),
                         m.Linear(16, 3)])


def test_mlp_with_dropout_trains_to_jax_losses(tmp_path):
    """Four SGD steps of the MLP by the JAX driver (one data replica, so
    its replica-0 keys cover the batch) and by the port's Optimizer from
    the same weights and seed: the same masks, so the same losses."""
    from bigdl_tpu.nn import criterion as jcrit
    from bigdl_tpu.runtime.engine import Engine, init_engine

    rs = np.random.RandomState(3)
    x = rs.randn(32, 6).astype(np.float32)
    y = rs.randint(0, 3, 32).astype(np.int32)
    jm = _mlp(jnn)
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(0), x[:1]))
    Engine.reset()
    init_engine(data=1)
    try:
        jopt = JOptimizer(jm, JArrayDataSet(x, y),
                          jcrit.CrossEntropyCriterion(), batch_size=8,
                          seed=5)
        jopt.set_optim_method(joptim.SGD(learning_rate=0.1))
        jopt.set_end_when(JTrigger.max_iteration(4))
        jopt.set_initial_variables(init)
        jopt.set_train_summary(str(tmp_path))
        jopt.optimize()
        losses = [v for _, v in jopt._train_summary.read_scalar("loss")]
    finally:
        Engine.reset()

    def port(model):
        opt = (Optimizer(model, DataSet.array(x, y),
                         nn.CrossEntropyCriterion(), batch_size=8, seed=5,
                         device="cpu")
               .set_optim_method(SGD(learning_rate=0.1))
               .set_end_when(Trigger.max_iteration(4))
               .set_initial_variables(init))
        opt.optimize()
        return opt.losses

    got = port(_mlp(nn))
    assert len(losses) == 4
    np.testing.assert_allclose(got, losses, rtol=0, atol=1e-5)
    # the masks matter: the same MLP without dropout trains elsewhere
    plain = nn.Sequential([nn.Linear(6, 16), nn.ReLU(), nn.Identity(),
                           nn.Linear(16, 16), nn.Tanh(), nn.Identity(),
                           nn.Linear(16, 3)])
    assert np.max(np.abs(np.asarray(port(plain)) - losses)) > 1e-3
