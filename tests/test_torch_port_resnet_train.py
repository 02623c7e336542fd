"""A CIFAR ResNet trained by the port's Optimizer against the JAX Optimizer:
``resnet_cifar(depth=8)`` on 16x16 inputs, batch 8, 6 iterations, the
recipe of ``examples/resnet_cifar10.py`` at its own learning rate (SGD
0.1, Nesterov momentum 0.9, weight decay 5e-4, a 2-step warmup of 0.05 a
step, then MultiStep([4], 0.1)), from the same JAX-initialised
variables.  The JAX Optimizer runs on one data replica
(``init_engine(data=1)``): on its 8-device mesh each device would take
BatchNorm statistics over its own shard of the batch.

Tolerances: the first step's loss within 1e-5 absolute, the later ones
within 1e-4 (float32 sums in another order, carried through the
momentum); BatchNorm running statistics and the final parameters within
1e-4."""

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.models.resnet import resnet_cifar as jresnet_cifar
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.models import resnet_cifar

N, HW, BATCH, STEPS = 48, 16, 8, 6


def _data():
    rs = np.random.RandomState(0)
    x = rs.randn(N, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, 10, N).astype(np.int32)
    return x, y


def _recipe(m):
    schedule = (m.SequentialSchedule().add(m.Warmup(0.1 / 2), 2)
                .add(m.MultiStep([4], 0.1), 10 ** 9))
    return m.SGD(learning_rate=0.1, momentum=0.9, weight_decay=5e-4,
                 nesterov=True, learning_rate_schedule=schedule)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    x, y = _data()
    jm = jresnet_cifar(depth=8, classes=10)
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(0), x[:1]))
    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(jm, JArrayDataSet(x, y),
                               jnn.CrossEntropyCriterion(),
                               batch_size=BATCH, seed=1)
        opt.set_optim_method(_recipe(joptim))
        opt.set_end_when(joptim.Trigger.max_iteration(STEPS))
        opt.set_initial_variables(init)
        opt.set_train_summary(str(tmp_path_factory.mktemp("summary")))
        trained = opt.optimize()
        losses = [v for _, v in opt._train_summary.read_scalar("loss")]
        variables = jax.tree_util.tree_map(np.asarray, trained.variables)
    finally:
        Engine.reset()
    return init, losses, variables


def _port(init):
    x, y = _data()
    opt = optim.Optimizer(resnet_cifar(depth=8, classes=10),
                          DataSet.array(x, y), nn.CrossEntropyCriterion(),
                          batch_size=BATCH, seed=1, device="cpu")
    opt.set_optim_method(_recipe(optim))
    opt.set_end_when(optim.Trigger.max_iteration(STEPS))
    opt.set_initial_variables(init)
    trained = opt.optimize()
    return opt.losses, trained.variables


def test_resnet_cifar_trajectory_matches_jax(jax_run):
    init, want, jv = jax_run
    losses, tv = _port(init)
    assert len(want) == len(losses) == STEPS
    np.testing.assert_allclose(losses[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(losses[1:], want[1:], rtol=0, atol=1e-4)
    for part in ("state", "params"):
        assert (jax.tree_util.tree_structure(tv[part])
                == jax.tree_util.tree_structure(jv[part]))
        for a, b in zip(_leaves(tv[part]), _leaves(jv[part])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    # the run moved the statistics: not a comparison of initial values
    assert max(float(np.abs(a).max()) for a in _leaves(tv["state"])
               if a.ndim) > 1e-3
