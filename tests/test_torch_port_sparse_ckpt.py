"""Block-sparse masks through the checkpoint (ROADMAP C.20): a pruned
model's checkpoint, written gathered or sharded, resumed into a fresh
model whose masks are all ones, keeps the checkpoint's masks and trains
on them, as the JAX driver does (``bigdl_tpu/optim/optimizer.py``
``block_sparse_masks``).  Held against the JAX Optimizer on one data
replica: the restored masks equal JAX's, the losses after the resume
within 1e-5."""

import numpy as np
import pytest

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.obs import flight as jflight
from bigdl_tpu.ops import block_sparse as jbs
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.obs import flight
from bigdl_tpu_torch.ops import block_sparse as bs

from test_torch_port_driver import synthetic_classification

CPU = "cpu"
BLOCK = (8, 8)


def _jax_model():
    return jnn.Sequential([
        jbs.BlockSparseLinear(16, 64, block_shape=BLOCK, use_kernel=False),
        jnn.ReLU(),
        jbs.BlockSparseLinear(64, 8, block_shape=BLOCK, use_kernel=False),
        jnn.LogSoftMax()])


def _port_model():
    return nn.Sequential([bs.BlockSparseLinear(16, 64, block_shape=BLOCK),
                          nn.ReLU(),
                          bs.BlockSparseLinear(64, 8, block_shape=BLOCK),
                          nn.LogSoftMax()])


def _masks(model, it):
    return [np.asarray(m.mask, bool) for _, m in it(model)]


def _jax_run(model, x, y, n_iter, init, ckpt_dir, summary):
    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(model, JArrayDataSet(x, y),
                               jnn.ClassNLLCriterion(), batch_size=64,
                               seed=3)
        opt.set_optim_method(joptim.Adam(learning_rate=1e-2))
        opt.set_end_when(joptim.Trigger.max_iteration(n_iter))
        opt.set_initial_variables(init)
        opt.set_checkpoint(ckpt_dir, joptim.Trigger.several_iteration(4))
        opt.set_train_summary(summary)
        opt.optimize()
        return [v for _, v in opt._train_summary.read_scalar("loss")]
    finally:
        Engine.reset()


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """JAX: prune at init, train 4 steps with a checkpoint, then resume
    a fresh (all-ones) model to step 8."""
    d = tmp_path_factory.mktemp("jax_sparse")
    x, y = synthetic_classification(n=384)
    jm = _jax_model()
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(0), x[:1]))
    jbs.prune_model_to_sparsity(jm, init, 0.5)
    pruned = _masks(jm, jbs.iter_sparse_modules)
    ck = str(d / "ck")
    first = _jax_run(jm, x, y, 4, init, ck, str(d / "s1"))
    fresh = _jax_model()
    fresh.init(jax.random.PRNGKey(0), x[:1])
    assert all(m.all() for m in _masks(fresh, jbs.iter_sparse_modules))
    jflight.global_recorder().clear()
    rest = _jax_run(fresh, x, y, 8, init, ck, str(d / "s2"))
    events = [e for e in jflight.global_recorder().snapshot()
              if e["kind"] == "block_sparse_masks_restored"]
    return dict(x=x, y=y, init=init, pruned=pruned, first=first,
                rest=rest[-4:],
                restored=_masks(fresh, jbs.iter_sparse_modules),
                events=events)


def _port_opt(model, x, y, n_iter, init, ckpt_dir, sharded):
    opt = optim.Optimizer(model, DataSet.array(x, y), nn.ClassNLLCriterion(),
                          batch_size=64, seed=3, device=CPU)
    opt.set_optim_method(optim.Adam(learning_rate=1e-2)).set_end_when(
        optim.Trigger.max_iteration(n_iter)).set_initial_variables(init)
    opt.set_checkpoint(ckpt_dir, optim.Trigger.several_iteration(4),
                       sharded=sharded)
    return opt


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["gathered", "sharded"])
def test_pruned_checkpoint_resumes_its_masks_as_jax(jax_resume, tmp_path,
                                                    sharded):
    j = jax_resume
    x, y, init = j["x"], j["y"], j["init"]
    model = _port_model()
    for (_, mod), m in zip(bs.iter_sparse_modules(model), j["pruned"]):
        mod.set_mask(m)
    ck = str(tmp_path / "ck")
    opt = _port_opt(model, x, y, 4, init, ck, sharded)
    opt.optimize()
    np.testing.assert_allclose(opt.losses, j["first"], rtol=0, atol=1e-5)

    fresh = _port_model()
    assert all(m.all() for m in _masks(fresh, bs.iter_sparse_modules))
    flight.global_recorder().clear()
    opt = _port_opt(fresh, x, y, 8, init, ck, sharded)
    opt.optimize()
    restored = _masks(fresh, bs.iter_sparse_modules)
    assert len(restored) == len(j["restored"]) == 2
    for got, want, pruned in zip(restored, j["restored"], j["pruned"]):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pruned)
    assert not all(m.all() for m in restored)
    np.testing.assert_allclose(opt.losses, j["rest"], rtol=0, atol=1e-5)
    events = [e for e in flight.global_recorder().snapshot()
              if e["kind"] == "block_sparse_masks_restored"]
    assert [e["modules"] for e in events] == \
        [e["modules"] for e in j["events"]] == [2]
