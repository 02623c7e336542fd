"""The port's analytic cost model (``bigdl_tpu_torch.obs.cost``) against
``bigdl_tpu.obs.cost``, and the driver's FLOP and MFU gauges against the
JAX driver's.

The JAX walk is ``jax.eval_shape`` over the variables' shapes; the
port's a batch-of-the-sample forward of a CPU copy of the model.  For
every model both give the same per-layer records (name, kind, FLOPs,
parameter bytes, output elements, effective FLOPs; compared sorted,
since each lands in its own forward's order), equal exactly: the
formulas are the JAX package's, over the same shapes.  The walk runs no
kernel, moves no BatchNorm statistic and leaves the model as it was.
``peak_flops`` resolves in JAX's order, with the card's rows."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.obs import cost as jcost
from bigdl_tpu.runtime.engine import Engine as JEngine
from bigdl_tpu.runtime.engine import init_engine as jinit_engine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.obs import cost
from bigdl_tpu_torch.ops import common as ops_common
from bigdl_tpu_torch.runtime import engine as engine_mod


def _records(rep):
    """The records as a sorted list: a record lands when its module's
    forward returns, and the port's ``Bottleneck`` runs its projection
    before its body (JAX after), so only the order may differ."""
    return sorted((l.name, l.kind, l.flops, l.param_bytes, l.out_elems,
                   l.eff_flops) for l in rep.layers)


def _jax_report(model, x):
    """The JAX walk over the variables' shapes (no init runs)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    return jcost.forward_costs(model, shapes, x)


def _mlp(m):
    return m.Sequential([m.Linear(32, 64), m.ReLU(), m.Linear(64, 8),
                         m.LogSoftMax()])


def _transformer_stack(m):
    return m.Sequential([m.TransformerLayer(32, 4, 64, dropout=0.1,
                                           causal=True)
                         for _ in range(2)])


def _case(name):
    from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
    from bigdl_tpu.models.resnet import resnet50 as jresnet50
    from bigdl_tpu_torch.models import LeNet5, resnet50

    return {
        "mlp": (_mlp(jnn), _mlp(nn), np.zeros((16, 32), np.float32)),
        "lenet5": (JLeNet5(10), LeNet5(10), np.zeros((4, 28, 28, 1),
                                                     np.float32)),
        "resnet50": (jresnet50(classes=1000, stem="conv"),
                     resnet50(classes=1000, stem="conv"),
                     np.zeros((1, 224, 224, 3), np.float32)),
        "transformer": (_transformer_stack(jnn), _transformer_stack(nn),
                        np.zeros((2, 16, 32), np.float32)),
    }[name]


@pytest.mark.parametrize("name", ["mlp", "lenet5", "resnet50",
                                  "transformer"])
def test_forward_costs_records_equal_jax(name):
    jmodel, model, x = _case(name)
    jrep = _jax_report(jmodel, x)
    rep = cost.forward_costs(model, x)
    assert _records(rep) == _records(jrep)
    assert rep.batch == jrep.batch == x.shape[0]
    assert rep.flops == jrep.flops and rep.param_bytes == jrep.param_bytes
    if name == "resnet50":
        # the JAX test's bench convention: about 4.09 GMACs a forward
        assert rep.flops == pytest.approx(2 * 4.09e9, rel=0.05)


def test_block_sparse_model_dense_and_effective_equal_jax():
    from bigdl_tpu.ops.block_sparse import BlockSparseLinear as JBSL
    from bigdl_tpu_torch.ops.block_sparse import BlockSparseLinear

    rs = np.random.RandomState(0)
    mask1 = rs.rand(4, 8) < 0.5
    mask2 = rs.rand(8, 4) < 0.25
    jl1, jl2 = JBSL(64, 128, block_shape=(16, 16)), \
        JBSL(128, 64, block_shape=(16, 16))
    l1 = BlockSparseLinear(64, 128, block_shape=(16, 16))
    l2 = BlockSparseLinear(128, 64, block_shape=(16, 16))
    jmodel = jnn.Sequential([jl1, jnn.ReLU(), jl2])
    model = nn.Sequential([l1, nn.ReLU(), l2])
    x = np.zeros((8, 64), np.float32)
    jshapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    for a, b, m in ((jl1, l1, mask1), (jl2, l2, mask2)):
        a.set_mask(m)
        b.set_mask(m)
    jrep = jcost.forward_costs(jmodel, jshapes, x)
    rep = cost.forward_costs(model, x)
    assert _records(rep) == _records(jrep)
    assert rep.eff_flops < rep.flops
    got = cost.train_step_flops_detail(model, (x[:1],), 8)
    want = jcost.train_step_flops_detail(jmodel, jshapes, (x[:1],), 8)
    assert got == want


def test_the_walk_runs_no_kernel_and_leaves_the_model_alone():
    """No launch counted, no BatchNorm statistic moved, the model still
    in training mode and its forward hooks gone."""
    from bigdl_tpu_torch.models import resnet_cifar

    model = resnet_cifar(depth=8, classes=10)
    model.train(True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = dict(ops_common.LAUNCHES)
    rep = cost.forward_costs(model, np.ones((2, 32, 32, 3), np.float32))
    assert rep.flops > 0
    assert dict(ops_common.LAUNCHES) == launches
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(m._forward_hooks for m in model.modules())


def test_train_step_flops_scale_linearly_and_mfu():
    jmodel, model, x = _case("mlp")
    want = jcost.train_step_flops(jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))),
        (x[:1],), 160)
    assert cost.train_step_flops(model, (x[:1],), 160) == want
    assert want == pytest.approx(3 * 10 * (2 * 16 * (32 * 64 + 64 * 8)
                                           + 2 * 16 * 64 + 2 * 16 * 8))
    for args in ((1e9, 0.001, 2, 1e12), (1e9, 0.001, 1, None),
                 (1e9, 0.0, 1, 1e12), (5e12, 0.0615, 1, 989e12)):
        assert cost.mfu(*args) == jcost.mfu(*args)


def test_peak_flops_resolution(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_PEAK_FLOPS", raising=False)
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "cpu", None):
        assert cost.peak_flops(kind) == jcost.peak_flops(kind)
    assert cost.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert cost.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert cost.peak_flops(cost.device_name("cpu")) is None
    assert cost.peak_flops("cpu", override=1e12) == 1e12
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "5e11")
    assert cost.peak_flops("NVIDIA H100 80GB HBM3", override=1e12) \
        == jcost.peak_flops("TPU v4", override=1e12) == 5e11
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "fast")
    assert cost.peak_flops("cpu", override=2e12) == 2e12


def test_collective_ledger_of_one_process():
    from bigdl_tpu_torch.optim.train_step import TrainStep

    model = _mlp(nn)
    step = TrainStep(model, nn.ClassNLLCriterion(), optim.SGD(0.1))
    led = cost.collective_ledger(step)
    assert led["ici_bytes_per_step"] == led["dcn_bytes_per_step"] == 0.0
    assert led["n_params_padded"] == sum(p.numel()
                                         for p in model.parameters())
    assert led["grad_comm"] == "fp32" and led["grad_dtype_bytes"] == 4.0


def _jax_gauges(x, y, n_iter):
    JEngine.reset()
    jinit_engine(data=1)
    try:
        opt = joptim.Optimizer(_mlp(jnn), JArrayDataSet(x, y),
                               jnn.ClassNLLCriterion(), batch_size=16)
        opt.set_end_when(joptim.Trigger.max_iteration(n_iter))
        opt.optimize()
        return dict(opt.metrics.gauges)
    finally:
        JEngine.reset()


def test_driver_gauges_equal_the_jax_driver(monkeypatch):
    """``train.flops_per_step`` equals the JAX driver's on the same model
    and batch; with a pinned peak ``train.mfu`` is set and equals
    FLOPs / step time / peak."""
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "1e12")
    rs = np.random.RandomState(0)
    x = rs.randn(64, 32).astype(np.float32)
    y = rs.randint(0, 8, 64).astype(np.int64)
    jg = _jax_gauges(x, y, 4)
    engine_mod.Engine.reset()
    engine_mod.init_engine(engine_mod.EngineConfig(), device="cpu")
    try:
        opt = optim.Optimizer(_mlp(nn), DataSet.array(x, y),
                              nn.ClassNLLCriterion(), batch_size=16,
                              device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(4))
        opt.optimize()
    finally:
        engine_mod.Engine.reset()
    g = opt.metrics.gauges
    for k in ("train.flops_per_step", "train.effective_flops_per_step",
              "train.collective_ici_bytes_per_step",
              "train.grad_comm_buckets"):
        assert g[k] == jg[k], k
    assert opt.peak_device == "cpu"
    dt = opt.metrics.hists["train.step_time_s"]
    # windows 2 and 3 of 4: the first holds the set-up, the last the
    # run's final flush
    assert dt.n == 2
    assert 0 < g["train.mfu"] == g["train.effective_mfu"]
    assert g["train.achieved_flops_per_chip"] == pytest.approx(
        g["train.mfu"] * 1e12)
    # the gauge is over the last timed window, steps 2..3
    a, b, step_s = opt.timed_window
    assert (a, b) == (2, 3)
    assert g["train.mfu"] == pytest.approx(
        g["train.flops_per_step"] / step_s / 1e12)
    # the attribution: every step in a window, the components sum up
    rep = opt.attribution.report()
    assert rep["steps"] == 4 and rep["windows"] == 4
    assert sum(c["total_s"] for c in rep["components"].values()) \
        == pytest.approx(rep["wall_s"], rel=1e-9)


def test_unknown_device_gives_no_mfu_and_a_failed_walk_no_flops(
        monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_PEAK_FLOPS", raising=False)
    rs = np.random.RandomState(1)
    x = rs.randn(64, 32).astype(np.float32)
    y = rs.randint(0, 8, 64).astype(np.int64)

    def broken(*a, **k):
        raise RuntimeError("walk failed")

    engine_mod.Engine.reset()
    engine_mod.init_engine(engine_mod.EngineConfig(), device="cpu")
    try:
        opt = optim.Optimizer(_mlp(nn), DataSet.array(x, y),
                              nn.ClassNLLCriterion(), batch_size=16,
                              device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(4))
        opt.optimize()
        assert opt.metrics.gauges["train.flops_per_step"] > 0
        assert "train.mfu" not in opt.metrics.gauges
        monkeypatch.setattr(cost, "forward_costs", broken)
        engine_mod.init_engine(engine_mod.EngineConfig(peak_flops=1e12),
                               device="cpu")
        opt2 = optim.Optimizer(_mlp(nn), DataSet.array(x, y),
                               nn.ClassNLLCriterion(), batch_size=16,
                               device="cpu")
        opt2.set_end_when(optim.Trigger.max_iteration(4))
        trained = opt2.optimize()
    finally:
        engine_mod.Engine.reset()
    assert len(trained.losses) == 4
    assert "train.flops_per_step" not in opt2.metrics.gauges
    assert "train.mfu" not in opt2.metrics.gauges
