"""Training on the port's ``seq`` axis against the JAX package:
``ShardedParameterStep(seq_parallel=True)`` on ``MeshSpec(data=2,
seq=2)`` against the JAX step on the same mesh (ring and Ulysses, with
FFN and residual dropout), validation on the sequence blocks, the
driver's ``seq_parallel`` against flat data parallelism, keras
``fit(seq_parallel=True)``; and the overlap audit across 2 ranks.

Ranks are gloo processes (``test_torch_port_collectives.RankPool``);
rank ``r = data_index * seq + seq_index`` holds JAX device ``r``'s block.
JAX runs in the test process only.  Tolerances: losses 1e-5; the
audit's training bit-equal."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.runtime import mesh as mesh_mod
from test_torch_port_collectives import pools  # noqa: F401 (fixture)

SEED = 5


# ---------------------------------------------------------------------------
# training on MeshSpec(data=2, seq=2) against the JAX step on that mesh
# ---------------------------------------------------------------------------

def _seq_model(m, strategy):
    return m.Sequential([
        m.Linear(12, 16),
        m.TransformerLayer(16, 4, dropout=0.1, causal=True,
                           seq_parallel=strategy),
        m.Linear(16, 12)])


def _seq_data():
    rs = np.random.RandomState(0)
    x = rs.randn(8, 32, 12).astype(np.float32)
    return x, np.roll(x, 1, axis=1).astype(np.float32)


def _jax_seq_steps(strategy, variables, x, y, steps):
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.optim.train_step import ShardedParameterStep
    from bigdl_tpu.runtime.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(data=2, seq=2), devices=jax.devices()[:4])
    st = ShardedParameterStep(_seq_model(jnn, strategy), jnn.MSECriterion(),
                              joptim.Adam(learning_rate=1e-2), mesh,
                              variables, seq_parallel=True)
    st.set_step_seed(SEED + 1)
    xd, yd = st.shard_batch(x), st.shard_batch(y)
    lv, _ = st.train_bundle_device(0, [xd] * steps, [yd] * steps)
    return np.asarray(lv)


def _port_seq_steps(rank, world, strategy, variables, x, y, steps):
    from bigdl_tpu_torch.data.dataset import ArrayDataSet
    from bigdl_tpu_torch.optim.train_step import (ShardedParameterStep,
                                                  evaluate)
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(data=2, seq=2))
    assert (mesh.replica_index, mesh.seq_index) == divmod(rank, 2)
    model = load_jax_variables(_seq_model(nn, strategy), variables)
    st = ShardedParameterStep(model, nn.MSECriterion(),
                              optim.Adam(learning_rate=1e-2), mesh,
                              seed=SEED, seq_parallel=True)
    b = len(x) // 2
    rows = slice(mesh.replica_index * b, (mesh.replica_index + 1) * b)
    xs, ys = torch.as_tensor(x[rows]), torch.as_tensor(y[rows])
    lv, _ = st.train_bundle(0, [xs] * steps, [ys] * steps)
    # validation on the sequence blocks against the whole sequences
    ds = ArrayDataSet(x, y)
    plan = dict(shuffle=False, drop_last=False,
                process_id=mesh.replica_index, process_count=2)
    loss = optim.Loss(nn.MSECriterion())
    blocks = evaluate(model, [loss], ds.batches(4, **plan),
                      torch.device("cpu"), group=mesh.group, seq=st.seq)
    whole = evaluate(model, [loss], ds.batches(8, shuffle=False,
                                               drop_last=False),
                     torch.device("cpu"))
    return lv.numpy(), blocks[0].result, whole[0].result


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_seq_parallel_step_matches_jax(pools, strategy):
    import jax
    from bigdl_tpu import nn as jnn

    x, y = _seq_data()
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        _seq_model(jnn, strategy).init(jax.random.PRNGKey(0), x[:1]))
    want = _jax_seq_steps(strategy, variables, x, y, 3)
    got = pools(4).run(_port_seq_steps, strategy, variables, x, y, 3)
    for r, (losses, blocks, whole) in enumerate(got):
        np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert blocks == pytest.approx(whole, rel=1e-5)


def _port_fit(rank, world, strategy, x, y):
    from bigdl_tpu_torch.data.dataset import ArrayDataSet
    from bigdl_tpu_torch.runtime import EngineConfig, init_engine

    out = {}
    for label, spec, sp in (("flat", mesh_mod.MeshSpec(), None),
                            ("seq", mesh_mod.MeshSpec(data=2, seq=2),
                             strategy)):
        init_engine(EngineConfig(mesh=spec), device="cpu")
        model = nn.Sequential([
            nn.Linear(12, 16, generator=torch.Generator().manual_seed(1)),
            nn.TransformerLayer(16, 4, dropout=0.0, causal=True,
                                seq_parallel=sp,
                                generator=torch.Generator().manual_seed(2)),
            nn.Linear(16, 12, generator=torch.Generator().manual_seed(3))])
        opt = optim.Optimizer(model, ArrayDataSet(x, y), nn.MSECriterion(),
                              batch_size=8, seed=SEED, device="cpu")
        opt.set_optim_method(optim.SGD(learning_rate=0.05))
        opt.set_end_when(optim.Trigger.max_iteration(4))
        opt.seq_parallel = sp is not None
        trained = opt.optimize()
        out[label] = trained.losses
        if sp is not None:
            out["flops"] = opt.metrics.gauges["train.flops_per_step"]
            out["pred"] = trained.predict(x[:4]).shape
    init_engine(EngineConfig(), device="cpu")
    return out


def test_driver_seq_parallel_matches_flat_data_parallel(pools):
    """The driver with ``seq_parallel`` over (data=2, seq=2) trains the
    losses of flat data parallelism over 4 ranks of the same model
    (JAX's TestSeqParallelTraining, dropout 0); predict outside the step
    sees the whole sequence."""
    x, y = _seq_data()
    x = np.concatenate([x, x[::-1]])
    y = np.concatenate([y, y[::-1]])
    got = pools(4).run(_port_fit, "ring", x, y)
    for r in got:
        np.testing.assert_allclose(r["seq"], r["flat"], rtol=1e-5)
        assert r["pred"] == (4, 32, 12)
    assert len({r["flops"] for r in got}) == 1


def _keras_fit(rank, world):
    from bigdl_tpu_torch.keras.engine import Input, Model
    from bigdl_tpu_torch.runtime import EngineConfig, init_engine

    init_engine(EngineConfig(mesh=mesh_mod.MeshSpec(data=2, seq=2)),
                device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(16, 16, 8).astype(np.float32)
    y = np.roll(x, 1, axis=1).astype(np.float32)
    inp = Input((16, 8))
    h = nn.TransformerLayer(8, 4, dropout=0.0, causal=True,
                            seq_parallel="ulysses")(inp)
    model = Model(inp, nn.Linear(8, 8)(h))
    model.compile("adam", "mse")
    trained = model.fit(x, y, batch_size=8, epochs=2, log_every=100,
                        seq_parallel=True, device="cpu")
    init_engine(EngineConfig(), device="cpu")
    return trained.losses, trained.predict(x[:8]).shape


def test_keras_fit_seq_parallel(pools):
    """keras ``fit(seq_parallel=True)`` over the engine's (data=2, seq=2)
    mesh (JAX's test_keras_fit_seq_parallel, smaller): every rank the
    same losses, predict on the whole sequence."""
    got = pools(4).run(_keras_fit)
    losses = [np.asarray(l) for l, _ in got]
    assert len(losses[0]) == 4 and np.all(np.isfinite(losses[0]))
    for l, shape in got:
        np.testing.assert_array_equal(np.asarray(l), losses[0])
        assert shape == (8, 16, 8)


# ---------------------------------------------------------------------------
# the overlap audit across 2 ranks
# ---------------------------------------------------------------------------

def _audit(rank, world, audit, bucket):
    from bigdl_tpu_torch.optim.train_step import ShardedParameterStep

    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec())
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential([nn.Linear(8, 32, generator=g), nn.ReLU(),
                           nn.BatchNorm(32), nn.Dropout(0.2),
                           nn.Linear(32, 2, generator=g)])
    st = ShardedParameterStep(model, nn.CrossEntropyCriterion(),
                              optim.Adam(learning_rate=1e-2), mesh,
                              seed=SEED, ema_decay=0.9,
                              comm_bucket_bytes=bucket)
    rs = np.random.RandomState(rank)
    x = torch.as_tensor(rs.randn(16, 8).astype(np.float32))
    y = torch.as_tensor((rs.rand(16) > 0.5).astype(np.int64))
    ov = st.measure_overlap(x, y) if audit else None
    losses = [float(st(i, x, y)) for i in range(3)]
    return (ov, losses, st.flat_params.numpy().copy(),
            st._ema_flat.numpy().copy(),
            [b.numpy().copy() for _, b in model.named_buffers()])


@pytest.mark.parametrize("bucket", [None, 256])
def test_overlap_audit_across_ranks(pools, bucket):
    """The audit returns JAX's keys, efficiency in [0, 1], and leaves
    parameters, Adam's moments, the EMA, the buffers and the step
    counter as it found them: the steps after it are the steps without
    it, to the bit."""
    plain = pools(2).run(_audit, False, bucket)
    audited = pools(2).run(_audit, True, bucket)
    for (ov, *after), (_, *before) in zip(audited, plain):
        assert set(ov) == {"step_s", "compute_s", "collective_s",
                           "exposed_collective_s", "overlap_efficiency",
                           "comm_buckets", "grad_comm"}
        assert 0.0 <= ov["overlap_efficiency"] <= 1.0
        assert ov["collective_s"] > 0 and ov["grad_comm"] == "fp32"
        assert (ov["comm_buckets"] > 1) == (bucket is not None)
        assert after[0] == before[0]
        for a, b in zip(after[1:3] + after[3], before[1:3] + before[3]):
            np.testing.assert_array_equal(a, b)
