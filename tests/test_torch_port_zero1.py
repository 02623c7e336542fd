"""ZeRO-1 data parallelism on the port over gloo on the CPU: the process
mesh and engine, ``ShardedParameterStep`` against the JAX
``ShardedParameterStep`` on a CPU mesh of the same size, the JAX gates
of ``tests/test_grad_comm.py``, the Optimizer across ranks
(``tests/test_distri_optimizer.py``'s multi-device spec), sharded
checkpoints read across world sizes and across the two packages, the
mirror, and the elastic re-sharded resume.

Ranks come from ``test_torch_port_collectives.RankPool`` (spawned gloo
processes that import no JAX); rank ``r`` of ``n`` trains on rows
``[r B / n, (r + 1) B / n)`` of the global batch, as the JAX step's
``shard_batch`` places them on device ``r``.

Tolerances:
- fp32: 1e-5 absolute and relative on losses, gradient norms,
  parameters, optimizer slots and BatchNorm buffers: the port/JAX gate
  of one device (``test_torch_port_driver``), since the cycle adds only
  the sum over n <= 4 ranks, n - 1 float32 additions an element
  (<= 3 * 2^-24 relative), to what each device computes.
- bf16 and int8 wires (SGD with momentum, three steps): the two
  packages' wires may round an element one step apart (bf16: one step
  of the sum's binade for each package's rounding; int8: one
  quantization step, ``max |g| / 127``, a source's block), and a step's
  update moves by at most ``lr`` times that (the velocity is an average
  of gradients); so parameters within ``steps * lr * step`` plus the
  fp32 gate.
- The JAX gates keep their own tolerances."""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.data.dataset import ArrayDataSet
from bigdl_tpu_torch.optim import checkpoint as ckpt_mod
from bigdl_tpu_torch.runtime import engine as engine_mod
from bigdl_tpu_torch.runtime import mesh as mesh_mod
from test_torch_port_collectives import pools  # noqa: F401 (fixture)

SEED = 11
FP32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_engine():
    engine_mod.Engine.reset()
    yield
    engine_mod.Engine.reset()


def _mlp(m, d=8, hidden=16, drop=0.3, bn=True):
    """Linear, ReLU, BatchNorm, Dropout, Linear.  (BatchNorm after the
    ReLU: right after a Linear it would make that bias's gradient zero
    but for rounding noise, which Adam scales up to full steps.)"""
    layers = [m.Linear(d, hidden), m.ReLU()]
    if bn:
        layers.append(m.BatchNorm(hidden))
    layers += ([m.Dropout(drop)] if drop else []) + [m.Linear(hidden, 2)]
    return m.Sequential(layers)


def _data(n=64, d=8, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    return x, y


def _jax_variables(mkw, x, seed=0):
    import jax
    from bigdl_tpu import nn as jnn

    v = _mlp(jnn, x.shape[1], **mkw).init(jax.random.PRNGKey(seed), x[:2])
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)


def _method(pkg, spec):
    name, kw = spec
    return getattr(pkg, name)(**kw)


def _flat_tree(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


# ---------------------------------------------------------------------------
# the two sides of a step comparison
# ---------------------------------------------------------------------------

def _jax_steps(n, variables, x, y, steps, spec, mkw, kw, mask=None):
    """The JAX ShardedParameterStep on an n-device CPU mesh: per-step
    losses and gradient norms, final flat params, opt slots, state."""
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.optim.train_step import GradientClipping, \
        ShardedParameterStep
    from test_torch_port_collectives import _jax_mesh

    kw = dict(kw)
    if "clip" in kw:
        kw["clip"] = GradientClipping(**kw["clip"])
    st = ShardedParameterStep(
        _mlp(jnn, x.shape[1], **mkw), jnn.CrossEntropyCriterion(),
        _method(joptim, spec), _jax_mesh(n), variables,
        trainable_mask=mask, **kw)
    st.set_step_seed(SEED + 1)
    xd, yd = st.shard_batch(x), st.shard_batch(y)
    losses, gnorms = [], []
    for i in range(steps):
        lv, gv = st.train_bundle_device(i, [xd], [yd])
        losses.append(float(np.asarray(lv)[0]))
        gnorms.append(float(np.asarray(gv)[0]))
    flat = np.asarray(st.flat_params)[:st.n_real]
    opt = _flat_tree(jax.device_get(st.opt_state))
    state = _flat_tree(jax.device_get(st.model_state))
    return dict(losses=np.asarray(losses), gnorms=np.asarray(gnorms),
                flat=flat, opt=opt, state=state, n_real=st.n_real,
                ledger=(st.grad_sync_ici_bytes_per_step,
                        st.param_sync_ici_bytes_per_step, st.comm_buckets))


def _port_step(rank, world, variables, x, y, spec, mkw, kw, mask=None):
    from bigdl_tpu_torch.optim.train_step import (GradientClipping,
                                                  ShardedParameterStep)
    from bigdl_tpu_torch.runtime import Engine
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    kw = dict(kw)
    if "clip" in kw:
        kw["clip"] = GradientClipping(**kw["clip"])
    model = load_jax_variables(_mlp(nn, x.shape[1], **mkw), variables)
    st = ShardedParameterStep(model, nn.CrossEntropyCriterion(),
                              _method(optim, spec), Engine.get().mesh,
                              seed=SEED, trainable_mask=mask, **kw)
    b = len(y) // world
    return st, (torch.as_tensor(x[rank * b:(rank + 1) * b]),
                torch.as_tensor(y[rank * b:(rank + 1) * b]).long())


def _port_steps(rank, world, variables, x, y, steps, spec, mkw, kw,
                mask=None, bundle=True):
    st, (xs, ys) = _port_step(rank, world, variables, x, y, spec, mkw, kw,
                              mask)
    gmax = 0.0
    if bundle:
        lv, gv = st.train_bundle(0, [xs] * steps, [ys] * steps)
        losses, gnorms = lv.numpy(), gv.numpy()
    else:
        losses = []
        for i in range(steps):
            losses.append(float(st(i, xs, ys)))
            gmax = max(gmax, float(st.flat_grads.abs().max()))
        losses, gnorms = np.asarray(losses), None
    arrays = st.checkpoint_arrays()
    return dict(losses=losses, gnorms=gnorms, gmax=gmax,
                flat=arrays["flat_params"][:st.n_real],
                opt=arrays["opt_state"], state=arrays["model_state"],
                ledger=(st.grad_sync_ici_bytes_per_step,
                        st.param_sync_ici_bytes_per_step, st.comm_buckets),
                shard=(st.shard_size, st.n_pad,
                       {k: tuple(v[0].shape) for k, v in st.opt_state.items()
                        if isinstance(v, list) and st._zero1}))


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=atol,
                               err_msg=what)


# (name, world, mlp kwargs, method, step kwargs, mask?)
FP32_CASES = [
    ("sgd-momentum", 2, {}, ("SGD", dict(learning_rate=0.1, momentum=0.9)),
     {}, False),
    ("adam", 2, {}, ("Adam", dict(learning_rate=0.01)), {}, False),
    ("adam-4", 4, {}, ("Adam", dict(learning_rate=0.01)), {}, False),
    ("lars", 2, {}, ("LarsSGD", dict(learning_rate=0.1)), {}, False),
    ("lars-4-clip", 4, {}, ("LarsSGD", dict(learning_rate=0.1)),
     dict(clip=dict(l2_norm=0.5)), False),
    ("buckets", 2, {}, ("Adam", dict(learning_rate=0.01)),
     dict(comm_bucket_bytes=256), False),
    ("clip-constant", 2, {}, ("SGD", dict(learning_rate=0.1, momentum=0.9)),
     dict(clip=dict(constant_min=-0.05, constant_max=0.05)), False),
    ("clip-l2-4", 4, {}, ("Adam", dict(learning_rate=0.01)),
     dict(clip=dict(l2_norm=0.3)), False),
    ("ema-accum", 2, {}, ("Adam", dict(learning_rate=0.01)),
     dict(ema_decay=0.9, accum_steps=2), False),
    ("mask", 2, {}, ("SGD", dict(learning_rate=0.1, momentum=0.9,
                                 weight_decay=0.01)), {}, True),
    ("mask-buckets-4", 4, dict(drop=0.0), ("Adam", dict(learning_rate=0.01)),
     dict(comm_bucket_bytes=128), True),
]


def _mask_for(variables):
    """Freeze the first Linear's bias and the BatchNorm's scale."""
    mask = {k: {kk: True for kk in v} for k, v in
            variables["params"].items()}
    mask["0_Linear"]["bias"] = False
    for k in mask:
        if "BatchNorm" in k:
            mask[k]["weight"] = False
    return mask


@pytest.mark.parametrize("case", FP32_CASES, ids=[c[0] for c in FP32_CASES])
def test_sharded_step_matches_jax_fp32(pools, case):
    name, n, mkw, spec, kw, masked = case
    x, y = _data(n=32)
    variables = _jax_variables(mkw, x)
    mask = _mask_for(variables) if masked else None
    steps = 3
    want = _jax_steps(n, variables, x, y, steps, spec, mkw, kw, mask)
    got = pools(n).run(_port_steps, variables, x, y, steps, spec, mkw, kw,
                       mask)
    for r in range(1, n):       # replicated to the bit across ranks
        np.testing.assert_array_equal(got[r]["flat"], got[0]["flat"])
        np.testing.assert_array_equal(got[r]["losses"], got[0]["losses"])
    g = got[0]
    _close(g["losses"], want["losses"], FP32_TOL, "losses")
    _close(g["gnorms"], want["gnorms"], FP32_TOL, "gradient norms")
    _close(g["flat"], want["flat"], FP32_TOL, "params")
    for k, v in g["opt"].items():
        w = want["opt"][k]
        _close(np.asarray(v).reshape(-1)[:w.size if k.count("/") else
                                         want["n_real"]],
               w.reshape(-1)[:w.size if k.count("/") else want["n_real"]],
               FP32_TOL, f"slot {k}")
    assert set(g["state"]) == set(want["state"])
    for k, v in g["state"].items():
        _close(v, want["state"][k], FP32_TOL, f"buffer {k}")
    assert g["ledger"] == want["ledger"]
    shard, n_pad, slots = g["shard"]
    if spec[0] != "LarsSGD":    # each rank holds 1/n of every slot
        assert n_pad == -(-want["n_real"] // n) * n and shard == n_pad // n
        assert slots and all(s == (shard,) for s in slots.values())
    if masked:                  # frozen entries kept to the bit
        leaves = _flat_tree(variables["params"])
        off = 0
        for k in sorted(leaves):    # the ravel order
            size = leaves[k].size
            if k == "0_Linear/bias":
                np.testing.assert_array_equal(g["flat"][off:off + size],
                                              leaves[k].reshape(-1))
            off += size


WIRE_CASES = [("bf16", 2, dict(grad_comm="bf16")),
              ("int8", 2, dict(grad_comm="int8", quant_block=16)),
              ("int8-4-buckets", 4, dict(grad_comm="int8", quant_block=16,
                                         comm_bucket_bytes=128)),
              ("param-int8", 2, dict(param_comm="int8", quant_block=16)),
              ("both-int8-4", 4, dict(grad_comm="int8", param_comm="int8",
                                      quant_block=32)),
              ("bf16-4-clip", 4, dict(grad_comm="bf16",
                                      clip=dict(l2_norm=0.5)))]


@pytest.mark.parametrize("case", WIRE_CASES, ids=[c[0] for c in WIRE_CASES])
def test_sharded_step_wire_formats_match_jax(pools, case):
    name, n, kw = case
    x, y = _data(n=32)
    mkw = {}
    variables = _jax_variables(mkw, x)
    lr, steps = 0.1, 3
    spec = ("SGD", dict(learning_rate=lr, momentum=0.9))
    want = _jax_steps(n, variables, x, y, steps, spec, mkw, kw)
    got = pools(n).run(_port_steps, variables, x, y, steps, spec, mkw, kw,
                       None, False)
    for r in range(1, n):
        np.testing.assert_array_equal(got[r]["flat"], got[0]["flat"])
    gmax = max(r["gmax"] for r in got)
    if kw.get("grad_comm") == "bf16":
        step = 2 * 2.0 ** (np.floor(np.log2(n * gmax)) - 7)
    else:
        step = gmax / 127.0
    tol = steps * lr * step + FP32_TOL
    np.testing.assert_allclose(got[0]["flat"], want["flat"], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got[0]["losses"][0], want["losses"][0],
                               atol=FP32_TOL)
    assert got[0]["ledger"] == want["ledger"]


# ---------------------------------------------------------------------------
# the JAX gates of tests/test_grad_comm.py, on the port
# ---------------------------------------------------------------------------

def _gate_run(rank, world, variables, x, y, steps, spec, kw):
    st, (xs, ys) = _port_step(rank, world, variables, x, y, spec,
                              dict(bn=False, drop=0.0), kw)
    losses = [float(st(i, xs, ys)) for i in range(steps)]
    flat = st.flat_params[:st.n_real].numpy().copy()
    return losses, flat, st.comm_buckets


def _gate_data():
    x, y = _data()
    return x, y, _jax_variables(dict(bn=False, drop=0.0), x, seed=0)


SGD_GATE = ("SGD", dict(learning_rate=0.2, momentum=0.9))


def test_loss_parity_int8_vs_fp32(pools):
    x, y, v = _gate_data()
    lf = pools(2).run(_gate_run, v, x, y, 30, SGD_GATE, {})[0][0]
    lq = pools(2).run(_gate_run, v, x, y, 30, SGD_GATE,
                      dict(grad_comm="int8", quant_block=64))[0][0]
    assert lf[-1] < 0.5 * lf[0], "fp32 baseline failed to converge"
    assert lq[-1] < 0.5 * lq[0], "int8 run failed to converge"
    assert abs(lq[-1] - lf[-1]) <= max(0.05 * abs(lf[-1]), 0.02)


def test_loss_parity_param_comm_int8(pools):
    x, y, v = _gate_data()
    lf = pools(2).run(_gate_run, v, x, y, 30, SGD_GATE, {})[0][0]
    lq = pools(2).run(_gate_run, v, x, y, 30, SGD_GATE,
                      dict(param_comm="int8", quant_block=64))[0][0]
    assert lq[-1] < 0.5 * lq[0], "param_comm=int8 failed to converge"
    assert abs(lq[-1] - lf[-1]) <= max(0.05 * abs(lf[-1]), 0.02)
    full = pools(2).run(_gate_run, v, x, y, 30, SGD_GATE,
                        dict(grad_comm="int8", param_comm="int8",
                             quant_block=64))[0][0]
    assert full[-1] < 0.5 * full[0], "fully-quantized cycle diverged"
    assert abs(full[-1] - lf[-1]) <= max(0.05 * abs(lf[-1]), 0.03)


def test_bucketed_matches_monolithic_fp32(pools):
    x, y, v = _gate_data()
    adam = ("Adam", dict(learning_rate=0.02))
    lm, pm, nm = pools(2).run(_gate_run, v, x, y, 10, adam, {})[0]
    lb, pb, nb = pools(2).run(_gate_run, v, x, y, 10, adam,
                              dict(comm_bucket_bytes=256))[0]
    assert nm == 1 and nb > 1
    np.testing.assert_allclose(lb, lm, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(pb, pm, rtol=2e-4, atol=1e-6)


class _ScalarStateSGD(optim.OptimMethod):
    """An elementwise-flagged method with one scalar slot."""

    lr = 0.1

    def init_state(self, params):
        return {"gsq_mean": torch.zeros(())}

    def apply(self, s, grads, params, state):
        for g, p in zip(grads, params):
            p.sub_(self.lr * g)


def _refusal_worker(rank, world, variables, x, y):
    import warnings

    from bigdl_tpu_torch.optim.train_step import ShardedParameterStep
    from bigdl_tpu_torch.runtime import Engine

    mesh = Engine.get().mesh

    def make(**kw):
        return ShardedParameterStep(_mlp(nn, bn=False, drop=0.0),
                                    nn.CrossEntropyCriterion(),
                                    kw.pop("method", optim.SGD(0.1)), mesh,
                                    **kw)

    out = {}
    for bad in (dict(grad_comm="int4"), dict(param_comm="bf16")):
        try:
            make(**bad)
            out[str(bad)] = None
        except ValueError as e:
            out[str(bad)] = str(e)
    out["INT8"] = make(grad_comm="INT8").grad_comm
    out["Bf16"] = make(grad_comm=" Bf16 ").grad_comm
    out["pINT8"] = make(param_comm=" INT8 ").param_comm
    try:
        make(method=_ScalarStateSGD(), comm_bucket_bytes=256)
        out["bucket"] = None
    except ValueError as e:
        out["bucket"] = str(e)
    # monolithic: the scalar slot is fine
    make(method=_ScalarStateSGD())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        shim = make(bf16_grads=True)
        both = make(bf16_grads=True, grad_comm="int8")
    out["warned"] = sum(issubclass(c.category, DeprecationWarning)
                        for c in w)
    out["shim"] = (shim.grad_comm, shim.bf16_grads,
                   shim.collective_bytes_per_step,
                   make(grad_comm="bf16").collective_bytes_per_step)
    out["both"] = (both.grad_comm, both.bf16_grads)
    return out


def test_invalid_wires_buckets_and_bf16_shim(pools):
    """test_invalid_grad_comm_rejected, test_bucketing_rejects_non_
    elementwise_state and test_bf16_grads_deprecation_shim on the port."""
    x, y, v = _gate_data()
    out = pools(2).run(_refusal_worker, v, x, y)[0]
    assert "grad_comm" in out[str(dict(grad_comm="int4"))]
    assert "param_comm" in out[str(dict(param_comm="bf16"))]
    assert (out["INT8"], out["Bf16"], out["pINT8"]) == ("int8", "bf16",
                                                         "int8")
    assert "per-element" in out["bucket"]
    assert out["warned"] == 2
    grad_comm, flag, b_shim, b_modern = out["shim"]
    assert grad_comm == "bf16" and flag and b_shim == b_modern > 0
    assert out["both"] == ("int8", False)


# ---------------------------------------------------------------------------
# the engine and the mesh
# ---------------------------------------------------------------------------

def test_engine_from_env_reads_the_jax_names(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("BIGDL_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("BIGDL_TPU_PROCESS_ID", "3")
    monkeypatch.setenv("BIGDL_TPU_GRAD_COMM", "INT8")
    monkeypatch.setenv("BIGDL_TPU_COMM_BUCKET_BYTES", "1048576")
    cfg = engine_mod.EngineConfig.from_env()
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id) \
        == ("10.0.0.1:1234", 4, 3)
    assert (cfg.grad_comm, cfg.comm_bucket_bytes) == ("int8", 1048576)
    cfg.check()


@pytest.mark.parametrize("field,value,match", [
    ("metrics_port", 9090, "A.6.7"), ("slo_specs", "[]", "A.6.7"),
    ("peak_flops", 1e15, "A.6.7"), ("grad_comm", "int4", "grad_comm"),
    ("comm_bucket_bytes", 0, "comm_bucket_bytes"),
    ("coordinator_address", "localhost:1", "num_processes"),
])
def test_engine_config_refusals(field, value, match):
    with pytest.raises(ValueError, match=match):
        engine_mod.Engine(engine_mod.EngineConfig(**{field: value}))


@pytest.mark.parametrize("axes,match", [
    (dict(dcn_data=2), "not divisible"),
    (dict(model=2), r"A\.6\.6 \(parallel/tp\.py"), (dict(seq=2), r"A\.4"),
    (dict(expert=2), r"A\.6\.6"), (dict(pipe=2), r"A\.6\.6"),
    (dict(data=2), "exceeds device count"),
])
def test_mesh_axes_beyond_data_are_refused(axes, match):
    with pytest.raises(ValueError, match=match):
        engine_mod.init_engine(engine_mod.EngineConfig(), **axes)


def test_one_process_engine_and_mesh():
    eng = engine_mod.init_engine(engine_mod.EngineConfig(grad_comm="bf16"))
    m = eng.mesh
    assert (m.world_size, m.rank, m.distributed, m.data_size) == \
        (1, 0, False, 1)
    assert (eng.node_number, eng.core_number) == (1, 1)
    assert eng.config.mesh.dcn_data == 0      # auto resolves to 1
    assert m.shape[mesh_mod.AXIS_DCN] == 1
    assert mesh_mod.local_batch_slice(m, 64) == (0, 64)
    assert mesh_mod.mesh_fingerprint(m).startswith("1:cpu:cpu:")
    # the JAX MeshSpec resolves the same sizes
    from bigdl_tpu.runtime.mesh import MeshSpec as JMeshSpec
    for n, spec in ((8, {}), (8, dict(data=4)), (6, dict(model=2))):
        assert mesh_mod.MeshSpec(**spec).resolve(n) == \
            JMeshSpec(**spec).resolve(n)


def test_rendezvous_without_cuda_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = engine_mod.EngineConfig(
        coordinator_address=f"file://{tmp_path}/rdv", num_processes=1,
        process_id=0, timeout_s=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_mod.Engine(cfg)
    import torch.distributed as dist

    assert not dist.is_initialized()    # never fell back to gloo


def _mesh_worker(rank, world):
    from bigdl_tpu_torch.runtime import Engine
    import torch.distributed as dist

    eng = Engine.get()
    m = eng.mesh
    return (m.world_size, m.rank, m.data_size, eng.node_number,
            eng.core_number, str(eng.device), dist.get_backend(),
            mesh_mod.local_batch_slice(m, 8 * world),
            mesh_mod.mesh_fingerprint(m))


@pytest.mark.parametrize("n", [2, 4])
def test_engine_joins_the_ranks(pools, n):
    for r, got in enumerate(pools(n).run(_mesh_worker)):
        assert got[:7] == (n, r, n, n, 1, "cpu", "gloo")
        assert got[7] == (8 * r, 8)
        assert got[8].startswith(f"{n}:cpu:cpu:")


# ---------------------------------------------------------------------------
# the Optimizer across ranks
# ---------------------------------------------------------------------------

def synthetic_classification(n=1024, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d) * 3
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def _dmlp():
    torch.manual_seed(0)
    return nn.Sequential([nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4),
                          nn.LogSoftMax()])


def _fit_eval(rank, world, n_iter=20):
    x, y = synthetic_classification(n=512)
    ds = DataSet.array(x, y)
    opt = optim.Optimizer(_dmlp(), ds, nn.ClassNLLCriterion(),
                          batch_size=64, seed=7, device="cpu")
    opt.set_optim_method(optim.SGD(learning_rate=0.1))
    opt.set_end_when(optim.Trigger.max_iteration(n_iter))
    opt.set_validation(optim.Trigger.several_iteration(10),
                       DataSet.array(x[:100], y[:100]),
                       [optim.Top1Accuracy()], batch_size=32)
    trained = opt.optimize()
    res = trained.evaluate(ds, [optim.Loss(nn.CrossEntropyCriterion())],
                           batch_size=64)
    g = opt.metrics.snapshot()["gauges"]
    return (res[0].result, opt.losses,
            [(it, r[0].result, r[0].count) for it, r in opt.validations],
            {k: v for k, v in g.items() if "collective" in k
             or "buckets" in k})


def test_multi_device_matches_single_device(pools):
    """The port's counterpart of test_distri_optimizer's spec: 1 rank
    against 2 and 4 ranks on the same global batches, rel 2e-3."""
    single = _fit_eval(0, 1)
    for n in (2, 4):
        got = pools(n).run(_fit_eval)
        for r in range(1, n):
            assert got[r][:3] == got[0][:3]
        assert got[0][0] == pytest.approx(single[0], rel=2e-3), (n, got[0])
        np.testing.assert_allclose(got[0][1], single[1], rtol=2e-3)
        # validation over every rank's plan: all 100 rows counted once
        assert [(it, c) for it, _, c in got[0][2]] == [(10, 100), (20, 100)]
        for (_, a, _), (_, b, _) in zip(got[0][2], single[2]):
            assert a == pytest.approx(b, abs=0.02)
        g = got[0][3]
        assert g["train.grad_comm_buckets"] == 1
        assert g["train.collective_dcn_bytes_per_step"] == 0
        assert g["train.collective_ici_bytes_per_step"] == \
            g["train.collective_grad_ici_bytes_per_step"] + \
            g["train.collective_param_ici_bytes_per_step"] > 0
    assert single[3]["train.collective_ici_bytes_per_step"] == 0


# ---------------------------------------------------------------------------
# sharded checkpoints, the mirror and the elastic resume
# ---------------------------------------------------------------------------

def _ckpt_run(rank, world, d, n_iter, mirror=None, sharded="auto",
              method=("Adam", dict(learning_rate=0.01)), async_write=False,
              seen=False):
    x, y = synthetic_classification(n=256)
    ds = _Recording(x, y) if seen else DataSet.array(x, y)
    opt = optim.Optimizer(_dmlp(), ds, nn.ClassNLLCriterion(),
                          batch_size=32, seed=3, device="cpu")
    opt.set_optim_method(_method(optim, method))
    opt.set_end_when(optim.Trigger.max_iteration(n_iter))
    opt.set_checkpoint(d, optim.Trigger.several_iteration(3),
                       async_write=async_write, sharded=sharded,
                       mirror=mirror)
    trained = opt.optimize()
    params = _flat_tree(trained.variables["params"])
    return (opt.final_state, opt.losses,
            np.concatenate([params[k].reshape(-1) for k in sorted(params)]),
            opt.metrics.counter("elastic_resumes_total"),
            opt.metrics.counter("elastic_resharded_total"),
            ds.seen if seen else None)


class _Recording(ArrayDataSet):
    """An array dataset that records the first feature (unique a row
    here) of every row its re-sharded plans hand out."""

    def __init__(self, x, y):
        super().__init__(x, y)
        self.seen = []

    def resharded_batches(self, *a, **kw):
        for mb in super().resharded_batches(*a, **kw):
            w = mb.get("weight")
            n = int(np.sum(w)) if w is not None else len(mb["target"])
            self.seen.extend(np.asarray(mb["input"])[:n, 0].tolist())
            yield mb


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_sharded_checkpoint_resumes_at_world_1_and_4(pools, tmp_path):
    """World 2 writes sharded checkpoints mid-epoch (8 global batches an
    epoch; saves at 3 and 6) with a mirror; world 1 and world 4 resume
    from ckpt-6 on re-sharded plans to the epoch's end and on."""
    d, m = str(tmp_path / "ck"), str(tmp_path / "mirror")
    two = pools(2).run(_ckpt_run, d, 6, m)
    latest = ckpt_mod.latest_checkpoint(d)
    assert latest.endswith("ckpt-6")
    names = sorted(os.listdir(latest))
    shards = [n for n in names if n.startswith("opt_state.shard")]
    assert len(shards) == 2 and "opt_state.npz" not in names
    man = json.load(open(os.path.join(latest, "manifest.json")))
    assert man["opt_shards"] == 2 and man["opt_shards_attempt"]
    assert man["driver_state"]["process_count"] == 2
    assert all(man["opt_shards_attempt"] in s for s in shards)
    # the mirror holds the same trees, kept like the primary
    assert sorted(os.listdir(m)) == sorted(os.listdir(d))
    for step in ("ckpt-3", "ckpt-6"):
        assert _tree_bytes(os.path.join(m, step)) == \
            _tree_bytes(os.path.join(d, step))
    flat, opt_state, _, saved, _ = ckpt_mod.load_checkpoint(latest)
    np.testing.assert_array_equal(flat[:len(two[0][2])], two[0][2])
    # the merged slots: n_pad long, every entry from a shard
    assert opt_state["m"].shape == flat.shape == (two[0][2].size,)
    assert np.count_nonzero(opt_state["v"]) == flat.size
    x, _ = synthetic_classification(n=256)
    # epoch 1 of 8 global batches: world 2 trained 6 of them
    rest = _remaining_rows(x, trained=6, old=2)
    assert len(rest) == 64
    for world in (1, 4):
        dd = str(tmp_path / f"resume{world}")
        shutil.copytree(d, dd)
        args = (dd, 12, None, "auto", ("Adam", dict(learning_rate=0.01)),
                False, True)
        res = ([_ckpt_run(0, 1, *args)] if world == 1
               else pools(4).run(_ckpt_run, *args))
        final, losses, w, resumes, resharded, _ = res[0]
        assert final["iteration"] == 12 and resumes == resharded == 1
        assert len(losses) == 6 and np.all(np.isfinite(losses))
        # the re-sharded remainder is exactly the rows world 2 had not
        # trained: nothing replayed, nothing dropped
        assert sorted(sum((r[5] for r in res), [])) == sorted(rest)


def _remaining_rows(x, trained, old, batch=32, seed=3, epoch=1):
    """The first feature of the rows of epoch ``epoch`` that ``old``
    processes had not trained after ``trained`` global batches."""
    from bigdl_tpu_torch.data.dataset import _epoch_permutation

    n = len(x)
    idx = _epoch_permutation(n, True, seed, epoch)
    done = np.zeros(n, bool)
    for p in range(old):
        done[np.arange(p, n, old)[:trained * (batch // old)]] = True
    return x[idx[~done], 0].tolist()


def test_elastic_resume_reshards_epoch_on_process_count_change(tmp_path,
                                                               caplog):
    """The port's counterpart of tests/test_resilience.py's spec: a
    checkpoint recorded at another process_count does not apply its
    mid-epoch skip; the epoch continues on a re-sharded plan over its
    remaining examples, nothing replayed, nothing dropped."""
    rs = np.random.RandomState(0)
    x = rs.rand(64, 4).astype(np.float32)
    y = x @ np.asarray([[1.0], [2.0], [-1.0], [0.5]], np.float32)

    def run(n_iters, data):
        opt = (optim.Optimizer(nn.Linear(4, 1), data, nn.MSECriterion(),
                               batch_size=16, seed=3, device="cpu")
               .set_optim_method(optim.SGD(learning_rate=0.2))
               .set_end_when(optim.Trigger.max_iteration(n_iters)))
        opt.set_checkpoint(d, optim.Trigger.several_iteration(2))
        opt.optimize()
        return opt

    d = str(tmp_path / "ck")
    run(6, DataSet.array(x, y))
    latest = ckpt_mod.latest_checkpoint(d)
    mpath = os.path.join(latest, "manifest.json")
    manifest = json.load(open(mpath))
    assert manifest["driver_state"]["process_count"] == 1   # recorded
    assert manifest["driver_state"]["epoch"] == 2
    manifest["driver_state"]["process_count"] = 2
    manifest["driver_state"]["epoch_batch"] = 2
    json.dump(manifest, open(mpath, "w"))

    data = _Recording(x, y)
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch.optim"):
        opt2 = run(8, data)
    assert opt2.final_state["iteration"] == 8
    assert opt2.metrics.counter("elastic_resumes_total") == 1
    assert opt2.metrics.counter("elastic_resharded_total") == 1
    assert any("elastic resume" in r.getMessage()
               and "process_count=2" in r.getMessage()
               and "re-sharded" in r.getMessage() for r in caplog.records)
    # the two steps of the resumed epoch trained exactly the 32 rows the
    # forged two processes had not: nothing replayed, nothing dropped
    want = _remaining_rows(x, trained=2, old=2, batch=16, epoch=2)
    assert sorted(data.seen) == sorted(want) and len(want) == 32
    # the same process count: the skip applies, nothing elastic
    opt3 = run(12, DataSet.array(x, y))
    assert opt3.metrics.counter("elastic_resumes_total") == 0


def test_elastic_resume_replays_epoch_when_dataset_cannot_reshard(tmp_path):
    rs = np.random.RandomState(0)
    x = rs.rand(64, 4).astype(np.float32)
    y = x.sum(1, keepdims=True)

    class Plain(DataSet):
        def __init__(self):
            self.inner = DataSet.array(x, y)

        def size(self):
            return 64

        def batches(self, *a, **kw):
            return self.inner.batches(*a, **kw)

    d = str(tmp_path / "ck")

    def run(n):
        opt = (optim.Optimizer(nn.Linear(4, 1), Plain(), nn.MSECriterion(),
                               batch_size=16, seed=3, device="cpu")
               .set_optim_method(optim.SGD(learning_rate=0.2))
               .set_end_when(optim.Trigger.max_iteration(n)))
        opt.set_checkpoint(d, optim.Trigger.several_iteration(2))
        opt.optimize()
        return opt

    run(6)
    mpath = os.path.join(ckpt_mod.latest_checkpoint(d), "manifest.json")
    manifest = json.load(open(mpath))
    manifest["driver_state"]["process_count"] = 2
    json.dump(manifest, open(mpath, "w"))
    opt = run(10)
    # epoch 2 (4 batches) replayed from its start: iterations 7 to 10
    assert opt.metrics.counter("elastic_resumes_total") == 1
    assert opt.metrics.counter("elastic_resharded_total") == 0
    assert opt.final_state["iteration"] == 10 and len(opt.losses) == 4
    assert (opt.final_state["epoch"], opt.final_state["epoch_batch"]) == \
        (2, 4)


def test_checkpoints_cross_the_packages_sharded(pools, tmp_path):
    """A JAX checkpoint from a 2-device mesh (sharded=True) resumes on the
    port at world 2; the port's world-2 sharded checkpoint loads in
    ``bigdl_tpu.optim.checkpoint.load_checkpoint``."""
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
    from bigdl_tpu.optim import checkpoint as jckpt
    from bigdl_tpu.optim.train_step import ShardedParameterStep as JStep
    from bigdl_tpu.runtime.engine import Engine as JEngine, init_engine
    from test_torch_port_collectives import _jax_mesh

    x, y = synthetic_classification(n=256)
    jm = nn_jax = jnn.Sequential([jnn.Linear(16, 64), jnn.ReLU(),
                                  jnn.Linear(64, 4), jnn.LogSoftMax()])
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(0), x[:1]))
    jdir = str(tmp_path / "jax")
    JEngine.reset()
    init_engine(data=2)
    try:
        jopt = joptim.Optimizer(nn_jax, JArrayDataSet(x, y),
                                jnn.ClassNLLCriterion(), batch_size=32,
                                seed=3)
        jopt.set_optim_method(joptim.Adam(learning_rate=0.01))
        jopt.set_end_when(joptim.Trigger.max_iteration(3))
        jopt.set_initial_variables(init)
        jopt.set_checkpoint(jdir, joptim.Trigger.several_iteration(3),
                            sharded=True)
        jopt.log_every = 100
        jopt.optimize()
    finally:
        JEngine.reset()
    jlatest = jckpt.latest_checkpoint(jdir)
    assert any(n.startswith("opt_state.shard") for n in os.listdir(jlatest))
    jflat, jopt_state, _, _, _ = ckpt_mod.load_checkpoint(jlatest)
    res = pools(2).run(_resume_from, jdir)
    for r in range(2):
        flat, m, final = res[r]
        np.testing.assert_array_equal(flat, jflat[:len(flat)])
        np.testing.assert_array_equal(m, jopt_state["m"][:len(m)])
        assert final["iteration"] == 4

    pdir = str(tmp_path / "port")
    pools(2).run(_ckpt_run, pdir, 3)
    platest = ckpt_mod.latest_checkpoint(pdir)
    step = JStep(jm, jnn.ClassNLLCriterion(), joptim.Adam(learning_rate=0.01),
                 _jax_mesh(2), init)
    flat, opt_state, mstate, drv, _ = jckpt.load_checkpoint(
        platest, opt_state_template=step.opt_template,
        model_state_template=step.model_state_template)
    want = ckpt_mod.load_checkpoint(platest)
    np.testing.assert_array_equal(flat, want[0])
    np.testing.assert_array_equal(np.asarray(opt_state["m"]), want[1]["m"])
    assert drv["iteration"] == 3 and drv["process_count"] == 2


def _resume_from(rank, world, d):
    """Resume a copy of ``d`` at its own iteration (3: no step runs) and
    report the restored flat parameters and Adam ``m``; then one step."""
    import tempfile

    dd = tempfile.mkdtemp()
    shutil.copytree(d, dd, dirs_exist_ok=True)
    x, y = synthetic_classification(n=256)
    opt = optim.Optimizer(_dmlp(), DataSet.array(x, y),
                          nn.ClassNLLCriterion(), batch_size=32, seed=3,
                          device="cpu")
    opt.set_optim_method(optim.Adam(learning_rate=0.01))
    opt.set_end_when(optim.Trigger.max_iteration(3))
    opt.set_checkpoint(dd, optim.Trigger.several_iteration(100))
    arrays = opt.optimize()._step.checkpoint_arrays()
    opt.set_end_when(optim.Trigger.max_iteration(4))
    opt.optimize()
    return (arrays["flat_params"], arrays["opt_state"]["m"],
            opt.final_state)


def test_checkpoint_write_fail_before_the_manifest_sharded(tmp_path):
    """checkpoint_write_fail fires after every shard and before the
    manifest: the directory is no checkpoint, the previous one stands."""
    from bigdl_tpu_torch.resilience import faults

    d = str(tmp_path)
    kw = dict(flat_params=np.zeros(4, np.float32), model_state={},
              shard_count=2, attempt="aa")
    for i in range(2):
        ckpt_mod.save_checkpoint(d, 1, opt_shards=ckpt_mod.local_opt_shards(
            {"m": np.full(2, i, np.float32)}, 2 * i), shard_index=1 - i,
            **kw)
    assert ckpt_mod.latest_checkpoint(d).endswith("ckpt-1")
    faults.install([faults.FaultSpec("checkpoint_write_fail", at_step=2)])
    try:
        for i in (1, 0):
            sh = ckpt_mod.local_opt_shards({"m": np.ones(2, np.float32)},
                                           2 * i)
            if i == 0:
                with pytest.raises(Exception):
                    ckpt_mod.save_checkpoint(d, 2, opt_shards=sh,
                                             shard_index=0, **kw)
            else:
                ckpt_mod.save_checkpoint(d, 2, opt_shards=sh,
                                         shard_index=1, **kw)
    finally:
        faults.clear()
    assert not os.path.exists(os.path.join(d, "ckpt-2", "manifest.json"))
    assert ckpt_mod.latest_checkpoint(d).endswith("ckpt-1")
    merged = ckpt_mod.load_checkpoint(os.path.join(d, "ckpt-1"))[1]
    np.testing.assert_array_equal(merged["m"], [0, 0, 1, 1])
    # a shard of another attempt is not this manifest's
    os.remove(os.path.join(d, "ckpt-1", ckpt_mod._shard_name(1, 2, "aa")))
    assert ckpt_mod.latest_checkpoint(d) is None


def test_mirror_retries_then_copies_manifest_last(tmp_path):
    from bigdl_tpu_torch.optim.metrics import Metrics
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.resilience.retry import RetryPolicy
    from bigdl_tpu_torch.utils import storage

    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "manifest.json").write_text("{}")
    (src / "a.npz").write_bytes(b"x" * 10)
    (src / "sub" / "b").write_bytes(b"y" * 3)
    order = []
    real_open = storage.open_file

    def spy(path, mode="rb"):
        if "w" in mode:
            order.append(os.path.basename(path))
        return real_open(path, mode)

    m = Metrics()
    faults.install([faults.FaultSpec("storage_io_fail", at_step=None,
                                     every=3, max_fires=1)])
    storage.open_file = spy
    try:
        n = storage.mirror_tree(str(src), str(tmp_path / "dst"),
                                policy=RetryPolicy(max_retries=2,
                                                   base_s=0.0, jitter=0.0),
                                metrics=m, sleep=lambda s: None)
    finally:
        storage.open_file = real_open
        faults.clear()
    assert n == 15 and order[-1] == "manifest.json"
    assert m.counter("retries_by_cause.transient_storage") == 1
    assert _tree_bytes(str(tmp_path / "dst")) == _tree_bytes(str(src))


def test_set_checkpoint_options_on_one_process(tmp_path):
    """The options the port refused before: sharded=True writes one shard
    of the whole state at offset 0 on one process, and the mirror holds
    the same tree; a bad ``sharded`` raises."""
    x, y = synthetic_classification(n=128)
    d, m = str(tmp_path / "ck"), str(tmp_path / "mirror")
    opt = optim.Optimizer(_dmlp(), DataSet.array(x, y),
                          nn.ClassNLLCriterion(), batch_size=32, seed=3,
                          device="cpu")
    opt.set_optim_method(optim.Adam(learning_rate=0.01))
    opt.set_end_when(optim.Trigger.max_iteration(3))
    opt.set_checkpoint(d, optim.Trigger.several_iteration(3), sharded=True,
                       mirror=m)
    opt.optimize()
    latest = ckpt_mod.latest_checkpoint(d)
    names = os.listdir(latest)
    assert [n for n in names if n.startswith("opt_state")] == \
        [n for n in names if n.startswith("opt_state.shard00000-of-00001")]
    assert _tree_bytes(os.path.join(m, "ckpt-3")) == _tree_bytes(latest)
    with pytest.raises(ValueError, match="sharded"):
        opt.set_checkpoint(d, optim.Trigger.several_iteration(3),
                           sharded="yes")


def test_measure_overlap_is_refused(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_MEASURE_OVERLAP", "1")
    x, y = synthetic_classification(n=64)
    opt = optim.Optimizer(_dmlp(), DataSet.array(x, y),
                          nn.ClassNLLCriterion(), batch_size=32,
                          device="cpu")
    with pytest.raises(ValueError, match="A.6.7"):
        opt.optimize()


def test_optimizer_grad_comm_resolution():
    import warnings

    x, y = synthetic_classification(n=64)
    opt = optim.Optimizer(_dmlp(), DataSet.array(x, y),
                          nn.ClassNLLCriterion(), device="cpu")
    cfg = engine_mod.EngineConfig()
    assert opt._resolved_grad_comm(cfg) == "fp32"
    cfg.grad_comm = "int8"
    assert opt._resolved_grad_comm(cfg) == "int8"
    opt.bf16_grads = True
    with pytest.warns(DeprecationWarning, match="bf16_grads"):
        assert opt._resolved_grad_comm(cfg) == "bf16"
    opt.grad_comm = "int8"
    with pytest.warns(DeprecationWarning, match="wins"):
        assert opt._resolved_grad_comm(cfg) == "int8"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        opt.bf16_grads = False
        assert opt._resolved_grad_comm(cfg) == "int8"
