"""The hierarchical (DCN) data parallelism of the port over gloo on the
CPU, against the JAX package's multislice mesh of the same size
(``tests/test_multislice.py``): the ``(dcn_data, data)`` process mesh
and its groups, ``collectives.psum_wire`` in fp32, bf16 and int8, the
ZeRO-1 step's DCN hop, the byte ledger and the driver's gauges.

Ranks come from ``test_torch_port_collectives.RankPool``; rank ``r`` of
a ``dcn x data`` mesh is JAX device ``r`` of ``build_mesh(MeshSpec(
dcn_data=dcn, data=data), devices=jax.devices()[:n])`` (the DCN axis
outermost) and trains on rows ``[r B / n, (r + 1) B / n)``.

Tolerances:
- the DCN psum against JAX's, same bytes in: fp32 and bf16 are a sum of
  two addends (one rounding, the same on both sides): equal to the bit;
  int8 runs the same codec on the same values, but XLA may fuse the
  dequantize-and-sum into fused multiply-adds (one float32 rounding
  apart), and a sum one ulp apart can re-quantize one step apart in the
  second phase: within one quantization step of the sum
  (``max |sum| / 127``).
- the hierarchical step against the JAX step: fp32 at
  ``test_torch_port_zero1``'s gate, 1e-5; bf16 and int8 wires within
  ``steps * lr * (one wire step)`` on the parameters, as there (the two
  packages may round a wire element one step apart), and the first loss
  at 1e-5.
- the hierarchical step against flat data parallelism over the same four
  ranks: fp32 at 1e-5 (the sum's order differs: n - 1 float32 additions
  an element); bf16 and int8 within the wire bound above, the same
  bound ``tests/test_multislice.py`` holds its runs to in spirit.
- the ledger: equal to the byte."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.parallel import collectives as pc
from bigdl_tpu_torch.runtime import engine as engine_mod
from bigdl_tpu_torch.runtime import mesh as mesh_mod
from test_torch_port_collectives import pools  # noqa: F401 (fixture)
from test_torch_port_zero1 import (FP32_TOL, SEED, _data, _jax_variables,
                                   _method, _mlp)

# per rank process: (dcn, data) -> the mesh, built once (every rank
# creates its groups in one order, so each pool builds each shape once)
_MESHES = {}


def _mesh(dcn):
    if dcn not in _MESHES:
        _MESHES[dcn] = mesh_mod.build_mesh(
            mesh_mod.MeshSpec(dcn_data=dcn), device="cpu")
    return _MESHES[dcn]


def _jax_mesh(dcn, data):
    import jax
    from bigdl_tpu.runtime.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(dcn_data=dcn, data=data),
                      devices=jax.devices()[:dcn * data])


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _mesh_worker(rank, world, dcn):
    import torch.distributed as dist

    m = _mesh(dcn)
    ranks = []
    for g in (m.ici_group, m.dcn_group):
        t = torch.tensor([rank])
        out = torch.zeros(dist.get_world_size(g), dtype=torch.int64)
        pc.all_gather(out, t, g)
        ranks.append(out.tolist())
    return (m.data_size, m.dcn_size, m.data_index, m.dcn_index, ranks,
            mesh_mod.data_axis_size(m), mesh_mod.local_batch_slice(m, 16),
            mesh_mod.mesh_fingerprint(m))


@pytest.mark.parametrize("dcn", [2, 4])
def test_mesh_places_rank_r_as_jax_device_r(pools, dcn):
    import jax

    n = 4
    jm = _jax_mesh(dcn, n // dcn)
    assert jm.axis_names[0] == "dcn_data"
    coords = {}
    for idx, d in np.ndenumerate(np.asarray(jm.devices)):
        coords[d.id] = (idx[0], idx[2])         # (dcn, data)
    assert sorted(coords) == [d.id for d in jax.devices()[:n]]
    data = n // dcn
    for r, got in enumerate(pools(n).run(_mesh_worker, dcn)):
        d_size, c_size, d_idx, c_idx, (ici, across), dsz, sl, fp = got
        assert (d_size, c_size) == (data, dcn)
        assert (c_idx, d_idx) == coords[jax.devices()[r].id]
        assert ici == [c_idx * data + i for i in range(data)]
        assert across == [c * data + d_idx for c in range(dcn)]
        assert dsz == n and sl == (4 * r, 4)
        assert fp.endswith(f"dcn_data={dcn}xdata={data}xmodel=1xseq=1x"
                           f"expert=1xpipe=1")


def test_mesh_spec_and_env_resolve_as_jax(monkeypatch):
    from bigdl_tpu.runtime.engine import EngineConfig as JEngineConfig
    from bigdl_tpu.runtime.mesh import MeshSpec as JMeshSpec

    for n, spec in ((4, dict(dcn_data=2)), (8, dict(dcn_data=2, data=2)),
                    (4, dict(dcn_data=4))):
        assert mesh_mod.MeshSpec(**spec).resolve(n) == \
            JMeshSpec(**spec).resolve(n)
    monkeypatch.setenv("BIGDL_TPU_DCN_SLICES", "2")
    assert engine_mod.EngineConfig.from_env().mesh.dcn_data == \
        JEngineConfig.from_env().mesh.dcn_data == 2
    # one process cannot hold two slices
    with pytest.raises(ValueError, match="not divisible"):
        engine_mod.init_engine()
    engine_mod.Engine.reset()


# ---------------------------------------------------------------------------
# the DCN psum
# ---------------------------------------------------------------------------

def _psum_worker(rank, world, dcn, vecs, mode, block):
    m = _mesh(dcn)
    v = torch.as_tensor(vecs[rank])
    if mode == "bf16":
        v = v.to(torch.bfloat16)
    return pc.psum_wire(v, m.dcn_group, dcn, mode,
                        block=block).float().numpy()


def _jax_psum(dcn, data, vecs, mode, block):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from bigdl_tpu.parallel import collectives as jc
    from bigdl_tpu.runtime.mesh import shard_map

    mesh = _jax_mesh(dcn, data)
    axes = ("dcn_data", "data")

    def body(v):
        v = v[0]
        if mode == "bf16":
            v = v.astype(jnp.bfloat16)
        return jc.psum_wire(v, "dcn_data", dcn, mode,
                            block=block).astype(jnp.float32)[None]

    fn = jax.jit(shard_map(body, mesh, in_specs=(P(axes),),
                           out_specs=P(axes)))
    return np.asarray(fn(jnp.asarray(vecs)))


@pytest.mark.parametrize("mode,w,block", [
    ("fp32", 37, 1024), ("bf16", 37, 1024), ("int8", 37, 8),
    ("int8", 64, 1024)])
def test_psum_wire_matches_jax(pools, mode, w, block):
    dcn, n = 2, 4
    rs = np.random.RandomState(w + len(mode))
    vecs = (rs.randn(n, w) * rs.uniform(0.1, 10, (n, 1))).astype(np.float32)
    want = _jax_psum(dcn, n // dcn, vecs, mode, block)
    got = pools(n).run(_psum_worker, dcn, vecs, mode, block)
    for r in range(n):
        if mode == "int8":
            np.testing.assert_allclose(
                got[r], want[r], rtol=0,
                atol=np.abs(want[r]).max() / 127.0)
        else:
            np.testing.assert_array_equal(got[r], want[r])
    # the ranks of one DCN group hold the same sum
    np.testing.assert_array_equal(got[0], got[2])


def test_psum_wire_bytes_and_ledger_match_jax():
    from bigdl_tpu.parallel import collectives as jc

    for w in (1, 7, 100, 4097):
        for n in (1, 2, 4):
            for mode in pc.GRAD_COMM_MODES:
                for block in (16, 1024):
                    assert pc.psum_wire_bytes(w, n, mode, block) == \
                        jc.psum_wire_bytes(w, n, mode, block)
    for n_params, ndev, dcn in ((1000, 2, 2), (12345, 4, 2), (77, 1, 4)):
        for mode in pc.GRAD_COMM_MODES:
            for bucket in (None, 4096):
                for pcomm in pc.PARAM_COMM_MODES:
                    kw = dict(mode=mode, bucket_bytes=bucket, block=64,
                              param_comm=pcomm)
                    assert pc.layout_ledger(n_params, ndev, dcn, **kw) \
                        == jc.layout_ledger(n_params, ndev, dcn, **kw)


# ---------------------------------------------------------------------------
# the hierarchical step
# ---------------------------------------------------------------------------

def _jax_dcn_steps(dcn, data, variables, x, y, steps, spec, kw):
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.optim.train_step import ShardedParameterStep

    st = ShardedParameterStep(
        _mlp(jnn, x.shape[1], drop=0.0), jnn.CrossEntropyCriterion(),
        _method(joptim, spec), _jax_mesh(dcn, data), variables, **kw)
    st.set_step_seed(SEED + 1)
    xd, yd = st.shard_batch(x), st.shard_batch(y)
    losses = []
    for i in range(steps):
        lv, _ = st.train_bundle_device(i, [xd], [yd])
        losses.append(float(np.asarray(lv)[0]))
    return dict(losses=np.asarray(losses),
                flat=np.asarray(st.flat_params)[:st.n_real],
                ledger=(st.grad_sync_ici_bytes_per_step,
                        st.param_sync_ici_bytes_per_step,
                        st.dcn_bytes_per_step, st.n_data_replicas))


def _port_dcn_steps(rank, world, dcn, variables, x, y, steps, spec, kw):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.optim.train_step import ShardedParameterStep
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    model = load_jax_variables(_mlp(nn, x.shape[1], drop=0.0), variables)
    st = ShardedParameterStep(model, nn.CrossEntropyCriterion(),
                              _method(optim, spec), _mesh(dcn), seed=SEED,
                              **kw)
    b = len(y) // world
    xs = torch.as_tensor(x[rank * b:(rank + 1) * b])
    ys = torch.as_tensor(y[rank * b:(rank + 1) * b]).long()
    losses, gmax = [], 0.0
    for i in range(steps):
        losses.append(float(st(i, xs, ys)))
        gmax = max(gmax, float(st.flat_grads.abs().max()))
    return dict(losses=np.asarray(losses), gmax=gmax,
                flat=st.flat_params[:st.n_real].numpy().copy(),
                ledger=(st.grad_sync_ici_bytes_per_step,
                        st.param_sync_ici_bytes_per_step,
                        st.dcn_bytes_per_step, st.n_data_replicas))


STEP_CASES = [("fp32", 2, {}), ("bf16", 2, dict(grad_comm="bf16")),
              ("int8", 2, dict(grad_comm="int8", quant_block=16)),
              ("int8-buckets", 2, dict(grad_comm="int8", quant_block=16,
                                       comm_bucket_bytes=128)),
              ("fp32-one-rank-a-slice", 4, {}),
              ("int8-one-rank-a-slice", 4, dict(grad_comm="int8",
                                                quant_block=16))]


def _wire_tol(kw, got, n, lr, steps):
    gmax = max(r["gmax"] for r in got)
    mode = kw.get("grad_comm", "fp32")
    if mode == "bf16":
        step = 2 * 2.0 ** (np.floor(np.log2(n * gmax)) - 7)
    elif mode == "int8":     # a quantization step in each of two phases
        step = 2 * n * gmax / 127.0
    else:
        step = 0.0
    return steps * lr * step + FP32_TOL


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_dcn_step_matches_jax_and_flat_dp(pools, case):
    name, dcn, kw = case
    n = 4
    x, y = _data(n=32)
    mkw = dict(drop=0.0)
    variables = _jax_variables(mkw, x)
    lr, steps = 0.1, 3
    spec = ("SGD", dict(learning_rate=lr, momentum=0.9))
    want = _jax_dcn_steps(dcn, n // dcn, variables, x, y, steps, spec, kw)
    got = pools(n).run(_port_dcn_steps, dcn, variables, x, y, steps, spec,
                       kw)
    flat = pools(n).run(_port_dcn_steps, 1, variables, x, y, steps, spec,
                        kw)
    for r in range(1, n):      # every slice makes the same update
        np.testing.assert_array_equal(got[r]["flat"], got[0]["flat"])
        np.testing.assert_array_equal(got[r]["losses"], got[0]["losses"])
    tol = _wire_tol(kw, got, n, lr, steps)
    g = got[0]
    np.testing.assert_allclose(g["flat"], want["flat"], rtol=FP32_TOL,
                               atol=tol)
    np.testing.assert_allclose(g["losses"][0], want["losses"][0],
                               rtol=FP32_TOL, atol=FP32_TOL)
    if not kw:
        np.testing.assert_allclose(g["losses"], want["losses"],
                                   rtol=FP32_TOL, atol=FP32_TOL)
    assert g["ledger"] == want["ledger"]
    assert g["ledger"][2] > 0 and g["ledger"][3] == n
    # the same run as flat data parallelism over the four ranks
    np.testing.assert_allclose(g["flat"], flat[0]["flat"], rtol=FP32_TOL,
                               atol=tol)
    np.testing.assert_allclose(g["losses"][0], flat[0]["losses"][0],
                               rtol=FP32_TOL, atol=FP32_TOL)


# ---------------------------------------------------------------------------
# the driver's gauges
# ---------------------------------------------------------------------------

def _fit_worker(rank, world, x, y, mode, steps):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.data.dataset import ArrayDataSet
    from bigdl_tpu_torch.runtime import Engine

    mesh = _mesh(2)
    Engine.get().mesh = mesh         # the engine's own mesh, two slices
    try:
        opt = optim.Optimizer(_mlp(nn, x.shape[1], drop=0.0),
                              ArrayDataSet(x, y), nn.CrossEntropyCriterion(),
                              batch_size=16, seed=SEED, device="cpu")
        opt.set_optim_method(optim.SGD(learning_rate=0.1))
        opt.set_end_when(optim.Trigger.max_iteration(steps))
        opt.grad_comm = mode
        trained = opt.optimize()
        g, c = opt.metrics.gauges, opt.metrics.counters
        n_real = sum(p.numel() for p in trained.model.parameters())
        return (n_real, g["train.collective_dcn_bytes_per_step"],
                c["train.collective_dcn_bytes_total"],
                g["train.collective_ici_bytes_per_step"],
                c["train.collective_ici_bytes_total"], trained.losses)
    finally:
        Engine.reset()


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_driver_publishes_the_dcn_ledger(pools, mode):
    from bigdl_tpu.parallel import collectives as jc

    x, y = _data(n=64)
    steps = 5
    got = pools(4).run(_fit_worker, x, y, mode, steps)
    n_real, dcn_step, dcn_total, ici_step, ici_total, losses = got[0]
    led = jc.layout_ledger(n_real, 2, 2, mode=mode)
    assert dcn_step == led["dcn_bytes_per_step"] > 0
    assert ici_step == led["ici_bytes_per_step"] > 0
    assert dcn_total == steps * dcn_step
    assert ici_total == steps * ici_step
    for r in range(1, 4):
        assert got[r][5] == losses
    assert len(losses) == steps and np.all(np.isfinite(losses))
