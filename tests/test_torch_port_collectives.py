"""The port's ZeRO-1 wire layer (``bigdl_tpu_torch.parallel.collectives``)
over gloo on the CPU, against ``bigdl_tpu.parallel.collectives`` on a
CPU mesh of the same size.

Rank ``r`` of the port holds what device ``r`` of the JAX mesh holds.
The ranks are spawned processes (``RankPool``, shared by
``test_torch_port_zero1.py``) that join through the port's own engine
(``init_engine`` with a ``file://`` rendezvous, so parallel test workers
never race for a port) and run many cases each; every rendezvous,
collective and wait has its own timeout.  The rank processes import no
JAX: JAX runs only in the test process.

Tolerances: fp32 within float32 summation order (n <= 4 addends an
element: rtol 1e-6); bf16 within one bfloat16 step of the sum
(2^-7 of its magnitude's binade, plus one for each rank's cast); int8
within one quantization step a source and block (blockmax / 127 each,
n sources).  The estimators are equal exactly."""

import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.parallel import collectives as pc

WAIT_S = 60          # any single case, every rank
JOIN_S = 20


# ---------------------------------------------------------------------------
# the rank pool
# ---------------------------------------------------------------------------

def _rank_main(rank, world, init_file, inq, outq):
    torch.set_num_threads(1)
    from bigdl_tpu_torch.runtime import EngineConfig, init_engine

    init_engine(EngineConfig(coordinator_address=f"file://{init_file}",
                             num_processes=world, process_id=rank,
                             timeout_s=WAIT_S), device="cpu")
    import torch.distributed as dist

    try:
        while True:
            item = inq.get()
            if item is None:
                break
            fn, args = item
            try:
                outq.put((rank, True, fn(rank, world, *args)))
            except Exception:        # reported to the test, which fails
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned gloo ranks; ``run(fn, *args)`` calls the
    module-level ``fn(rank, world, *args)`` on every rank and returns the
    results in rank order, raising if any rank raised or timed out."""

    def __init__(self, world: int, tmpdir: str):
        ctx = mp.get_context("spawn")
        self.world = world
        init_file = os.path.join(tmpdir, f"rendezvous-{world}")
        self.inq = [ctx.Queue() for _ in range(world)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, init_file, self.inq[r],
                                        self.outq))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, fn, *args, timeout: float = WAIT_S):
        if self.broken:
            raise RuntimeError("an earlier case left the rank pool broken")
        for q in self.inq:
            q.put((fn, args))
        out, errors = {}, []
        try:
            for _ in range(self.world):
                rank, ok, val = self.outq.get(timeout=timeout)
                (out.__setitem__(rank, val) if ok
                 else errors.append(f"rank {rank}:\n{val}"))
        except queue.Empty:
            self.broken = True
            raise TimeoutError(f"ranks {sorted(set(range(self.world)) - set(out))}"
                               f" gave no answer in {timeout} s")
        if errors:
            self.broken = True
            raise RuntimeError("\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self):
        for q in self.inq:
            q.put(None)
        for p in self.procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_S)
        assert not any(p.is_alive() for p in self.procs)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """``pools(n)``: the module's pool of n ranks (a fresh one after a
    case broke it)."""
    root = str(tmp_path_factory.mktemp("ranks"))
    made = {}

    def get(world):
        if world not in made or made[world].broken:
            if world in made:
                made[world].close()
            made[world] = RankPool(world, tempfile.mkdtemp(dir=root))
        return made[world]

    yield get
    for p in made.values():
        p.close()


# ---------------------------------------------------------------------------
# the JAX side (in the test process only)
# ---------------------------------------------------------------------------

def _jax_mesh(n):
    import jax
    from bigdl_tpu.runtime.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(data=n), devices=jax.devices()[:n])


def _jax_per_device(n, body, *arrays):
    """``body`` under shard_map on an n-device mesh, each array's row r on
    device r; the outputs row r from device r, as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from bigdl_tpu.runtime.mesh import AXIS_DATA, shard_map

    fn = jax.jit(shard_map(lambda *a: body(*[x[0] for x in a])[None],
                           mesh=_jax_mesh(n),
                           in_specs=tuple(P(AXIS_DATA) for _ in arrays),
                           out_specs=P(AXIS_DATA)))
    return np.asarray(fn(*[jnp.asarray(a) for a in arrays]))


# ---------------------------------------------------------------------------
# rank workers (module level: the ranks unpickle them by name)
# ---------------------------------------------------------------------------

def _rs_worker(rank, world, g, mode, block):
    import torch.distributed as dist

    g2d = torch.as_tensor(g[rank]).reshape(world, -1)
    return pc.reduce_scatter_wire(g2d, dist.group.WORLD, mode,
                                  block=block).float().numpy()


def _delta_worker(rank, world, delta, base, block):
    import torch.distributed as dist

    rows = torch.as_tensor(base.copy())
    out = pc.all_gather_delta_quantized(torch.as_tensor(delta[rank]), rows,
                                        dist.group.WORLD, block=block)
    inplace = torch.as_tensor(base.copy())
    pc.all_gather_delta_quantized(torch.as_tensor(delta[rank]), inplace,
                                  dist.group.WORLD, block=block, out=inplace)
    assert torch.equal(out, inplace)
    return out.numpy()


def _gather_worker(rank, world, w):
    import torch.distributed as dist

    flat = torch.zeros(world * w)
    flat[rank * w:(rank + 1) * w] = torch.arange(w) + 100.0 * rank
    pc.all_gather(flat, flat[rank * w:(rank + 1) * w], dist.group.WORLD)
    stacked = torch.empty(world, w)
    pc.all_gather(stacked, torch.arange(w) + 100.0 * rank, dist.group.WORLD)
    return flat.numpy(), stacked.numpy()


def _bad_gather_worker(rank, world):
    import torch.distributed as dist

    out = torch.zeros(world, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pc.all_gather(out[:, :2], torch.zeros(2), dist.group.WORLD)
    return True


# ---------------------------------------------------------------------------
# estimators and buckets (pure layout math: equal exactly)
# ---------------------------------------------------------------------------

BUCKET_GRID = [(1000, 4, None, 4.0, None), (1000, 4, 1600, 4.0, None),
               (1000, 4, 1600, 1.0, 64), (77, 8, 300, 2.0, None),
               (5, 2, 1, 4.0, 1024), (4096, 2, 1 << 12, 1.0, 1024),
               (0, 2, 64, 4.0, None), (333, 3, 999, 4.0, 7)]


@pytest.mark.parametrize("shard,ndev,bucket,wire,block", BUCKET_GRID)
def test_bucket_columns_match_jax(shard, ndev, bucket, wire, block):
    from bigdl_tpu.parallel import collectives as jc

    assert pc.bucket_columns(shard, ndev, bucket, wire, block) == \
        jc.bucket_columns(shard, ndev, bucket, wire, block)


WIRE_GRID = [(w, n, mode, block) for w in (1, 77, 100, 1024, 4099)
             for n in (1, 2, 4, 8) for mode in ("fp32", "bf16", "int8")
             for block in (1, 64, 1024)]


def test_wire_byte_estimators_match_jax():
    from bigdl_tpu.parallel import collectives as jc

    for w, n, mode, block in WIRE_GRID:
        assert pc.rs_wire_bytes(w, n, mode, block) == \
            jc.rs_wire_bytes(w, n, mode, block), (w, n, mode, block)
        if mode != "bf16":
            assert pc.ag_wire_bytes(w, n, mode, block) == \
                jc.ag_wire_bytes(w, n, mode, block), (w, n, mode, block)
        assert pc.wire_itemsize(mode) == jc.wire_itemsize(mode)
    # the JAX file's own spot values
    assert pc.rs_wire_bytes(100, 4, "int8", block=64) == 4 * 128 + 4 * 2 * 4
    assert pc.rs_wire_bytes(77, 8, "int8", block=1024) < \
        pc.rs_wire_bytes(77, 8, "fp32")
    assert pc.ag_wire_bytes(100, 1, "int8") == 0


@pytest.mark.parametrize("n_params,ndev,mode,bucket,block,param_comm", [
    (10_000, 2, "fp32", None, 1024, "fp32"),
    (10_001, 4, "int8", 4096, 64, "int8"),
    (123_457, 8, "bf16", 1 << 16, 1024, "fp32"),
    (999, 3, "int8", None, 1024, "fp32"),
    (110_000_000, 4, "int8", 25 << 20, 1024, "int8"),
])
def test_layout_ledger_matches_jax(n_params, ndev, mode, bucket, block,
                                   param_comm):
    from bigdl_tpu.parallel import collectives as jc

    assert pc.layout_ledger(n_params, ndev, mode=mode, bucket_bytes=bucket,
                            block=block, param_comm=param_comm) == \
        jc.layout_ledger(n_params, ndev, mode=mode, bucket_bytes=bucket,
                         block=block, param_comm=param_comm)


def test_ledger_refuses_bad_modes_and_the_dcn_hop():
    with pytest.raises(ValueError, match="grad_comm"):
        pc.layout_ledger(100, 2, mode="int4")
    with pytest.raises(ValueError, match="param_comm"):
        pc.layout_ledger(100, 2, param_comm="bf16")
    # the DCN hop is ported: the JAX ledger's bytes
    # (tests/test_torch_port_multislice.py holds every mode)
    from bigdl_tpu.parallel import collectives as jc

    assert pc.layout_ledger(100, 2, dcn=2) == jc.layout_ledger(100, 2, dcn=2)
    assert pc.GRAD_COMM_MODES == ("fp32", "bf16", "int8")
    assert pc.PARAM_COMM_MODES == ("fp32", "int8")
    assert pc.DEFAULT_QUANT_BLOCK == 1024


# ---------------------------------------------------------------------------
# the collectives over gloo against the JAX mesh
# ---------------------------------------------------------------------------

def _grads(n, w, seed):
    rs = np.random.RandomState(seed)
    # per-rank rows of very different magnitudes, as gradients have
    g = rs.randn(n, n * w).astype(np.float32)
    return g * np.float32(10.0) ** rs.randint(-3, 2, (n, 1)).astype(
        np.float32)


RS_GRID = [(mode, n, w, block) for mode in ("fp32", "bf16", "int8")
           for n in (2, 4) for w, block in ((96, 32), (70, 16), (5, 1024))]


@pytest.mark.parametrize("mode,n,w,block", RS_GRID)
def test_reduce_scatter_wire_matches_jax(pools, mode, n, w, block):
    import jax.numpy as jnp
    from bigdl_tpu.parallel import collectives as jc
    from bigdl_tpu.runtime.mesh import AXIS_DATA

    g = _grads(n, w, seed=n * 1000 + w)
    got = np.stack(pools(n).run(_rs_worker, g, mode, block))
    want = _jax_per_device(
        n, lambda gl: jc.reduce_scatter_wire(
            gl.reshape(n, w), AXIS_DATA, mode,
            block=block).astype(jnp.float32), g)
    exact = g.sum(0).reshape(n, w)
    assert got.shape == want.shape == (n, w)
    if mode == "fp32":
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif mode == "bf16":
        # each rank's cast and the sum round: one bfloat16 step of the
        # largest addend's binade a rounding
        step = 2.0 ** (np.floor(np.log2(np.abs(g).max(0))) - 7)
        tol = (n + 1) * step.reshape(n, w)
        assert np.all(np.abs(got - want) <= tol)
        assert np.all(np.abs(got - exact) <= tol)
    else:
        # one quantization step a source and block, n sources
        blk = max(1, min(block, w))
        wq = -(-w // blk) * blk
        pad = np.zeros((n, n, wq), np.float32)
        pad[:, :, :w] = g.reshape(n, n, w)
        bmax = np.abs(pad.reshape(n, n, wq // blk, blk)).max(-1)
        step = np.repeat(bmax / 127.0, blk, -1)[..., :w]   # (src, dst, w)
        tol = step.sum(0) + 1e-6
        assert np.all(np.abs(got - exact) <= tol)
        assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("n,w,block", [(2, 96, 32), (4, 70, 16),
                                       (4, 5, 1024), (2, 1000, 64)])
def test_delta_gather_matches_jax_and_replicates(pools, n, w, block):
    from bigdl_tpu.parallel import collectives as jc
    from bigdl_tpu.runtime.mesh import AXIS_DATA

    rs = np.random.RandomState(w)
    base = rs.randn(n, w).astype(np.float32)
    delta = (rs.randn(n, w) * 1e-3).astype(np.float32)
    got = pools(n).run(_delta_worker, delta, base, block)
    # every rank rebuilt the same rows, to the bit
    for r in range(1, n):
        np.testing.assert_array_equal(got[r], got[0])
    want = _jax_per_device(
        n, lambda dl: jc.all_gather_delta_quantized(
            dl, base, AXIS_DATA, block=block), delta)
    blk = max(1, min(block, w))
    wq = -(-w // blk) * blk
    pad = np.zeros((n, wq), np.float32)
    pad[:, :w] = delta
    step = np.repeat(np.abs(pad.reshape(n, -1, blk)).max(-1) / 127.0, blk,
                     -1)[:, :w]
    for r in range(n):
        assert np.all(np.abs(got[0] - want[r]) <= step + 1e-7)
    assert np.all(np.abs(got[0] - (base + delta)) <= step / 2 + 1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_in_place_and_stacked(pools, n):
    w = 7
    for flat, stacked in pools(n).run(_gather_worker, w):
        want = np.concatenate([np.arange(w) + 100.0 * r for r in range(n)])
        np.testing.assert_array_equal(flat, want)
        np.testing.assert_array_equal(stacked.reshape(-1), want)
    assert all(pools(n).run(_bad_gather_worker))
