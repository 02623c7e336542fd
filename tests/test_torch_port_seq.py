"""Sequence parallelism of the port against the JAX package: ring and
Ulysses attention (``parallel/ring_attention.py``,
``parallel/ulysses.py``) forward and gradients on 4 ranks, the JAX
validation errors, ``PositionalEncoding``'s global offsets under a bound
``seq`` axis (``runtime.mesh.seq_axis``).  Training on the ``seq`` axis
is in ``test_torch_port_seq_train.py``.

Ranks are gloo processes (``test_torch_port_collectives.RankPool``);
rank ``r`` holds JAX device ``r``'s block.  JAX runs in the test process
only.  Tolerance: 2e-5, the JAX ring test's bound."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.runtime import mesh as mesh_mod
from test_torch_port_collectives import pools  # noqa: F401 (fixture)

SEED = 5
ATOL = 2e-5


def _qkvg(b=2, h=4, L=32, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, L, d).astype(np.float32) for _ in range(4)]


# ---------------------------------------------------------------------------
# ring and Ulysses attention against JAX's, 4 ranks, seq = 4
# ---------------------------------------------------------------------------

def _jax_attention(strategy, causal, q, k, v, g):
    import jax
    from bigdl_tpu.parallel.ring_attention import ring_attention_sharded
    from bigdl_tpu.parallel.ulysses import ulysses_attention_sharded
    from bigdl_tpu.runtime.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(data=1, seq=4), devices=jax.devices()[:4])
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[strategy]

    @jax.jit
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(lambda *a: fn(mesh, *a, causal=causal), q, k, v)
        return (out, *vjp(g))

    return [np.asarray(a) for a in out_and_grads(q, k, v, g)]


def _port_attention(rank, world, strategy, causal, q, k, v, g):
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import ring_attention, ulysses_attention

    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[strategy]
    c = q.shape[2] // world
    blk = [torch.as_tensor(a[:, :, rank * c:(rank + 1) * c]).clone()
           .requires_grad_() for a in (q, k, v)]
    out = fn(*blk, group=dist.group.WORLD, causal=causal)
    out.backward(torch.as_tensor(g[:, :, rank * c:(rank + 1) * c]))
    return [out.detach().numpy()] + [t.grad.numpy() for t in blk]


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_and_gradients_match_jax(pools, strategy, causal):
    q, k, v, g = _qkvg()
    want = _jax_attention(strategy, causal, q, k, v, g)
    got = pools(4).run(_port_attention, strategy, causal, q, k, v, g)
    c = q.shape[2] // 4
    for r, blocks in enumerate(got):
        for name, a, w in zip(("out", "dq", "dk", "dv"), blocks, want):
            np.testing.assert_allclose(a, w[:, :, r * c:(r + 1) * c],
                                       rtol=ATOL, atol=ATOL,
                                       err_msg=f"{name} rank {r}")


def _port_refusals(rank, world):
    import torch.distributed as dist

    from bigdl_tpu_torch.optim.train_step import ShardedParameterStep
    from bigdl_tpu_torch.parallel import ulysses_attention

    out = {}
    q = torch.zeros(1, 3, 4, 8)
    try:
        ulysses_attention(q, q, q, group=dist.group.WORLD)
    except ValueError as e:
        out["heads"] = str(e)
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(data=2, seq=2))
    model = nn.Sequential([nn.Linear(8, 16),
                           nn.TransformerLayer(16, 4, dropout=0.0),
                           nn.Linear(16, 8)])
    try:
        ShardedParameterStep(model, nn.MSECriterion(), optim.SGD(0.1),
                             mesh, seq_parallel=True)
    except ValueError as e:
        out["plain"] = str(e)
    seq_model = nn.Sequential([
        nn.TransformerLayer(16, 4, dropout=0.0, seq_parallel="ring")])
    st = ShardedParameterStep(seq_model, nn.MSECriterion(), optim.SGD(0.1),
                              mesh, seq_parallel=True)
    x = torch.zeros(2, 8, 16)
    try:
        st.measure_overlap(x, x)
    except NotImplementedError as e:
        out["audit"] = str(e)
    return out


def test_jax_validation_errors(pools):
    """JAX's refusals: a bad ``seq_parallel``, a seq axis of 1, a model
    without sequence-parallel attention, heads the axis does not divide,
    and the overlap audit under ``seq_parallel``; a mask, a context or
    attention dropout inside a bound axis."""
    with pytest.raises(ValueError, match="seq_parallel"):
        nn.MultiHeadAttention(16, 4, seq_parallel="rings")
    from bigdl_tpu_torch.optim.train_step import ShardedParameterStep

    one = mesh_mod.build_mesh(mesh_mod.MeshSpec())
    with pytest.raises(ValueError, match="seq axis"):
        ShardedParameterStep(nn.Linear(4, 4), nn.MSECriterion(),
                             optim.SGD(0.1), one, seq_parallel=True)
    mha = nn.MultiHeadAttention(16, 4, seq_parallel="ring", attn_dropout=0.1)
    x = torch.zeros(1, 4, 16)
    with mesh_mod.seq_axis(None, 0, 1):
        for kw in (dict(mask=torch.ones(4, 4, dtype=torch.bool)),
                   dict(context=x)):
            mha.eval()
            with pytest.raises(ValueError, match="no extra mask"):
                mha(x, **kw)
        mha.train()
        with pytest.raises(ValueError, match="no attention dropout"):
            mha(x)
    r0 = pools(4).run(_port_refusals)[0]
    assert "divisible by the seq axis (4)" in r0["heads"]
    assert "sequence-parallel-aware" in r0["plain"]
    assert "seq_parallel" in r0["audit"]


def test_positional_encoding_global_offsets():
    """Under a bound seq axis each block gets its global positions: the
    blocks together equal the JAX layer on the whole sequence; outside
    one the port's layer starts at 0, as the JAX one does."""
    import jax.numpy as jnp
    from bigdl_tpu.nn.attention import PositionalEncoding as JPE

    x = np.random.RandomState(7).randn(2, 32, 12).astype(np.float32)
    want, _ = JPE().forward({}, {}, jnp.asarray(x))
    layer = nn.PositionalEncoding()
    blocks = []
    for i in range(4):
        with mesh_mod.seq_axis(None, i, 4):
            blocks.append(layer(torch.as_tensor(x[:, 8 * i:8 * (i + 1)])))
    np.testing.assert_allclose(torch.cat(blocks, 1).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(layer(torch.as_tensor(x)).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    assert nn.Attention is nn.MultiHeadAttention
    assert nn.FeedForwardNetwork is nn.PositionwiseFFN
