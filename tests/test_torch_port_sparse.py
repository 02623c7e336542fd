"""The port's block-sparse FFN pieces (bigdl_tpu_torch.ops.block_sparse)
against the JAX package: the block-sparse product and its gradients, the
column plan, magnitude block pruning, the draft masks, the pruning
schedule and ``Transformer(ffn_sparsity=...)``.

The CUDA kernel runs only on the card (``tests/test_torch_port_cuda.py``
and ``chip_smoke.py`` hold it against its plain version there).  Here
the plain version, the path a CPU tensor takes, is held against the
Pallas kernel in interpret mode and its VJP within 1e-5 (float32 sums in
another order); masks and plans must be equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.ops import block_sparse as jbs
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.ops import block_sparse as bs
from bigdl_tpu_torch.utils import load_jax_params


@pytest.mark.parametrize("m,k,n,blk", [(5, 24, 40, (8, 8)),
                                       (7, 20, 36, (8, 16)),
                                       (3, 64, 16, (16, 8))])
def test_plain_product_and_grads_match_jax_kernel(m, k, n, blk):
    rs = np.random.RandomState(0)
    x = rs.randn(m, k).astype(np.float32)
    w = rs.randn(k, n).astype(np.float32)
    g = rs.randn(m, n).astype(np.float32)
    mask = rs.rand(-(-k // blk[0]), -(-n // blk[1])) < 0.5
    mask[0, 0] = True

    def jfn(xx, ww):
        return jbs.block_sparse_matmul(xx, ww, mask, block_k=blk[0],
                                       block_n=blk[1], block_m=8,
                                       interpret=True)

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    wdx, wdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    before = dict(LAUNCHES)
    got = bs.block_sparse_matmul(xt, wt, mask, block_k=blk[0],
                                 block_n=blk[1])
    got.backward(torch.from_numpy(g))
    assert dict(LAUNCHES) == before            # the CPU takes the plain one
    for a, b in ((got.detach(), want), (xt.grad, wdx), (wt.grad, wdw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # a leading batch shape, and a prepared plan, give the same product
    plan = bs.ColumnPlan(mask, *blk)
    x3 = torch.from_numpy(x).reshape(1, m, k)
    assert torch.allclose(bs.block_sparse_matmul(x3, wt, plan=plan)[0],
                          got, rtol=0, atol=1e-6)


def test_column_plan_and_expand_mask_equal_jax():
    rs = np.random.RandomState(1)
    mask = rs.rand(6, 9) < 0.4
    mask[:, 3] = False                         # an empty column block
    counts, idx = bs._column_plan(mask)
    jc, ji = jbs._column_plan(mask)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(bs.expand_mask(mask, 45, 70, 8, 8),
                                  jbs.expand_mask(mask, 45, 70, 8, 8))
    plan = bs.ColumnPlan(mask, 8, 8)
    tc, _ = bs._column_plan(mask.T)
    np.testing.assert_array_equal(plan.transposed().counts, tc)
    assert bs.StaticMask(mask) == bs.StaticMask(mask.copy())
    assert hash(bs.StaticMask(mask)) == hash(jbs.StaticMask(mask))
    with pytest.raises(ValueError, match="does not tile"):
        bs.block_sparse_matmul(torch.zeros(2, 40), torch.zeros(40, 70),
                               mask, block_k=8, block_n=8)


@pytest.mark.parametrize("sparsity", [0.25, 0.5, 0.9])
def test_prune_to_masks_equal_jax(sparsity):
    rs = np.random.RandomState(2)
    w = rs.randn(40, 24).astype(np.float32)
    jl = jbs.BlockSparseLinear(40, 24, block_shape=(8, 8))
    jl.mask = np.ones((5, 3), bool)
    tl = bs.BlockSparseLinear(40, 24, block_shape=(8, 8))
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    # two events: the second prunes only among the blocks kept
    for s in (sparsity / 2, sparsity):
        want = jl.prune_to({"weight": jnp.asarray(w)}, s)
        got = tl.prune_to(s)
        assert got == want
        np.testing.assert_array_equal(tl.mask, jl.mask)
    assert tl.prune_to(sparsity / 2) == tl.sparsity()     # monotone
    with pytest.raises(ValueError, match="expected"):
        tl.set_mask(np.ones((2, 2), bool))


@pytest.fixture(scope="module")
def lm():
    model = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                           num_layers=2, dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    return params


def test_sparse_transformer_masks_and_logits_match_jax(lm):
    """``Transformer(ffn_sparsity=0.5)`` with masks derived from the same
    weights: masks equal to JAX's ``derive_draft_masks`` and logits within
    1e-5 of the JAX forward (its masked path, the same function as its
    interpret-mode kernel above)."""
    params = lm
    jm = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                        num_layers=2, dropout=0.0, mode="lm",
                        ffn_sparsity=0.5, sparse_block=(8, 8))
    jbs.derive_draft_masks(jm, params, 0.5)
    for _, mod in jbs.iter_sparse_modules(jm):
        mod.use_kernel = False
    tm = load_jax_params(Transformer(32, 16, 2, num_layers=2, dropout=0.0,
                                     ffn_sparsity=0.5, sparse_block=(8, 8)),
                         params)
    # dense until masked: exactly the dense model's logits
    dense = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                        dropout=0.0), params)
    ids = np.random.RandomState(4).randint(0, 32, (2, 9)).astype(np.int32)
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(ids)),
                           dense(torch.from_numpy(ids)))
    got_sp = bs.derive_draft_masks(tm, 0.5)
    assert sorted(got_sp) == ["decoder.0.ffn.l1", "decoder.0.ffn.l2",
                              "decoder.1.ffn.l1", "decoder.1.ffn.l2"]
    for (_, jmod), (_, tmod) in zip(jbs.iter_sparse_modules(jm),
                                    bs.iter_sparse_modules(tm)):
        np.testing.assert_array_equal(tmod.mask, jmod.mask)
        assert 0.4 <= tmod.sparsity() <= 0.6
    want = np.asarray(jm.forward(params, {}, jnp.asarray(ids))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    masks = bs.collect_masks(tm)
    twin = Transformer(32, 16, 2, num_layers=2, dropout=0.0,
                       ffn_sparsity=0.5, sparse_block=(8, 8))
    assert bs.apply_masks(twin, masks) == 4
    assert all(np.array_equal(a.mask, b.mask) for (_, a), (_, b) in zip(
        bs.iter_sparse_modules(twin), bs.iter_sparse_modules(tm)))


def test_prune_model_to_sparsity_respects_targets():
    m = Transformer(32, 16, 2, num_layers=2, dropout=0.0, ffn_sparsity=0.25,
                    sparse_block=(8, 8))
    out = bs.prune_model_to_sparsity(m, 0.75)
    assert len(out) == 4 and all(v == pytest.approx(0.25, abs=0.07)
                                 for v in out.values())


@pytest.mark.parametrize("target,warm,ramp,events", [(0.5, 10, 40, 4),
                                                      (0.9, 0, 0, 1),
                                                      (0.0, 5, 5, 2),
                                                      (0.75, 3, 17, 3)])
def test_pruning_schedule_equal_jax(target, warm, ramp, events):
    j = jbs.BlockPruningSchedule(target, warm, ramp, events)
    t = bs.BlockPruningSchedule(target, warm, ramp, events)
    assert [t.sparsity_at(s) for s in range(60)] == \
        [j.sparsity_at(s) for s in range(60)]
    assert t.prune_steps() == j.prune_steps()
    with pytest.raises(ValueError):
        bs.BlockPruningSchedule(1.0, 0, 0)
