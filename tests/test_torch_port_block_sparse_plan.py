"""The bfloat16 block-sparse kernel's host side and its summation order,
on the CPU: the column plan's 64-bit row masks, the tile and split plan
(``ops.block_sparse.bf16_plan``), and the kernel's arithmetic emulated
in torch against the JAX package.

The kernel (``csrc/block_sparse_matmul.cu``, namespace ``wg``) sums a
split's run of 64-row chunks of K on the tensor cores in float32: in one
accumulator where the run's chunks all have stages of their own, else
chunk by chunk into a float32 total; it writes the split totals and adds
them in split order before one rounding to bfloat16.  The emulation does
both with float32 torch products.

Tolerance: within one bfloat16 ulp of the larger magnitude, elementwise
(a float32 sum in another order can round to the neighbouring value),
the ulp floored at the float32 sums' own noise, sqrt(K) 2^-24 of the
largest |value|, as the card tests' ``_within_one_bf16_ulp``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops import block_sparse as jbs
from bigdl_tpu.tensor import policy as jpolicy
from bigdl_tpu_torch.ops import block_sparse as tbs
from bigdl_tpu_torch.ops.common import cdiv

BF16 = torch.bfloat16
# the draft FFN's products: a decode step (M = 16) and a prefill call
# (M = 256), l1 (768 -> 3072) and l2 (3072 -> 768)
DRAFT_SHAPES = ((16, 768, 3072), (16, 3072, 768), (256, 768, 3072),
                (256, 3072, 768))


def _within_one_bf16_ulp(got, want, terms):
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=terms ** 0.5 * 2.0 ** -24 * float(want.abs().max()))
    excess = (got - want).abs() - ulp
    assert float(excess.max()) <= 0, (
        f"{int((excess > 0).sum())} elements past one ulp")


def _mask(rs, k, n, blk, density=0.5):
    mask = rs.rand(cdiv(k, blk[0]), cdiv(n, blk[1])) < density
    mask[0, 0] = True
    if mask.shape[1] > 1:
        mask[:, -1] = False     # a column block with no kept block
    return mask


# ---------------------------------------------------------------------------
# the row masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,blk", [(768, 3072, (8, 8)),
                                     (200, 96, (8, 16)),
                                     (130, 93, (12, 6)),
                                     (300, 200, (64, 64)),
                                     (333, 40, (100, 8)),
                                     (64, 8, (8, 8))])
def test_row_masks_equal_the_expanded_mask(k, n, blk):
    """Bit r of [c, j] is set exactly where row 64 c + r of column block j
    is kept in the elementwise mask; rows past K set no bit."""
    rs = np.random.RandomState(k + n)
    mask = _mask(rs, k, n, blk)
    em = tbs.expand_mask(mask, k, n, *blk)          # (k, n)
    nnb = mask.shape[1]
    rows = np.zeros((cdiv(k, 64) * 64, nnb), bool)
    rows[:k] = em[:, np.arange(nnb) * blk[1]]       # a column of each block
    want = np.zeros((cdiv(k, 64), nnb), np.uint64)
    for r in range(rows.shape[0]):
        want[r // 64] |= rows[r].astype(np.uint64) << np.uint64(r % 64)
    plan = tbs.ColumnPlan(mask, *blk)
    got = plan.on(torch.device("cpu"), k, n)[3]
    assert got.dtype == torch.int64
    assert got.shape == (cdiv(k, 64), nnb)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert nnb == 1 or not want[:, -1].any()        # the empty column block
    np.testing.assert_array_equal(tbs.row_masks(mask, k, blk[0]),
                                  got.numpy())


def test_row_masks_are_uploaded_once_per_device_and_shape():
    plan = tbs.ColumnPlan(np.ones((4, 2), bool), 8, 8)
    cpu = torch.device("cpu")
    assert plan.on(cpu, 32, 16)[3] is plan.on(cpu, 32, 16)[3]
    assert plan.on(cpu, 30, 16)[3] is not plan.on(cpu, 32, 16)[3]
    assert plan.on(cpu, 30, 16)[3].numpy().view(np.uint64)[0, 0] == (
        (1 << 30) - 1)


# ---------------------------------------------------------------------------
# the tile and split plan
# ---------------------------------------------------------------------------

def _split_ranges(tp, k):
    nch = cdiv(k, tbs.CHUNK)
    return [(s * tp.chunks_per_split,
             min(nch, (s + 1) * tp.chunks_per_split))
            for s in range(tp.splits)]


@pytest.mark.parametrize("m,k,n", DRAFT_SHAPES + (
    (1, 8, 8), (5, 128, 64), (17, 200, 48), (300, 768, 384),
    (64, 4096, 4096), (1024, 64, 64), (8192, 3072, 768)))
def test_bf16_plan_partitions_k_into_whole_chunks(m, k, n):
    """The splits' runs of chunks cover K's chunks once, none empty, as
    even as whole chunks go; the draft's four products fill 132 SMs."""
    tp = tbs.bf16_plan(m, k, n, 8)
    assert tp.path == "wgmma"
    assert tp.tile_m in (16, 32, 64) and tp.tile_m >= min(m, 64)
    assert tp.tile_m == 16 or tp.tile_m // 2 < min(m, 64)
    covered = [c for lo, hi in _split_ranges(tp, k) for c in range(lo, hi)]
    assert covered == list(range(cdiv(k, 64)))
    assert all(hi > lo for lo, hi in _split_ranges(tp, k))
    sizes = [hi - lo for lo, hi in _split_ranges(tp, k)]
    assert max(sizes) == tp.chunks_per_split
    tiles = cdiv(m, tp.tile_m) * cdiv(n, tbs.TILE_N)
    assert tp.blocks == tiles * tp.splits
    if (m, k, n) in DRAFT_SHAPES:
        assert tp.blocks >= 132
    # splits only where the tiles alone leave SMs idle, and the fewest
    # that fill the card in runs of at most 12 chunks: one fewer would not
    assert tp.splits == 1 or tiles < tbs.SMS
    if tp.splits > 1:
        nch = cdiv(k, 64)
        fewer = cdiv(nch, tp.splits - 1)
        assert (tiles * cdiv(nch, fewer) < tbs.SMS
                or fewer > tbs.MAX_CHUNKS)
        assert tp.splits <= tbs.MAX_SPLITS


@pytest.mark.parametrize("m,k,n,bn,aligned", [(16, 770, 384, 8, True),
                                              (16, 768, 388, 4, True),
                                              (16, 768, 3072, 12, True),
                                              (16, 768, 3072, 8, False),
                                              (16, 0, 64, 8, True)])
def test_bf16_plan_leaves_other_shapes_to_the_mma_sync_kernel(m, k, n, bn,
                                                              aligned):
    tp = tbs.bf16_plan(m, k, n, bn, aligned)
    assert tp.path == "mma_sync" and tp.tile_m == 0


# ---------------------------------------------------------------------------
# the summation order against the JAX package
# ---------------------------------------------------------------------------

def emulate(x, w, mask, blk, tp, by_chunk):
    """The kernel's arithmetic on bfloat16 operands: per split, the float32
    sum of its rows (``by_chunk``: of each 64-row chunk's product, added
    into a float32 total); the split totals added in split order, rounded
    once to bfloat16."""
    k, n = w.shape
    em = torch.from_numpy(tbs.expand_mask(mask, k, n, *blk))
    wm = torch.where(em, w.float(), 0.0)
    xf = x.float()
    out = None
    for lo, hi in _split_ranges(tp, k):
        runs = ([(c, c + 1) for c in range(lo, hi)] if by_chunk
                else [(lo, hi)])
        total = torch.zeros(x.shape[0], n)
        for a, b in runs:
            rows = slice(64 * a, min(k, 64 * b))
            total = total + xf[:, rows] @ wm[rows]
        out = total if out is None else out + total
    return out.to(BF16)


def _operands(seed, m, k, n, blk):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32)
    w = rs.randn(k, n).astype(np.float32)
    return x, w, _mask(rs, k, n, blk)


@pytest.mark.parametrize("by_chunk", [False, True])
@pytest.mark.parametrize("m,k,n,blk,sms", [(16, 256, 64, (8, 8), 4),
                                           (20, 320, 128, (16, 8), 8),
                                           (8, 192, 64, (8, 16), 3)])
def test_split_sums_against_the_interpret_mode_pallas_kernel(m, k, n, blk,
                                                             sms, by_chunk):
    """Small shapes split into several runs (a card of ``sms`` SMs)
    against the Pallas kernel in interpret mode on the same bfloat16
    operands."""
    x, w, mask = _operands(21, m, k, n, blk)
    tp = tbs.bf16_plan(m, k, n, blk[1], sms=sms)
    assert tp.splits > 1
    want = jbs.block_sparse_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), mask,
        block_k=blk[0], block_n=blk[1], block_m=8, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = emulate(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                  mask, blk, tp, by_chunk)
    _within_one_bf16_ulp(got.float().numpy(),
                         np.asarray(want.astype(jnp.float32)), k)


@pytest.mark.parametrize("by_chunk", [False, True])
@pytest.mark.parametrize("m,k,n", [(16, 3072, 768), (256, 768, 3072)])
def test_split_sums_against_the_jax_masked_dense_product(m, k, n, by_chunk):
    """The draft's products at (8, 8) blocks, half kept, with the plan the
    card takes, against the JAX module's masked dense product
    (``BlockSparseLinear`` with ``use_kernel=False``) on bfloat16
    operands."""
    blk = (8, 8)
    x, w, mask = _operands(22, m, k, n, blk)
    jl = jbs.BlockSparseLinear(k, n, block_shape=blk, with_bias=False,
                               use_kernel=False)
    jl.mask = mask
    with jpolicy.compute_dtype(jnp.bfloat16):
        want = jl.forward({"weight": jnp.asarray(w)}, {},
                          jnp.asarray(x, jnp.bfloat16))[0]
    assert want.dtype == jnp.bfloat16
    tp = tbs.bf16_plan(m, k, n, blk[1])
    got = emulate(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                  mask, blk, tp, by_chunk)
    _within_one_bf16_ulp(got.float().numpy(),
                         np.asarray(want.astype(jnp.float32)), k)
