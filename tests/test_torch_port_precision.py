"""The mixed-precision policy (``tensor.policy``): the port under
``compute_dtype(torch.bfloat16)`` against the JAX package under
``bigdl_tpu.tensor.policy.compute_dtype(jnp.bfloat16)``, on the same
numpy inputs, at small widths.

Tolerances:
- products with a float32 result (Linear, the attention products, the
  projections): 1e-5 relative to the largest |value| (measured 3.6e-7:
  float32 sums of the same bfloat16 operands in another order);
- bfloat16-rounded results (convs, the block-sparse product, every
  gradient of a product, each rounded to its operand's dtype): within
  one bfloat16 ulp of the larger magnitude, elementwise (a float32 sum in
  another order can round to the neighbouring value);
- a forward through bfloat16-rounded layers (the LM's logits): 2^-8 of
  the largest |logit| a layer, the rounding step of one bfloat16
  operand for each layer it passes;
- losses over 3 training steps: 1e-4 relative, as ROADMAP C.14 holds
  ResNet; a gap past that is a fault, not rounding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.ops import block_sparse as jbs
from bigdl_tpu.tensor import policy as jpolicy
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.nn.attention import dot_product_attention
from bigdl_tpu_torch.ops import block_sparse as tbs
from bigdl_tpu_torch.tensor import policy
from bigdl_tpu_torch.utils import load_jax_params

PRODUCT_RTOL = 1e-5
LOSS_RTOL = 1e-4
BF16 = torch.bfloat16


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32), np.float32)


def assert_product_close(got, want):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= PRODUCT_RTOL, err


def assert_within_one_ulp(got, want):
    """Elementwise within one bfloat16 step of the larger magnitude (8
    significant bits: 2^(floor(log2 |v|) - 7))."""
    got, want = _np(got), _np(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements past one "
                           f"bf16 ulp, worst "
                           f"{np.abs(got - want)[bad].max()}")


@pytest.fixture
def bf16():
    with jpolicy.compute_dtype(jnp.bfloat16), \
            policy.compute_dtype(torch.bfloat16):
        yield


def _rs(seed=0):
    return np.random.RandomState(seed)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def test_per_device_default_and_context_restore():
    assert policy.get_compute_dtype() == torch.float32
    assert policy.get_compute_dtype(torch.device("cpu")) == torch.float32
    assert policy.get_compute_dtype("cuda") == BF16
    assert policy.get_compute_dtype(torch.device("cuda", 0)) == BF16
    with policy.compute_dtype(torch.float32):
        assert policy.get_compute_dtype("cuda") == torch.float32
        with policy.compute_dtype("bfloat16"):
            assert policy.get_compute_dtype("cpu") == BF16
            assert policy.cast_compute(torch.ones(2)).dtype == BF16
        assert policy.get_compute_dtype("cpu") == torch.float32
    # back to the per-device default, as JAX's context restores its own
    assert policy.get_compute_dtype("cuda") == BF16
    assert policy._COMPUTE_DTYPE[0] is None
    before = jpolicy.get_compute_dtype()
    with jpolicy.compute_dtype(jnp.bfloat16):
        assert jpolicy.get_compute_dtype() == jnp.bfloat16
    assert jpolicy.get_compute_dtype() == before
    policy.set_compute_dtype(BF16)
    try:
        assert policy.get_compute_dtype("cpu") == BF16
    finally:
        policy.set_compute_dtype(None)
    assert policy.get_compute_dtype("cpu") == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        policy.set_compute_dtype(torch.float16)


def test_f32_policy_keeps_the_float32_product():
    """Under float32 matmul_f32 is torch.matmul itself, to the bit."""
    rs = _rs(1)
    x = torch.from_numpy(rs.randn(5, 7, 12).astype(np.float32))
    w = torch.from_numpy(rs.randn(12, 9).astype(np.float32))
    assert torch.equal(policy.matmul_f32(x, w), torch.matmul(x, w))


def test_matmul_promote_is_the_float32_product_of_the_rounded_weight(bf16):
    rs = _rs(2)
    a = rs.randn(6, 16).astype(np.float32)
    w = rs.randn(16, 8).astype(np.float32)
    want = jnp.matmul(jnp.asarray(a), jpolicy.cast_compute(jnp.asarray(w)),
                      preferred_element_type=jnp.float32)
    got = policy.matmul_promote(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert_product_close(got, want)


# ---------------------------------------------------------------------------
# layers: forward, dx and dw
# ---------------------------------------------------------------------------

def _vjp_case(jfwd, tmod, x, g, w_name="weight"):
    """JAX's output and (dx, dw) against the port module's."""
    jp = {k: jnp.asarray(_np(v)) for k, v in tmod.named_parameters()}
    y, vjp = jax.vjp(lambda xx, pp: jfwd(pp, xx), jnp.asarray(x), jp)
    dx, dp = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tmod(xt)
    yt.backward(torch.from_numpy(g))
    return (yt, y), (xt.grad, dx), (getattr(tmod, w_name).grad, dp[w_name])


def test_linear_forward_dx_dw(bf16):
    rs = _rs(3)
    tl = tnn.Linear(48, 40, generator=torch.Generator().manual_seed(0))
    jl = jnn.Linear(48, 40)
    x = rs.randn(2, 16, 48).astype(np.float32)
    g = rs.randn(2, 16, 40).astype(np.float32)
    (y, wy), (dx, wdx), (dw, wdw) = _vjp_case(
        lambda p, xx: jl.forward(p, {}, xx)[0], tl, x, g)
    assert y.dtype == torch.float32
    assert_product_close(y, wy)
    assert_within_one_ulp(dx, wdx)
    assert_within_one_ulp(dw, wdw)


@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_forward_dx_dw(bf16, bias):
    rs = _rs(4)
    tc = tnn.Conv2D(6, 8, 3, stride=2, padding="SAME", with_bias=bias,
                    generator=torch.Generator().manual_seed(1))
    jc = jnn.Conv2D(6, 8, 3, stride=2, padding="SAME", with_bias=bias)
    x = rs.randn(2, 9, 9, 6).astype(np.float32)
    g = rs.randn(2, 5, 5, 8).astype(np.float32)
    (y, wy), (dx, wdx), (dw, wdw) = _vjp_case(
        lambda p, xx: jc.forward(p, {}, xx)[0], tc, x, g)
    assert_within_one_ulp(y, wy)
    assert_within_one_ulp(dx, wdx)
    assert_within_one_ulp(dw, wdw)


def test_conv1d_forward_dx_dw(bf16):
    rs = _rs(5)
    tc = tnn.Conv1D(5, 7, 3, dilation=2, causal=True,
                    generator=torch.Generator().manual_seed(2))
    jc = jnn.Conv1D(5, 7, 3, dilation=2, causal=True)
    x = rs.randn(3, 11, 5).astype(np.float32)
    g = rs.randn(3, 11, 7).astype(np.float32)
    (y, wy), (dx, wdx), (dw, wdw) = _vjp_case(
        lambda p, xx: jc.forward(p, {}, xx)[0], tc, x, g)
    assert_within_one_ulp(y, wy)
    assert_within_one_ulp(dx, wdx)
    assert_within_one_ulp(dw, wdw)


# ---------------------------------------------------------------------------
# attention and the LM
# ---------------------------------------------------------------------------

def test_plain_attention_forward_and_grads(bf16):
    rs = _rs(6)
    q, k, v = (rs.randn(2, 3, 10, 8).astype(np.float32) for _ in range(3))
    g = rs.randn(2, 3, 10, 8).astype(np.float32)
    mask = np.tril(np.ones((10, 10), bool))
    want, vjp = jax.vjp(
        lambda a, b, c: jattn.dot_product_attention(a, b, c,
                                                    mask=jnp.asarray(mask)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wgrads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = dot_product_attention(*ts, mask=torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert_product_close(got, want)
    for t, w in zip(ts, wgrads):
        # each gradient leaves a product rounded to bf16, then float32
        # softmax arithmetic: within one bf16 step of its largest value
        err = np.abs(_np(t.grad) - _np(w)).max()
        assert err <= 2.0 ** -7 * np.abs(_np(w)).max(), err


def test_mha_projections(bf16):
    rs = _rs(7)
    jm = jattn.MultiHeadAttention(32, 4, causal=True, use_flash=False)
    x = rs.randn(2, 12, 32).astype(np.float32)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(0), x[:1])["params"])
    tm = load_jax_params(tnn.MultiHeadAttention(32, 4, causal=True,
                                                use_flash=False), params)
    from bigdl_tpu_torch.nn.attention import _attn_project
    xt = torch.from_numpy(x)
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"), ("wo", "bo")):
        want = jattn._attn_project(params, jnp.asarray(x), w, b)
        assert_product_close(_attn_project(tm, xt, w, b), want)
    want = jm.forward(params, {}, jnp.asarray(x))[0]
    with torch.no_grad():
        got = tm(xt)
    # two products whose inputs are rounded to bf16 after float32 work
    # (softmax, the merge): one bf16 step of the largest |value| each
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= 2 * 2.0 ** -8 * np.abs(_np(want)).max(), err


LM = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
          ffn_size=64, dropout=0.0)


@pytest.fixture(scope="module")
def lm_params():
    jm = jattn.Transformer(**LM, mode="lm")
    v = jm.init(jax.random.PRNGKey(3), np.zeros((1, 6), np.int32))
    return jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      v["params"])


def test_lm_forward(bf16, lm_params):
    jm, params = lm_params
    ids = _rs(8).randint(0, 64, (2, 12)).astype(np.int32)
    want = jm.forward(params, {}, jnp.asarray(ids))[0]
    tm = load_jax_params(tnn.Transformer(**LM), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= LM["num_layers"] * 2.0 ** -8 * np.abs(_np(want)).max(), \
        err


def test_lm_three_step_trajectory(bf16, lm_params):
    """3 SGD steps of the LM from the same weights: the losses within
    1e-4 relative, and the trained logits as ``test_lm_forward``."""
    jm, params = lm_params
    rs = _rs(9)
    ids = rs.randint(0, 64, (3, 4, 12)).astype(np.int32)
    tgt = rs.randint(0, 64, (3, 4, 12)).astype(np.int32)
    lr = 0.5
    crit = jcrit.CrossEntropyCriterion()

    @jax.jit
    def jstep(p, x, y):
        loss, g = jax.value_and_grad(
            lambda pp: crit(jm.forward(pp, {}, x)[0], y))(p)
        return loss, jax.tree_util.tree_map(lambda a, b: a - lr * b, p, g)

    jp, want = jax.tree_util.tree_map(jnp.asarray, params), []
    for i in range(3):
        loss, jp = jstep(jp, jnp.asarray(ids[i]), jnp.asarray(tgt[i]))
        want.append(float(loss))

    tm = load_jax_params(tnn.Transformer(**LM), params)
    tcrit = tnn.CrossEntropyCriterion()
    got = []
    for i in range(3):
        tm.zero_grad()
        loss = tcrit(tm(torch.from_numpy(ids[i])),
                     torch.from_numpy(tgt[i]))
        loss.backward()
        with torch.no_grad():
            for p in tm.parameters():
                p -= lr * p.grad
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# weight-only int8 and block-sparse
# ---------------------------------------------------------------------------

def test_weight_only_linear(bf16):
    rs = _rs(10)
    w = rs.randn(24, 16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    jl = jnn.Linear(24, 16)
    jmod, jp = jq.WeightOnlyLinear.from_linear(
        jl, {"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    tl = tnn.Linear(24, 16)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    tmod = tq.WeightOnlyLinear.from_linear(tl)
    np.testing.assert_array_equal(tmod.weight_q.numpy(),
                                  np.asarray(jp["weight_q"]))
    x = rs.randn(3, 24).astype(np.float32)
    # the dequantized weight: int8 times the scale, rounded once in bf16
    assert_within_one_ulp(
        tq._weight_only(tmod.weight_q, tmod.scales),
        jp["weight_q"].astype(jnp.bfloat16) * jp["scales"].astype(
            jnp.bfloat16))
    want = jmod.forward(jp, {}, jnp.asarray(x))[0]
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_product_close(got, want)


@pytest.mark.parametrize("m,k,n,blk", [(16, 64, 48, (8, 8)),
                                       (20, 40, 24, (16, 8))])
def test_block_sparse_plain_bf16_against_the_pallas_kernel(m, k, n, blk):
    """The plain version on bfloat16 operands against the Pallas kernel
    run in interpret mode on the same bfloat16 operands: both a float32
    sum written as bfloat16."""
    rs = _rs(11)
    x = rs.randn(m, k).astype(np.float32)
    w = rs.randn(k, n).astype(np.float32)
    mask = rs.rand(-(-k // blk[0]), -(-n // blk[1])) < 0.5
    mask[0, 0] = True
    want = jbs.block_sparse_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), mask,
        block_k=blk[0], block_n=blk[1], block_m=8, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tbs.block_sparse_matmul(torch.from_numpy(x).to(BF16),
                                  torch.from_numpy(w).to(BF16), mask,
                                  block_k=blk[0], block_n=blk[1])
    assert got.dtype == BF16
    assert_within_one_ulp(got, want)
    with pytest.raises(ValueError, match="one dtype"):
        tbs.block_sparse_matmul(torch.from_numpy(x).to(BF16),
                                torch.from_numpy(w), mask,
                                block_k=blk[0], block_n=blk[1])


def test_block_sparse_linear_forward_dx_dw(bf16):
    """``BlockSparseLinear`` with a pruned mask: the bf16 product through
    the interpret-mode Pallas kernel and its VJP (dx the float32 kernel
    on the transposed plan, dw dense and masked, each rounded to bf16)
    against the port's."""
    rs = _rs(12)
    tl = tbs.BlockSparseLinear(40, 24, block_shape=(8, 8),
                               generator=torch.Generator().manual_seed(5))
    tl.prune_to(0.5)
    jl = jbs.BlockSparseLinear(40, 24, block_shape=(8, 8))
    jl.mask = tl.mask.copy()
    x = rs.randn(6, 40).astype(np.float32)
    g = rs.randn(6, 24).astype(np.float32)

    (y, wy), (dx, wdx), (dw, wdw) = _vjp_case(
        lambda p, xx: jl.forward(p, {}, xx)[0], tl, x, g)
    # the bf16 product then the float32 bias: one bf16 step of the product
    assert_within_one_ulp(y - tl.bias, wy - jnp.asarray(_np(tl.bias)))
    assert_within_one_ulp(dx, wdx)
    assert_within_one_ulp(dw, wdw)
    assert (dw.reshape(5, 8, 3, 8).abs().sum((1, 3)) > 0).numpy().tolist() \
        == tl.mask.tolist()
