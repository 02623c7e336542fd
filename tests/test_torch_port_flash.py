"""Port flash attention (bigdl_tpu_torch.ops.flash_attention) against the
JAX package.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds them
against their plain versions there, as does
``tests/test_torch_port_cuda.py`` at small shapes.  Here the plain
versions — the path a CPU tensor takes through the wrappers — are held
against the JAX Pallas kernel in interpret mode (forward: out and lse)
and against ``jax.grad`` through its custom VJP (backward), on the same
numpy inputs.  Tolerance: float32 sums in another order (the JAX kernel
walks 16-key blocks with an online softmax), atol 2e-5 on unit-normal
inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from bigdl_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from bigdl_tpu_torch.nn import MultiHeadAttention
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.ops import (LAUNCHES, flash_attention,
                                 flash_attention_bwd, flash_attention_bwd_ref,
                                 flash_attention_fwd, flash_attention_fwd_ref)
from bigdl_tpu_torch.ops.flash_attention import _FlashAttention
from bigdl_tpu_torch.utils import load_jax_params

ATOL = 2e-5
BLOCK = 16

# (causal, sq, skv, head_dim): square, sq != skv both ways, a ragged
# length (40 over blocks of 16), head_dim 8 and 16
CASES = [(False, 32, 32, 8), (True, 32, 32, 8), (True, 40, 40, 16),
         (False, 24, 40, 16), (True, 24, 40, 8), (True, 40, 24, 16)]


def _qkv(sq, skv, d, b=2, h=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, sq, d).astype(np.float32),
            rs.randn(b, h, skv, d).astype(np.float32),
            rs.randn(b, h, skv, d).astype(np.float32),
            rs.randn(b, h, sq, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("causal,sq,skv,d", CASES)
def test_plain_forward_matches_jax_kernel(causal, sq, skv, d):
    q, k, v, _ = _qkv(sq, skv, d)
    scale = d ** -0.5
    want_o, want_l = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale, causal, BLOCK,
                                   BLOCK, True)
    got_o, got_l = flash_attention_fwd_ref(*_t(q, k, v), causal=causal,
                                           sm_scale=scale)
    assert tuple(got_l.shape) == (2, 3, sq)
    _close(got_o, want_o)
    _close(got_l, want_l)


@pytest.mark.parametrize("causal,sq,skv,d", CASES)
def test_plain_backward_matches_jax_vjp(causal, sq, skv, d):
    q, k, v, g = _qkv(sq, skv, d, seed=1)

    def loss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, causal=causal, block_q=BLOCK,
                                block_k=BLOCK, interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                       sm_scale=d ** -0.5)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, causal=causal,
                                  sm_scale=d ** -0.5)
    for a, b in zip(got, want):
        _close(a, b)
    # and through autograd, the path MultiHeadAttention takes
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    (flash_attention(tq, tk, tv, causal=causal) * tg).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        _close(a, b)


@pytest.mark.parametrize("causal,sq,skv", [(False, 12, 9), (True, 12, 12),
                                           (True, 9, 12)])
def test_gradcheck_float64(causal, sq, skv):
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, n, 4)).requires_grad_()
               for n in (sq, skv, skv))
    assert torch.autograd.gradcheck(
        lambda a, b, c: _FlashAttention.apply(a, b, c, causal, 0.7),
        (q, k, v))


def test_wrappers_on_cpu_take_plain_versions_without_launches():
    q, k, v, g = _t(*_qkv(20, 20, 8, seed=3))
    before = dict(LAUNCHES)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    ref_o, ref_l = flash_attention_fwd_ref(q, k, v, causal=True,
                                           sm_scale=8 ** -0.5)
    assert torch.equal(out, ref_o) and torch.equal(lse, ref_l)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    want = flash_attention_bwd_ref(q, k, v, out, lse, g, causal=True,
                                   sm_scale=8 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(LAUNCHES) == before


def test_wrapper_checks():
    q, k, v, g = _t(*_qkv(8, 8, 8))
    with pytest.raises(ValueError, match="batch, heads, seq"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[:, :2], v)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k, v[..., :4])
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[..., :4], g)


def _mha_pair(use_flash, d=32, heads=4, seed=0):
    jm = jattn.MultiHeadAttention(d, heads, causal=True)
    x = np.random.RandomState(seed).randn(2, 24, d).astype(np.float32)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jm.init(jax.random.PRNGKey(seed),
                                       x)["params"])
    tm = load_jax_params(MultiHeadAttention(d, heads, causal=True,
                                            use_flash=use_flash), p)
    return tm.train(True), torch.from_numpy(x), jm.forward(p, {}, x)[0]


def test_mha_use_flash_matches_plain_on_cpu():
    """use_flash=True on the CPU (flash's plain version) against
    use_flash=False and the JAX layer: forward and every gradient."""
    fl, x, want = _mha_pair(True)
    pl, _, _ = _mha_pair(False)
    xf = x.clone().requires_grad_()
    xp = x.clone().requires_grad_()
    of, op = fl(xf), pl(xp)
    _close(of, want)
    _close(op, want)
    g = torch.from_numpy(np.random.RandomState(5).randn(*of.shape)
                         .astype(np.float32))
    (of * g).sum().backward()
    (op * g).sum().backward()
    _close(xf.grad, xp.grad.numpy())
    for a, b in zip(fl.parameters(), pl.parameters()):
        _close(a.grad, b.grad.numpy())


def test_mha_dispatch(monkeypatch):
    """Auto takes the kernel only on CUDA tensors; a mask or
    BIGDL_TPU_FLASH=0 keeps plain attention; True forces it on the CPU."""
    calls = []
    real = tattn.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    x = torch.randn(1, 8, 16)
    mask = torch.ones(8, 8, dtype=torch.bool)
    MultiHeadAttention(16, 2, use_flash=None)(x)
    MultiHeadAttention(16, 2, use_flash=True)(x, mask=mask)
    MultiHeadAttention(16, 2, use_flash=False)(x)
    assert calls == []
    MultiHeadAttention(16, 2, use_flash=True)(x)
    assert calls == [1]
    monkeypatch.setenv("BIGDL_TPU_FLASH", "0")
    MultiHeadAttention(16, 2, use_flash=True)(x)
    assert calls == [1, 1]   # the switch steers only the auto path

