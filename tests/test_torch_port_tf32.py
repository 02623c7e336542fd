"""The 3xTF32 arithmetic of the redesigned tensor-core kernels
(``block_sparse_matmul.cu``, ``flash_attention_bwd.cu``,
``flash_attention_fwd.cu``), argued on the CPU before any card run.

A TF32 tensor-core product reads 10 explicit mantissa bits of each
float32 operand.  One TF32 rounding is emulated as ``cvt.rna.tf32.f32``
does it (to nearest, ties away from zero, the low 13 bits cleared); the
kernels' split as they compute it (``tf32x3.cuh``): ``hi``, x rounded to
nearest TF32 the same way, and ``lo = x - hi``, of which the tensor core
reads the top 11 bits (truncated here, the worse case).  Products of two such values are exact in float32, so a
float32 matmul of the rounded operands is the tensor core's product up to
the order of its float32 sums.  At the block-sparse shapes of
``chip_smoke.py`` (M = 16 and 256; K/N = 768/3072 and 3072/768; (8, 8)
blocks, half kept), at a small causal flash backward, and at a small
causal and non-causal flash forward with sq != skv (the kernel's 32-key
halves, base-2 online softmax and per-half float32 totals), against the
float64 product of the same float32 inputs:

- one TF32 rounding misses ``chip_smoke.py``'s tolerances (RTOL with
  BS_ATOL for the product, RTOL with BWD_ATOL for the gradients, RTOL
  with ATOL for the forward's out and lse);
- the 3xTF32 split, ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, meets them,
  also against the float32 plain version that the card compares with
  (and, for the forward, the JAX kernel in interpret mode).

The emulation lives in this test, not in the package."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops.block_sparse import (ColumnPlan,
                                              block_sparse_matmul_ref)
from bigdl_tpu_torch.ops.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd_ref)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
RTOL, BS_ATOL, BWD_ATOL = smoke.RTOL, smoke.BS_ATOL, smoke.BWD_ATOL


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32: to nearest at 10
    mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """The top 11 significant bits of float32 ``x`` (the low 13 cleared)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def split(x: torch.Tensor):
    """The kernels' split (tf32x3.cuh): hi, x rounded to nearest TF32,
    and lo = x - hi as the tensor core reads it."""
    hi = tf32(x)
    return hi, truncated(x.float() - hi)


def mm_tf32(a, b):
    return torch.matmul(tf32(a), tf32(b))


def mm_3xtf32(a, b):
    ah, al = split(a)
    bh, bl = split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah,
                                                                      bh)


def mm_f64(a, b):
    return torch.matmul(a.double(), b.double())


def test_tf32_rounding_and_the_split():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      1 + 2 ** -12, -(1 + 2 ** -11), 3.0e-39, 0.0])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9,
                         1.0, -(1 + 2 ** -10), 3.0e-39, 0.0])
    got = tf32(x)
    assert torch.equal(got[:6], want[:6])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    xs = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32) * 100)
    hi, lo = split(xs)
    # hi is exactly TF32, within half a TF32 step of x; hi + lo holds 22
    # of the 24 bits
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert ((hi - xs).abs() <= xs.abs() * 2 ** -11).all()
    assert ((hi + lo - xs).abs() <= xs.abs() * 2 ** -21).all()


def _close(got, want, atol) -> bool:
    return bool(torch.allclose(got.double(), want.double(), rtol=RTOL,
                               atol=atol))


@pytest.mark.parametrize("m", [16, 256])
@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768)])
def test_block_sparse_tolerance_needs_three_products(m, k, n):
    rs = np.random.RandomState(0)
    blk = smoke.SPARSE_BLOCK
    nkb, nnb = k // blk[0], n // blk[1]
    mask = np.zeros(nkb * nnb, bool)
    mask[rs.permutation(nkb * nnb)[: nkb * nnb // 2]] = True
    plan = ColumnPlan(mask.reshape(nkb, nnb), *blk)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    w = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    wm = torch.where(plan.on(w.device, k, n)[2], w, 0.0)
    exact = mm_f64(x, wm)
    one = mm_tf32(x, wm)
    three = mm_3xtf32(x, wm)
    plain = block_sparse_matmul_ref(x, w, plan)
    assert not _close(one, exact, BS_ATOL), (
        (one.double() - exact).abs().max())
    assert _close(three, exact, BS_ATOL)
    assert _close(three, plain, BS_ATOL)
    # the split's error is float32 summation noise, far inside the budget
    assert (three.double() - exact).abs().max() < BS_ATOL / 10


def _flash_bwd(q, k, v, out, lse, g, scale, causal, mm):
    """The flash backward's recurrence with every product through
    ``mm`` (elementwise work in float32)."""
    sq, skv = q.shape[2], k.shape[2]
    s = mm(q, k.transpose(-1, -2)).float() * scale
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis = torch.tril(vis)
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dv = mm(p.transpose(-1, -2), g)
    dp = mm(g, v.transpose(-1, -2)).float()
    delta = (g * out).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), dv


def test_flash_backward_tolerance_needs_three_products():
    rs = np.random.RandomState(1)
    b, h, s, d = 1, 2, 128, 64
    q, k, v, g = (torch.from_numpy(rs.randn(b, h, s, d).astype(np.float32))
                  for _ in range(4))
    scale = d ** -0.5
    out, lse = flash_attention_fwd_ref(q, k, v, causal=True, sm_scale=scale)
    exact = _flash_bwd(q.double(), k.double(), v.double(), out.double(),
                       lse.double(), g.double(), scale, True, mm_f64)
    one = _flash_bwd(q, k, v, out, lse, g, scale, True, mm_tf32)
    three = _flash_bwd(q, k, v, out, lse, g, scale, True, mm_3xtf32)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, causal=True,
                                    sm_scale=scale)
    for name, o, t, e, pl in zip(("dq", "dk", "dv"), one, three, exact,
                                 plain):
        assert not _close(o, e, BWD_ATOL), name
        assert _close(t, e, BWD_ATOL), name
        assert _close(t, pl, BWD_ATOL), name


def _flash_fwd(q, k, v, scale, causal, mm, half=32):
    """The redesigned forward's arithmetic (flash_attention_fwd.cu): q
    scaled by sm_scale * log2(e) in float32, keys walked 32 at a time with
    an online softmax in base 2 (running max from -1e30), each half's
    p v through ``mm`` into its own sums and then into float32 totals
    times the rescale; lse back in base e.  Returns (out, lse)."""
    sq, skv = q.shape[2], k.shape[2]
    qs = q * (scale * torch.tensor(1.4426950408889634, dtype=torch.float32))
    m = torch.full(q.shape[:3], -1e30, dtype=torch.float32)
    l = torch.zeros(q.shape[:3], dtype=torch.float32)
    o = torch.zeros(q.shape, dtype=torch.float32)
    rows = torch.arange(sq)[:, None]
    for kb in range(0, skv, half):
        kt, vt = k[:, :, kb:kb + half], v[:, :, kb:kb + half]
        s = mm(qs, kt.transpose(-1, -2)).float()
        keys = kb + torch.arange(kt.shape[2])[None, :]
        vis = keys <= rows if causal else torch.ones_like(keys <= rows)
        s = torch.where(vis, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vt).float()
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return o / l_safe[..., None], m * 0.6931471805599453 + torch.log(l_safe)


@pytest.mark.parametrize("causal,sq,skv", [(True, 96, 160),
                                           (False, 160, 96)])
def test_flash_forward_tolerance_needs_three_products(causal, sq, skv):
    """The forward's q k^T and p v in 3xTF32 meet chip_smoke.py's RTOL /
    ATOL against the JAX kernel (interpret mode) and the plain version,
    out and lse both; with one TF32 rounding they do not."""
    import jax.numpy as jnp
    from bigdl_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd

    rs = np.random.RandomState(2)
    b, h, d = 1, 2, 64
    q = rs.randn(b, h, sq, d).astype(np.float32)
    k = rs.randn(b, h, skv, d).astype(np.float32)
    v = rs.randn(b, h, skv, d).astype(np.float32)
    scale = d ** -0.5
    jo, jl = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale, causal, 32, 32, True)
    jax_out = (torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl)))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_attention_fwd_ref(qt, kt, vt, causal=causal,
                                    sm_scale=scale)
    exact = flash_attention_fwd_ref(qt.double(), kt.double(), vt.double(),
                                    causal=causal, sm_scale=scale)
    one = _flash_fwd(qt, kt, vt, scale, causal, mm_tf32)
    three = _flash_fwd(qt, kt, vt, scale, causal, mm_3xtf32)
    atol = smoke.ATOL
    assert not all(_close(o, e, atol) for o, e in zip(one, exact))
    for want in (exact, jax_out, plain):
        for name, got, w in zip(("out", "lse"), three, want):
            assert _close(got, w, atol), (
                name, (got.double() - w.double()).abs().max())
