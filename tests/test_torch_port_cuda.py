"""The port's CUDA kernels against their plain versions on the card, at
small shapes.  Every test here needs a CUDA card: without one it skips.
The file imports neither JAX nor the JAX package, so it also runs where
only the port is installed; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: float32 sums in another order, rtol and atol 1e-4."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.nn import MultiHeadAttention
from bigdl_tpu_torch.ops import (LAUNCHES, flash_attention_bwd,
                                 flash_attention_bwd_ref, flash_attention_fwd,
                                 flash_attention_fwd_ref)
from bigdl_tpu_torch.ops.block_sparse import (ColumnPlan,
                                              block_sparse_matmul,
                                              block_sparse_matmul_ref)
from bigdl_tpu_torch.ops.flash_attention import (
    paged_decode_attention, paged_decode_attention_ref,
    paged_verify_attention, paged_verify_attention_ref)
from bigdl_tpu_torch.ops.quantized import quantize_pages
from bigdl_tpu_torch.tensor.policy import apply_precision_policy

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    apply_precision_policy()
    return torch.device("cuda")


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,sq,skv,d", [(True, 130, 130, 64),
                                             (False, 70, 133, 32),
                                             (True, 65, 200, 128),
                                             (True, 200, 65, 64)])
def test_flash_kernels_match_plain(card, causal, sq, skv, d):
    g = torch.Generator().manual_seed(4)
    q, k, v, go = (torch.randn(2, 3, n, d, generator=g).to(card)
                   for n in (sq, skv, skv, sq))
    before = dict(LAUNCHES)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, out, lse, go, causal=causal)
    ro, rl = flash_attention_fwd_ref(q, k, v, causal=causal,
                                     sm_scale=d ** -0.5)
    want = flash_attention_bwd_ref(q, k, v, ro, rl, go, causal=causal,
                                   sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip((out, lse, *got), (ro, rl, *want)):
        _close(a, b)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv"):
        assert LAUNCHES[name] == before.get(name, 0) + 1


def test_flash_refuses_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_fwd(q.double(), q.double(), q.double())


def test_mha_auto_takes_the_kernels_with_plain_gradients(card):
    """On CUDA, use_flash=None reaches the kernels through the strided
    head views of the projections, and its gradients are plain
    attention's."""
    torch.manual_seed(0)
    m = MultiHeadAttention(128, 2, causal=True).to(card)
    x = torch.randn(2, 100, 128, device=card)
    grads = []
    for use_flash in (None, False):
        m.use_flash = use_flash
        m.zero_grad()
        xi = x.clone().requires_grad_()
        before = LAUNCHES["flash_attention_fwd"]
        m(xi).square().sum().backward()
        assert (LAUNCHES["flash_attention_fwd"] > before) == (
            use_flash is None)
        grads.append([xi.grad] + [p.grad for p in m.parameters()])
    for n, a, b in zip(["x"] + [n for n, _ in m.named_parameters()],
                       *grads):
        if n != "bk":   # its exact gradient is 0: softmax shift invariance
            _close(a, b)


def _paged_case(card, S, h, d, page, nb, int8, seed=5):
    g = torch.Generator().manual_seed(seed)
    P = S * nb + 3
    kp = torch.randn(P, h, page, d, generator=g)
    vp = torch.randn(P, h, page, d, generator=g)
    scales = {}
    if int8:
        kp, ks = quantize_pages(kp)
        vp, vs = quantize_pages(vp)
        scales = dict(k_scales=ks.to(card), v_scales=vs.to(card))
    pt = torch.randperm(P, generator=g)[:S * nb].reshape(S, nb).int()
    return kp.to(card), vp.to(card), pt.to(card), scales


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode_kernel_matches_plain(card, int8, d):
    S, h, page, nb = 5, 3, 16, 4
    kp, vp, pt, sc = _paged_case(card, S, h, d, page, nb, int8)
    q = torch.randn(S, h, d, device=card)
    lengths = torch.tensor([0, 15, 16, 40, 63], dtype=torch.int32,
                           device=card)
    name = "paged_decode_attention_int8" if int8 else \
        "paged_decode_attention"
    before = LAUNCHES[name]
    out = paged_decode_attention(q, kp, vp, pt, lengths, **sc)
    want = paged_decode_attention_ref(q, kp, vp, pt, lengths, **sc)
    torch.cuda.synchronize()
    _close(out, want)
    assert LAUNCHES[name] == before + 1


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,chunk", [(64, 1), (64, 5), (32, 9), (128, 17),
                                     (64, 49)])
def test_paged_verify_kernel_matches_plain(card, int8, d, chunk):
    S, h, page, nb = 4, 3, 16, 8
    kp, vp, pt, sc = _paged_case(card, S, h, d, page, nb, int8, seed=6)
    q = torch.randn(S, h, chunk, d, device=card)
    # the chunk at the start, across a page edge, and running off the table
    pos = torch.tensor([0, 14, 60, nb * page - 2], dtype=torch.int32,
                       device=card)
    name = "paged_verify_attention_int8" if int8 else \
        "paged_verify_attention"
    before = LAUNCHES[name]
    out = paged_verify_attention(q, kp, vp, pt, pos, **sc)
    want = paged_verify_attention_ref(q, kp, vp, pt, pos, **sc)
    torch.cuda.synchronize()
    _close(out, want)
    assert LAUNCHES[name] == before + 1
    if chunk > 1:   # each query equals a single-query decode step
        one = paged_decode_attention_ref(
            q[:, :, 1].contiguous(), kp, vp, pt,
            (pos + 1).clamp(max=nb * page - 1), **sc)
        _close(out[:, :, 1], one)


@pytest.mark.parametrize("m,k,n,blk", [(16, 768, 3072, (8, 8)),
                                       (37, 100, 70, (8, 16)),
                                       (256, 3072, 768, (64, 64))])
def test_block_sparse_kernel_matches_plain(card, m, k, n, blk):
    rs = np.random.RandomState(1)
    mask = rs.rand(-(-k // blk[0]), -(-n // blk[1])) < 0.5
    plan = ColumnPlan(mask, *blk)
    x = torch.randn(m, k, device=card, requires_grad=True)
    w = torch.randn(k, n, device=card, requires_grad=True)
    g = torch.randn(m, n, device=card)
    before = LAUNCHES["block_sparse_matmul"]
    out = block_sparse_matmul(x, w, plan=plan)
    dx, dw = torch.autograd.grad(out, (x, w), g)
    want = block_sparse_matmul_ref(x, w, plan)
    wdx, wdw = torch.autograd.grad(want, (x, w), g)
    torch.cuda.synchronize()
    _close(out, want)
    _close(dx, wdx)
    _close(dw, wdw)
    assert LAUNCHES["block_sparse_matmul"] == before + 2   # forward, dx
