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
    KERNEL, _launch, decode_chunks, paged_decode_attention,
    paged_decode_attention_ref, paged_verify_attention,
    paged_verify_attention_ref)
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


# the draft's shapes, (64, 64) blocks at the decode step's M = 16, (8, 8)
# at M = 256 with K not a multiple of 8, block dimensions that are not
# multiples of 8 (the ragged last blocks, 4-byte copies), and a block
# taller than the kernel's 64-row chunk
@pytest.mark.parametrize("m,k,n,blk", [(16, 768, 3072, (8, 8)),
                                       (37, 100, 70, (8, 16)),
                                       (256, 3072, 768, (64, 64)),
                                       (16, 768, 3072, (64, 64)),
                                       (256, 770, 384, (8, 8)),
                                       (45, 130, 93, (12, 6)),
                                       (20, 300, 40, (100, 8))])
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


def test_block_sparse_and_flash_backward_repeat_their_bits(card):
    """Two launches on the same inputs give the same bits: the tensor-core
    kernels add their partial sums in a fixed order, with no atomics."""
    rs = np.random.RandomState(2)
    for m, k, n, blk in ((16, 768, 3072, (8, 8)), (256, 3072, 768, (8, 8)),
                         (45, 130, 93, (12, 6))):
        plan = ColumnPlan(rs.rand(-(-k // blk[0]), -(-n // blk[1])) < 0.5,
                          *blk)
        x = torch.randn(m, k, device=card)
        w = torch.randn(k, n, device=card)
        first = block_sparse_matmul(x, w, plan=plan)
        assert torch.equal(first, block_sparse_matmul(x, w, plan=plan))
    g = torch.Generator().manual_seed(6)
    for causal, sq, skv, d in ((True, 300, 300, 64), (False, 70, 133, 32),
                               (True, 65, 200, 128)):
        q, k, v, go = (torch.randn(2, 3, n, d, generator=g).to(card)
                       for n in (sq, skv, skv, sq))
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        first = flash_attention_bwd(q, k, v, out, lse, go, causal=causal)
        again = flash_attention_bwd(q, k, v, out, lse, go, causal=causal)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


# the int8 matmul: ragged M / K / N (LeNet's K = 25, 150 and N = 6, 12, the
# stem's K = 147, the head's N = 1000, M = 1), both load paths (K and N
# multiples of 16 take 16-byte loads), K past float32's 2^24 sums
@pytest.mark.parametrize("m,k,n", [(1, 147, 64), (3, 25, 6), (100, 150, 12),
                                   (1, 2048, 1000), (130, 576, 64),
                                   (65, 4608, 512), (777, 64, 256),
                                   (64, 128, 1000), (5, 1000, 48)])
def test_int8_matmul_kernel_equals_plain(card, m, k, n):
    from bigdl_tpu_torch.ops.quantized import int8_matmul, int8_matmul_plain

    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8)
    if k == 4608:
        x[0] = w[:, 0] = 127       # 127 * 127 * 4608 = 7.4e7 > 2^24
    x, w = x.to(card), w.to(card)
    before = LAUNCHES["int8_matmul"]
    out = int8_matmul(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, int8_matmul_plain(x, w))
    # a row start off 16-byte alignment takes the byte loads
    buf = torch.empty(m * k + 1, dtype=torch.int8, device=card)
    xs = buf[1:].view(m, k)
    xs.copy_(x)
    assert torch.equal(int8_matmul(xs, w), int8_matmul_plain(x, w))


def test_int8_matmul_refuses_what_the_kernel_does_not_take(card):
    from bigdl_tpu_torch.ops.quantized import int8_matmul

    x = torch.zeros(32, 64, dtype=torch.int8, device=card)
    w = torch.zeros(64, 16, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x, torch.zeros(16, 64, dtype=torch.int8,
                                   device=card).t())
    with pytest.raises(ValueError, match="int8 operands"):
        int8_matmul(x.float(), w)
    with pytest.raises(ValueError, match="device"):
        int8_matmul(x, w.cpu())


@pytest.mark.parametrize("groups", [1, 2])
def test_quantized_conv2d_on_the_card_matches_the_cpu(card, groups):
    """The same int8 payloads on both devices (exact im2col, IEEE
    division), so outputs agree to the rescale's float32 rounding; the
    card launches one kernel per group."""
    from bigdl_tpu_torch.nn import Conv2D
    from bigdl_tpu_torch.nn.quantized import QuantizedConv2D

    torch.manual_seed(0)
    conv = Conv2D(16, 32, 3, 2, "SAME", groups=groups)
    q = QuantizedConv2D.from_conv(conv)
    x = torch.randn(2, 15, 16, 16)
    want = q(x)
    before = LAUNCHES["int8_matmul"]
    got = q.to(card)(x.to(card))
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == before + groups
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_predict_int8_on_the_card(card):
    """predict with int8 weights on the card: a layered model through the
    int8 kernel (one launch per Linear a bucket call), and the LM's int8
    view (head_dim 32: the flash kernels on the card, plain attention on
    the CPU), both equal to the CPU's answers to float32 rounding."""
    from bigdl_tpu_torch.nn import Linear, ReLU, Sequential, Transformer
    from bigdl_tpu_torch.serving import InferenceModel

    g = torch.Generator().manual_seed(0)
    x = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    for make, inp in ((lambda: Sequential([Linear(32, 64, generator=g),
                                           ReLU(),
                                           Linear(64, 10, generator=g)]), x),
                      (lambda: Transformer(64, 64, 2, num_layers=1,
                                           dropout=0.0),
                       np.arange(12, dtype=np.int32).reshape(2, 6))):
        model = make()
        want = InferenceModel(model, device="cpu",
                              weight_quant="int8").predict(inp)
        before = LAUNCHES["int8_matmul"]
        got = InferenceModel(model, device=card,
                             weight_quant="int8").predict(inp)
        layered = isinstance(model, Sequential)
        assert LAUNCHES["int8_matmul"] - before == (2 if layered else 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the fused LayerNorm: odd and ragged d (both kernel paths, and rows past
# 1024 floats), rows that are not a multiple of a block's 8 warps, eps
# 1e-12 (below float32's resolution next to a variance of ~1)
@pytest.mark.parametrize("rows,d", [(5, 16), (37, 1000), (130, 768),
                                    (7, 37), (9, 1030), (3, 4096), (1, 1)])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_fused_layernorm_kernel_matches_plain(card, rows, d, eps):
    from bigdl_tpu_torch.ops.fused import (fused_layernorm,
                                           fused_layernorm_plain)

    g = torch.Generator().manual_seed(rows * d)
    x = (torch.randn(rows, d, generator=g) * 2 + 0.5).to(card)
    gamma = (1 + 0.3 * torch.randn(d, generator=g)).to(card)
    beta = (0.2 * torch.randn(d, generator=g)).to(card)
    before = LAUNCHES["fused_layernorm"]
    got = fused_layernorm(x, gamma, beta, eps=eps)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_layernorm"] == before + 1
    want = fused_layernorm_plain(x, gamma, beta, eps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # a row start off 16-byte alignment takes the scalar loads
    buf = torch.empty(rows * d + 1, device=card)
    xs = buf[1:].view(rows, d)
    xs.copy_(x)
    torch.testing.assert_close(fused_layernorm(xs, gamma, beta, eps=eps),
                               want, rtol=1e-5, atol=1e-5)
    # a 3-D input and a transposed view are read as what they are
    x3 = x.reshape(1, rows, d)
    torch.testing.assert_close(fused_layernorm(x3, gamma, beta, eps=eps),
                               want.reshape(1, rows, d), rtol=1e-5,
                               atol=1e-5)
    xt = x.t().contiguous().t()
    torch.testing.assert_close(fused_layernorm(xt, gamma, beta, eps=eps),
                               want, rtol=1e-5, atol=1e-5)


def test_fused_layernorm_backward_and_refusals_on_the_card(card):
    from bigdl_tpu_torch.ops.fused import fused_layernorm

    g = torch.Generator().manual_seed(0)
    x, up = torch.randn(6, 48, generator=g), torch.randn(6, 48, generator=g)
    gamma, beta = 1 + torch.randn(48, generator=g), torch.randn(48,
                                                                generator=g)
    grads = []
    for dev in ("cpu", card):
        leaves = [t.to(dev, copy=True).requires_grad_()
                  for t in (x, gamma, beta)]
        (fused_layernorm(*leaves) * up.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    xd = x.to(card)
    with pytest.raises(ValueError, match="float32"):
        fused_layernorm(xd.double(), gamma.to(card), beta.to(card))
    with pytest.raises(ValueError, match="different devices"):
        fused_layernorm(xd, gamma, beta)


def test_flash_forward_non_causal_at_the_encoder_shape(card):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 3, 128, 64, generator=g).to(card)
               for _ in range(3))
    before = LAUNCHES["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    ro, rl = flash_attention_fwd_ref(q, k, v, causal=False,
                                     sm_scale=64 ** -0.5)
    _close(out, ro)
    _close(lse, rl)


def test_fused_keras_encoder_on_the_card(card):
    """A 2-layer post-LN keras encoder through the "fused" rewrite,
    served by predict on the card: every LayerNorm on the kernel (5 a
    call), every attention on the flash forward (2 a call), the answers
    equal to the CPU's to float32 rounding."""
    from bigdl_tpu_torch import keras as K
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.serving import InferenceModel
    from bigdl_tpu_torch.utils.intermediate import IRGraph

    torch.manual_seed(0)
    tok = K.Input((16,), dtype=np.int32)
    x = nn.CAdd((16, 64))(K.Embedding(50, 64)(tok))
    x = K.LayerNorm(64, eps=1e-12)(x)
    for _ in range(2):
        a = K.MultiHeadAttention(64, 2)(x)
        x = K.LayerNorm(64, eps=1e-12)(K.Merge("sum")([x, a]))
        f = K.Dense(128, 64)(K.GELU()(K.Dense(64, 128)(x)))
        x = K.LayerNorm(64, eps=1e-12)(K.Merge("sum")([x, f]))
    out = K.LogSoftMax()(K.Dense(64, 2)(nn.Select(1, 0)(x)))
    fused = IRGraph.from_model(K.Model(tok, out).eval()).to_model("fused")
    ids = np.random.RandomState(0).randint(0, 50, (3, 16)).astype(np.int32)
    want = InferenceModel(fused, device="cpu").predict(ids)
    before = dict(LAUNCHES)
    got = InferenceModel(fused, device=card).predict(ids)
    assert LAUNCHES["fused_layernorm"] - before.get("fused_layernorm",
                                                    0) == 5
    assert LAUNCHES["flash_attention_fwd"] - before.get(
        "flash_attention_fwd", 0) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the decode kernel's split walk (chunks of 128 keys: 8 pages of 16, 4 of
# 32): lengths on both sides of page and chunk edges, length 0, the full
# table, and a 10-page table that is not a whole number of chunks
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("page", [16, 32])
def test_paged_decode_split_walk_edges(card, int8, d, page):
    S, h, nb = 10, 3, 10
    kp, vp, pt, sc = _paged_case(card, S, h, d, page, nb, int8, seed=7)
    g = torch.Generator().manual_seed(8)
    q = torch.randn(S, h, d, generator=g).to(card)
    full = nb * page - 1
    lengths = torch.tensor([0, page - 1, page, 63, 64, 65, 127, 128,
                            full - 1, full], dtype=torch.int32, device=card)
    name = "paged_decode_attention_int8" if int8 else \
        "paged_decode_attention"
    before = LAUNCHES[name]
    out = paged_decode_attention(q, kp, vp, pt, lengths, **sc)
    want = paged_decode_attention_ref(q, kp, vp, pt, lengths, **sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    assert LAUNCHES[name] == before + 1


def test_paged_decode_repeats_its_bits_and_refuses_misaligned_pages(card):
    """The split walk's partials merge in a fixed order: two launches on
    the same inputs give the same bits, for both page types."""
    S, h, d, page, nb = 16, 12, 64, 16, 64
    lengths = torch.from_numpy(np.random.RandomState(3).randint(
        0, nb * page, S).astype(np.int32)).to(card)
    for int8 in (False, True):
        kp, vp, pt, sc = _paged_case(card, S, h, d, page, nb, int8, seed=9)
        q = torch.randn(S, h, d, device=card)
        first = paged_decode_attention(q, kp, vp, pt, lengths, **sc)
        again = paged_decode_attention(q, kp, vp, pt, lengths, **sc)
        assert torch.equal(first, again)
    kp, vp, pt, _ = _paged_case(card, 2, 2, 32, 16, 2, False)
    off = torch.empty(kp.numel() + 1, device=card)[1:].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(torch.randn(2, 2, 32, device=card), off, vp,
                               pt, torch.zeros(2, dtype=torch.int32,
                                               device=card))


def test_paged_decode_entry_refuses_a_short_split_or_workspace(card):
    """The wrapper owns the split; the C entry refuses, before any
    launch, a split that does not cover the table or a workspace too
    small for its partials, so neither can be overrun."""
    S, h, d, page, nb = 3, 2, 32, 16, 20
    kp, vp, pt, _ = _paged_case(card, S, h, d, page, nb, False)
    q = torch.randn(S, h, d, device=card)
    lengths = torch.full((S,), nb * page - 1, dtype=torch.int32,
                         device=card)
    chunk_pages, n_chunks = decode_chunks(page, nb)
    need = S * h * n_chunks * (d + 2)
    ws, out = torch.empty(need, device=card), torch.empty_like(q)

    def call(ws_floats, n):
        _launch(KERNEL, card, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                pt.data_ptr(), pt.stride(0), lengths.data_ptr(),
                ws.data_ptr(), ws_floats, out.data_ptr(), S, h, page, nb,
                chunk_pages, n, d, d ** -0.5)

    before = LAUNCHES[KERNEL]
    for ws_floats, n in ((need - 1, n_chunks), (need, n_chunks - 1)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            call(ws_floats, n)
    assert LAUNCHES[KERNEL] == before
    call(need, n_chunks)
    torch.testing.assert_close(
        out, paged_decode_attention_ref(q, kp, vp, pt, lengths),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,sq,skv", [(32, 100, 257), (32, 257, 100),
                                      (128, 100, 257), (128, 257, 100)])
def test_flash_forward_head_dims_on_the_tensor_cores(card, causal, d, sq,
                                                     skv):
    """The forward at head_dim 32 and 128 with sq != skv, within
    chip_smoke.py's tolerances (rtol 1e-4, atol 1e-5), out and lse, and
    the same bits over two launches."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn(2, 3, sq, d, generator=g).to(card)
    k, v = (torch.randn(2, 3, skv, d, generator=g).to(card)
            for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    again = flash_attention_fwd(q, k, v, causal=causal)
    ro, rl = flash_attention_fwd_ref(q, k, v, causal=causal,
                                     sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ro, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-5)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# the int8 kernel's fused epilogue: y = acc * sx * w_scales (+ bias) in
# the plain tail's order, bit-equal to it on the same payloads, in the
# three activation modes; at a split head, an unsplit 128 x 64 tile
# shape, the stem's K = 147 with padded rows, and N = 1000
@pytest.mark.parametrize("mode", ["dynamic", "static", "channel"])
@pytest.mark.parametrize("m,k,n", [(16, 2048, 1000), (777, 576, 64),
                                   (300, 147, 64), (130, 256, 1000)])
def test_int8_fused_epilogue_is_bit_equal_to_the_plain_tail(card, mode, m,
                                                            k, n):
    from bigdl_tpu_torch.ops.quantized import (int8_matmul_nk,
                                               int8_matmul_plain,
                                               quantize_activations,
                                               quantize_int8, rescale_plain)

    g = torch.Generator().manual_seed(m + k)
    x = (torch.randn(m, k, generator=g) * 2).to(card)
    w = (torch.randn(k, n, generator=g) * 0.1).to(card)
    b = (torch.randn(n, generator=g) * 0.01).to(card)
    act = {"dynamic": None, "static": 0.03,
           "channel": torch.rand(k, generator=g).to(card) * 0.04 + 0.01
           }[mode]
    wf = w * act[:, None] if mode == "channel" else w
    w_q, sw = quantize_int8(wf, axis=0)
    x_q, sx, per_channel = quantize_activations(x, act, row_align=16)
    sx = None if per_channel else sx
    w_nk = w_q.t().contiguous()
    want = rescale_plain(int8_matmul_plain(x_q, w_q), sx, sw, b)
    before = LAUNCHES["int8_matmul"]
    for bias in (b, None):
        got = int8_matmul_nk(x_q, w_nk, sw, sx, bias)
        again = int8_matmul_nk(x_q, w_nk, sw, sx, bias)
        torch.cuda.synchronize()
        ref = want if bias is not None else rescale_plain(
            int8_matmul_plain(x_q, w_q), sx, sw)
        assert got.dtype == torch.float32 and torch.equal(got, ref)
        assert torch.equal(got, again)
    assert LAUNCHES["int8_matmul"] == before + 4
    # the CPU's plain tail on the same payloads gives the same bits
    cpu = rescale_plain(int8_matmul_plain(x_q.cpu(), w_q.cpu()),
                        None if sx is None else sx.cpu(), sw.cpu(), b.cpu())
    assert torch.equal(want.cpu(), cpu)


# split-K: the head's K = 2048 and the last stage's K = 4608 at the M of
# buckets 1, 4, 16 and 64 (4608's at 1 and 4 images), exact, the same bits
# twice
@pytest.mark.parametrize("m", [1, 16, 49, 196])
@pytest.mark.parametrize("k,n", [(2048, 1000), (4608, 512)])
def test_int8_split_k_shapes_are_exact(card, m, k, n):
    from bigdl_tpu_torch.ops.quantized import (int8_matmul_nk,
                                               int8_matmul_plain, int8_plan)

    assert int8_plan(m, k, n)[2] > 1
    g = torch.Generator().manual_seed(m * 7 + k)
    x = torch.randint(-127, 128, (m, k), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g).to(torch.int8)
    x[0] = w[0] = 127          # 127 * 127 * K in one output
    x, w = x.to(card), w.to(card)
    got = int8_matmul_nk(x, w)
    again = int8_matmul_nk(x, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_matmul_plain(x, w.t()))
    assert torch.equal(got, again)
    assert got[0, 0].item() == 127 * 127 * k


def test_int8_stem_takes_padded_rows(card):
    """The stem's K = 147: activations in rows padded to 160 bytes (the
    16-byte staging), the (64, 147) weight through the shifted loads;
    exact against the plain version, and the stem conv on the card equal
    to the CPU's to float32 rounding (the two devices' abs-max scales,
    divided by 127, may round apart)."""
    from bigdl_tpu_torch.nn import Conv2D
    from bigdl_tpu_torch.nn.quantized import QuantizedConv2D
    from bigdl_tpu_torch.ops.quantized import (int8_matmul_nk,
                                               int8_matmul_plain,
                                               quantize_activations)

    g = torch.Generator().manual_seed(11)
    x = torch.randn(1000, 147, generator=g).to(card)
    x_q, _, _ = quantize_activations(x, row_align=16)
    assert x_q.stride() == (160, 1)
    w = torch.randint(-127, 128, (64, 147), generator=g).to(torch.int8)
    w = w.to(card)
    assert torch.equal(int8_matmul_nk(x_q, w),
                       int8_matmul_plain(x_q.contiguous(), w.t()))
    torch.manual_seed(0)
    conv = Conv2D(3, 64, 7, 2, "SAME")
    q = QuantizedConv2D.from_conv(conv)
    img = torch.randn(2, 40, 40, 3)
    want = q(img)
    got = q.to(card)(img.to(card))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


# the verify kernel's split walk: C = 1, 5 and 9 with the first query at
# 0, page - 1, page, on both sides of a chunk edge, with later chunks
# empty, and running off a 10-page table that is not a whole number of
# chunks; the same bits twice
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("chunk", [1, 5, 9])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_verify_split_walk_edges(card, int8, chunk, d):
    S, h, page, nb = 9, 3, 16, 10
    kp, vp, pt, sc = _paged_case(card, S, h, d, page, nb, int8, seed=12)
    g = torch.Generator().manual_seed(13)
    q = torch.randn(S, h, chunk, d, generator=g).to(card)
    ck, full = 8 * page, nb * page
    pos = torch.tensor([max(p, 0) for p in (
        0, page - 1, page, ck - chunk, ck - 1, ck, ck // 2, full - chunk,
        full - 1)], dtype=torch.int32, device=card)
    name = "paged_verify_attention_int8" if int8 else \
        "paged_verify_attention"
    before = LAUNCHES[name]
    out = paged_verify_attention(q, kp, vp, pt, pos, **sc)
    again = paged_verify_attention(q, kp, vp, pt, pos, **sc)
    want = paged_verify_attention_ref(q, kp, vp, pt, pos, **sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(out, again)
    assert LAUNCHES[name] == before + 2


def test_paged_verify_entry_refuses_a_short_split_or_workspace(card):
    """As the decode entry: a split that does not cover the table or a
    workspace too small for its partials is refused before any launch."""
    from bigdl_tpu_torch.ops.flash_attention import VERIFY

    S, h, d, page, nb, C = 3, 2, 32, 16, 20, 5
    kp, vp, pt, _ = _paged_case(card, S, h, d, page, nb, False)
    q = torch.randn(S, h, C, d, device=card)
    pos = torch.full((S,), nb * page - C, dtype=torch.int32, device=card)
    chunk_pages, n_chunks = decode_chunks(page, nb)
    need = S * h * C * n_chunks * (d + 2)
    ws, out = torch.empty(need, device=card), torch.empty_like(q)

    def call(ws_floats, n):
        _launch(VERIFY, card, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                pt.data_ptr(), pt.stride(0), pos.data_ptr(), ws.data_ptr(),
                ws_floats, out.data_ptr(), S, h, page, nb, chunk_pages, n,
                C, d, d ** -0.5)

    before = LAUNCHES[VERIFY]
    for ws_floats, n in ((need - 1, n_chunks), (need, n_chunks - 1)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            call(ws_floats, n)
    assert LAUNCHES[VERIFY] == before
    call(need, n_chunks)
    torch.testing.assert_close(
        out, paged_verify_attention_ref(q, kp, vp, pt, pos),
        rtol=1e-4, atol=1e-5)


# ---- training on the card ---------------------------------------------------

def _lenet_sets(*sizes):
    """Sets of 10 class templates plus noise, one set a size, all from
    the same templates."""
    rs = np.random.RandomState(0)
    templates = rs.rand(10, 28, 28, 1).astype(np.float32)
    out = []
    for n in sizes:
        y = rs.randint(0, 10, n).astype(np.int32)
        out.append((templates[y]
                    + 0.3 * rs.randn(n, 28, 28, 1).astype(np.float32), y))
    return out


def _lenet_opt(card, x, y, n_iter, **attrs):
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    opt = (Optimizer(LeNet5(10, generator=torch.Generator().manual_seed(0)),
                     DataSet.array(x, y), CrossEntropyCriterion(),
                     batch_size=64, seed=3, device=card)
           .set_optim_method(Adam(learning_rate=1e-3))
           .set_end_when(Trigger.max_iteration(n_iter)))
    for k, v in attrs.items():
        setattr(opt, k, v)
    return opt


def test_lenet_trains_validates_and_resumes_on_the_card(card, tmp_path):
    """LeNet-5 through the Optimizer on the card: validation every epoch, EMA,
    checkpoints every 4 steps; a fresh Optimizer resumes from ckpt-12 in
    the middle of the first epoch, validates at its end (step 16), and
    its steps 13-24 follow the uninterrupted run's (cuDNN pinned to
    deterministic algorithms: 1e-4 relative)."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.optim import Top1Accuracy, Trigger, checkpoint

    (x, y), (xv, yv) = _lenet_sets(1024, 256)
    torch.backends.cudnn.deterministic = True
    try:
        first = _lenet_opt(card, x, y, 12, ema_decay=0.9)
        first.set_checkpoint(str(tmp_path), Trigger.several_iteration(4))
        first.optimize()
        assert checkpoint.latest_checkpoint(str(tmp_path)).endswith(
            "ckpt-12")
        second = _lenet_opt(card, x, y, 24, ema_decay=0.9)
        second.set_checkpoint(str(tmp_path), Trigger.several_iteration(4))
        second.set_validation(Trigger.every_epoch(), DataSet.array(xv, yv),
                              [Top1Accuracy()])
        trained = second.optimize()
        full = _lenet_opt(card, x, y, 24, ema_decay=0.9)
        full.optimize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert second.final_state["iteration"] == 24
    assert [it for it, _ in second.validations] == [16]
    np.testing.assert_allclose(second.losses, full.losses[12:], rtol=1e-4)
    assert trained.ema_variables is not None
    assert next(trained.model.parameters()).is_cuda
    (res,) = trained.evaluate(DataSet.array(xv, yv), [Top1Accuracy()])
    assert res.count == 256 and res.result > 0.5


def test_ema_and_async_checkpoint_on_the_card(card, tmp_path):
    """The EMA lives on the card beside the parameters; an async write
    snapshots them at its trigger and ``wait`` returns once the files
    are complete (and raises the writer's error)."""
    from bigdl_tpu_torch.optim import Trigger, checkpoint

    ((x, y),) = _lenet_sets(256)
    opt = _lenet_opt(card, x, y, 6, ema_decay=0.5)
    opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(3),
                       async_write=True)
    trained = opt.optimize()
    ema = trained.ema_variables["params"]
    live = trained.variables["params"]
    assert not np.array_equal(ema["9_Linear"]["weight"],
                              live["9_Linear"]["weight"])
    flat, _, _, saved, ema_flat = checkpoint.load_checkpoint(
        str(tmp_path / "ckpt-6"))
    assert saved["iteration"] == 6 and ema_flat.shape == flat.shape
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = checkpoint.AsyncCheckpointer()
    writer.submit(str(blocker), 1, flat_params=flat, opt_state={},
                  model_state={})
    with pytest.raises(OSError):
        writer.wait()


def test_remat_keeps_bn_buffers_on_the_card(card):
    """A CIFAR ResNet with remat (both policies) against none: the same
    BatchNorm buffers after 3 steps."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.models import resnet_cifar
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    rs = np.random.RandomState(0)
    x = rs.randn(32, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, 32).astype(np.int32)

    def run(remat, policy=None):
        opt = (Optimizer(resnet_cifar(8, generator=torch.Generator()
                                      .manual_seed(0)),
                         DataSet.array(x, y), CrossEntropyCriterion(),
                         batch_size=8, device=card)
               .set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
               .set_end_when(Trigger.max_iteration(3)))
        opt.remat, opt.remat_policy = remat, policy
        trained = opt.optimize()
        return {n: b.cpu() for n, b in trained.model.named_buffers()}

    torch.backends.cudnn.deterministic = True
    try:
        base = run(False)
        for policy in (None, "dots"):
            got = run(True, policy)
            for n, b in base.items():
                torch.testing.assert_close(got[n], b, rtol=0, atol=1e-6)
    finally:
        torch.backends.cudnn.deterministic = False
