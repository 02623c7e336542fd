"""The port's CUDA kernels against their plain versions on the card, at
small shapes.  Every test here needs a CUDA card: without one it skips.
The file imports neither JAX nor the JAX package, so it also runs where
only the port is installed; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: float32 sums in another order, rtol and atol 1e-4.  The
tests hold float32 semantics and pin ``compute_dtype(torch.float32)``
(the ``card`` fixture); those of the card's default, bfloat16 products
(``tensor.policy``), take ``card_bf16`` and state their own tolerances."""

import threading
import time

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
from bigdl_tpu_torch.tensor.policy import (apply_precision_policy,
                                           compute_dtype, get_compute_dtype,
                                           matmul_f32)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    apply_precision_policy()
    return torch.device("cuda")


@pytest.fixture
def card():
    """The card, in float32 products."""
    dev = _card()
    with compute_dtype(torch.float32):
        yield dev


@pytest.fixture
def card_bf16():
    """The card in its default compute dtype, bfloat16."""
    dev = _card()
    assert get_compute_dtype(dev) == torch.bfloat16
    return dev


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


def test_mha_cross_attention_takes_the_kernels(card):
    """Cross-attention (queries from x, keys and values from a longer
    context; sq != skv, not causal) reaches flash_attention_fwd and its
    backward on CUDA, within 1e-4 of plain attention (use_flash=False),
    gradients of x and the context included."""
    torch.manual_seed(1)
    m = MultiHeadAttention(128, 2).to(card)
    x = torch.randn(2, 37, 128, device=card)
    ctx = torch.randn(2, 100, 128, device=card)
    outs = []
    for use_flash in (None, False):
        m.use_flash = use_flash
        m.zero_grad()
        xi, ci = x.clone().requires_grad_(), ctx.clone().requires_grad_()
        before = {k: LAUNCHES[k] for k in ("flash_attention_fwd",
                                           "flash_attention_bwd_dq")}
        y = m(xi, context=ci)
        y.square().sum().backward()
        for k, n in before.items():
            assert (LAUNCHES[k] > n) == (use_flash is None), k
        outs.append([y, xi.grad, ci.grad] + [p.grad for p in m.parameters()])
    for n, a, b in zip(["y", "x", "context"]
                       + [n for n, _ in m.named_parameters()], *outs):
        if n != "bk":   # its exact gradient is 0: softmax shift invariance
            _close(a, b)


def test_lstm_on_the_card_against_the_cpu(card):
    """An LSTM (masked, float32 products) and one decode step on CUDA
    against the same on the CPU: plain PyTorch in float32, within
    1e-4."""
    from bigdl_tpu_torch.nn import LSTM

    g = torch.Generator().manual_seed(2)
    cpu = LSTM(64, 96, generator=g)
    x = torch.randn(4, 35, 64, generator=g)
    mask = (torch.rand(4, 35, generator=g) > 0.2).float()
    want = cpu(x, mask=mask)
    dev = LSTM(64, 96).to(card)
    dev.load_state_dict(cpu.state_dict())
    _close(dev(x.to(card), mask=mask.to(card)).cpu(), want)
    carry, h = dev.step(dev.init_carry(4, device=card), x[:, 0].to(card))
    _, hc = cpu.step(cpu.init_carry(4), x[:, 0])
    _close(h.cpu(), hc)


@pytest.mark.parametrize("helper", ["abs_max_scales", "quantize_pages",
                                    "from_conv"])
def test_int8_scales_on_the_card_equal_the_cpu(card, helper):
    """The three int8 scale helpers on CUDA equal the CPU's to the bit,
    eager and replayed from a captured graph (ROADMAP C.16: the card
    divides by 127 as the CPU does)."""
    from bigdl_tpu_torch.nn import Conv2D
    from bigdl_tpu_torch.nn.quantized import WeightOnlyConv2D
    from bigdl_tpu_torch.ops.quantized import abs_max_scales

    g = torch.Generator().manual_seed(6)
    if helper == "from_conv":
        conv = Conv2D(16, 256, 3, generator=g)
        x = conv.weight.detach().clone()        # the CPU's weight
        want = WeightOnlyConv2D.from_conv(conv)
        got = WeightOnlyConv2D.from_conv(conv.to(card))
        assert torch.equal(got.scales.cpu(), want.scales)
        assert torch.equal(got.weight_q.cpu(), want.weight_q)

        def fn(t):
            return abs_max_scales(t, (0, 1, 2))
    elif helper == "abs_max_scales":
        x = torch.rand(512, 300, generator=g) * 18 - 9

        def fn(t):
            return abs_max_scales(t, 1)
    else:
        x = torch.rand(64, 2, 16, 8, generator=g) * 18 - 9
        floors = torch.zeros(64)
        floors[::4] = 0.09
        # on the card before the capture: a host copy cannot be captured
        on = {"cpu": floors, "cuda": floors.to(card)}

        def fn(t):
            return torch.cat([a.reshape(-1).float() for a in
                              quantize_pages(t, on[t.device.type])
                              + quantize_pages(t)])
    want = fn(x)
    xd = x.to(card)
    got = fn(xd)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(xd)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)


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


def _within_one_bf16_ulp(got, want, terms):
    """Elementwise within one bfloat16 step of the larger magnitude: a
    float32 sum in another order can round to the neighbouring value.
    The step is floored at the float32 sum's own noise, sqrt(terms) 2^-24
    of the largest |value|: an element that cancels to near zero has a
    bfloat16 step finer than that, and two float32 sums of ``terms``
    products in different orders differ there by more than it."""
    got, want = got.detach().float(), want.detach().float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=terms ** 0.5 * 2.0 ** -24 * float(want.abs().max()))
    excess = (got - want).abs() - ulp
    i = int(excess.argmax())
    assert float(excess.max()) <= 0, (
        f"{int((excess > 0).sum())} elements past one ulp, worst "
        f"{got.flatten()[i].item()} against {want.flatten()[i].item()}")


@pytest.mark.parametrize("m,k,n,blk,density", [
    (16, 768, 3072, (8, 8), 0.5),
    (16, 3072, 768, (8, 8), 0.5),
    (37, 100, 70, (8, 16), 0.5),
    (256, 3072, 768, (64, 64), 0.5),
    (256, 768, 3072, (8, 8), 0.5),
    (256, 770, 384, (8, 8), 0.5),
    (45, 130, 93, (12, 6), 0.5),
    (20, 300, 40, (100, 8), 0.5),
    # wgmma tiles of 16, 32 and 64 rows, split and not
    (1, 768, 3072, (8, 8), 0.5),
    (5, 3072, 768, (8, 8), 0.5),
    (17, 776, 136, (12, 8), 0.5),
    (300, 768, 384, (64, 64), 0.5),
    (16, 3072, 768, (8, 8), 1.0),          # an all-ones mask
    (5, 104, 72, (8, 24), 0.3),            # block_n 24: 3 pieces a block
    # K or N not a multiple of 8: the mma.sync kernel
    (16, 772, 384, (4, 8), 0.5),
    (300, 768, 388, (8, 4), 0.5)])
def test_block_sparse_bf16_kernel_matches_plain(card_bf16, m, k, n, blk,
                                                density):
    """The bfloat16 kernel against its plain version (the float32 masked
    product of the widened operands, rounded once): every element within
    one bfloat16 ulp (floored at the float32 sum's noise), on both its
    paths (wgmma where K, N and block_n are multiples of 8, mma.sync
    elsewhere), with a column block that keeps no block; the backward
    (dx through the float32 kernel, dw dense, each rounded to bfloat16)
    likewise.  One launch is credited whatever the split of K."""
    rs = np.random.RandomState(1)
    mask = rs.rand(-(-k // blk[0]), -(-n // blk[1])) < density
    if density < 1:
        mask[:, 1] = False       # column block 1 keeps nothing: count 0
    plan = ColumnPlan(mask, *blk)
    assert (plan.counts == 0).any() == (density < 1)
    x = torch.randn(m, k, device=card_bf16).bfloat16().requires_grad_()
    w = torch.randn(k, n, device=card_bf16).bfloat16().requires_grad_()
    g = torch.randn(m, n, device=card_bf16).bfloat16()
    before = dict(LAUNCHES)
    out = block_sparse_matmul(x, w, plan=plan)
    assert out.dtype == torch.bfloat16
    dx, dw = torch.autograd.grad(out, (x, w), g)
    want = block_sparse_matmul_ref(x, w, plan)
    wdx, wdw = torch.autograd.grad(want, (x, w), g)
    torch.cuda.synchronize()
    for a, b, terms in ((out, want, k), (dx, wdx, n), (dw, wdw, m)):
        _within_one_bf16_ulp(a, b, terms)
    assert LAUNCHES["block_sparse_matmul_bf16"] == before.get(
        "block_sparse_matmul_bf16", 0) + 1
    assert LAUNCHES["block_sparse_matmul"] == before.get(
        "block_sparse_matmul", 0) + 1                        # dx


def test_block_sparse_bf16_repeats_its_bits_in_a_graph(card_bf16):
    """Two launches give the same bits, and a captured graph's replay the
    eager launch's, at the draft's four shapes (split K and not); mixed
    dtypes are refused."""
    rs = np.random.RandomState(3)
    for m, k, n in ((16, 768, 3072), (16, 3072, 768), (256, 768, 3072),
                    (256, 3072, 768)):
        plan = ColumnPlan(rs.rand(k // 8, n // 8) < 0.5, 8, 8)
        x = torch.randn(m, k, device=card_bf16).bfloat16()
        w = torch.randn(k, n, device=card_bf16).bfloat16()
        first = block_sparse_matmul(x, w, plan=plan)
        assert torch.equal(first, block_sparse_matmul(x, w, plan=plan))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = block_sparse_matmul(x, w, plan=plan)
        for _ in range(2):      # the workspace of split sums is reused
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        with pytest.raises(ValueError, match="one dtype"):
            block_sparse_matmul(x, w.float(), plan=plan)


def test_matmul_f32_on_the_card_against_the_cpu_emulation(card_bf16):
    """The product helper: ``out_dtype=float32`` cuBLAS products equal to
    the CPU's widened float32 product to 1e-5 of the largest |value|.
    Its gradients round the cotangent to bfloat16 on the card (ROADMAP
    C.15): each sits within one bfloat16 step of the CPU's plus the
    rounded cotangent's error, 2^-9 of sum |g| |w| (or |x| |g|)."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(4, 64, 768, generator=g)
    w = torch.randn(768, 3072, generator=g) * 0.03
    go = torch.randn(4, 64, 3072, generator=g)
    grads = {}
    for dev in ("cpu", card_bf16):
        xi = x.detach().to(dev, copy=True).requires_grad_()
        wi = w.detach().to(dev, copy=True).requires_grad_()
        with compute_dtype(torch.bfloat16):
            y = matmul_f32(xi, wi)
        assert y.dtype == torch.float32
        y.backward(go.to(dev))
        grads[str(dev)] = [t.detach().cpu() for t in (y, xi.grad, wi.grad)]
    (y0, dx0, dw0), (y1, dx1, dw1) = grads["cpu"], grads[str(card_bf16)]
    assert float((y1 - y0).abs().max() / y0.abs().max()) <= 1e-5
    xb, wb = x.bfloat16().float(), w.bfloat16().float()
    for got, want, bound in (
            (dx1, dx0, go.abs() @ wb.abs().T),
            (dw1, dw0, (xb.abs().reshape(-1, 768).T
                        @ go.abs().reshape(-1, 3072)))):
        mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        excess = (got - want).abs() - ulp - 2.0 ** -9 * bound
        assert float(excess.max()) <= 0.0, float(excess.max())
    # bf16 x bf16 -> float32 in one cuBLAS call on this torch
    a = x[0].to(card_bf16).bfloat16()
    b = w.to(card_bf16).bfloat16()
    full = torch.mm(a, b, out_dtype=torch.float32)
    ref = a.float() @ b.float()
    assert float((full - ref).abs().max() / ref.abs().max()) <= 1e-5


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


# ---- the input pipeline's device feed -----------------------------------------

def _image_records(tmp_path, n=96, hw=40):
    from bigdl_tpu_torch.data.records import write_records

    rs = np.random.RandomState(0)
    p = str(tmp_path / "imgs.btrec")
    write_records(p, {"image": rs.randint(0, 255, (n, hw, hw, 3), np.uint8),
                      "label": rs.randint(0, 1000, n).astype(np.int32)})
    return p


def test_pinned_side_stream_feed_equals_serial_batches(card, tmp_path):
    """Three epochs of augmented records through a depth-2 ring into the
    feed, tensors read back from the card: equal to the serial batches
    to the bit; the slots were page-locked and the copies overlapped."""
    from bigdl_tpu_torch.data import AugmentedRecordImages, dispatch_to_device
    from bigdl_tpu_torch.data.pipeline import PAGE_LOCKS
    from bigdl_tpu_torch.optim.metrics import Metrics

    ds = AugmentedRecordImages(_image_records(tmp_path), (32, 32),
                               (124.0, 116.0, 104.0), (58.0, 57.0, 57.0),
                               resize_hw=(36, 36), random_crop=True,
                               random_flip=True)
    m = Metrics()
    for epoch in range(3):
        stream = ds.stream_batches(16, seed=4, epoch=epoch, workers=2,
                                   ring_depth=2, raw_depth=1)
        got = [(x.cpu().numpy(), y.cpu().numpy()) for x, y in
               dispatch_to_device(stream, lambda mb: (mb["input"],
                                                      mb["target"]),
                                  metrics=m, device=card)]
        want = list(ds.batches(16, seed=4, epoch=epoch))
        assert len(got) == len(want) == 6
        for (x, y), mb in zip(got, want):
            np.testing.assert_array_equal(x, mb["input"])
            np.testing.assert_array_equal(y, mb["target"])
    slots = next(iter(ds._slot_cache.values()))
    assert all(torch.from_numpy(s["input"]).is_pinned() for s in slots)
    assert len(PAGE_LOCKS._ranges) >= 2
    assert m.counter("data.dispatch_overlapped_total") == 15
    ds.close()


def test_feed_waits_for_its_copy_before_a_slot_refills(card):
    """A source that overwrites a slot the moment the feed gives it back,
    with each batch yielded while its copy may still run (lookahead 1,
    three copies in flight): every batch read on the consumer's stream
    at once still holds its own value (the consumer's stream waits on the
    copy event, and a slot returns only after its own copy landed)."""
    from bigdl_tpu_torch.data import RingBatch, dispatch_to_device

    slots = [np.zeros((64 << 20) // 4, np.float32) for _ in range(3)]

    def source():
        for i in range(9):
            slot = slots[i % 3]
            slot.fill(float(i + 1))
            yield RingBatch(lambda s=slot: s.fill(-1.0), input=slot)

    seen = []
    for (x,) in dispatch_to_device(source(), lambda mb: (mb["input"],),
                                   size=1, inflight=3, device=card):
        seen.append(torch.stack([x.min(), x.max()]))  # at once
    got = [tuple(float(v) for v in s.cpu()) for s in seen]
    assert got == [(float(i + 1),) * 2 for i in range(9)]
    assert all(float(s[0]) == -1.0 for s in slots)  # every slot went back


# ---- step bundles as captured CUDA graphs --------------------------------------

def _bundle_data(n=320, d=12, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n).astype(np.int32)
    return (centers[y] + rs.randn(n, d)).astype(np.float32), y


def _bundle_mlp(dropout=0.1, bn=False):
    from bigdl_tpu_torch import nn

    g = torch.Generator().manual_seed(0)
    layers = [nn.Linear(12, 32, generator=g)]
    if bn:
        layers.append(nn.BatchNorm(32))
    layers += [nn.ReLU(), nn.Dropout(dropout), nn.Linear(32, 3, generator=g),
               nn.LogSoftMax()]
    return nn.Sequential(layers)


def _bundle_run(card, k, model, x, y, end, method=None, **attrs):
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer

    opt = (Optimizer(model, DataSet.array(x, y), ClassNLLCriterion(),
                     batch_size=32, seed=11, device=card)
           .set_optim_method(method or SGD(learning_rate=0.1, momentum=0.9))
           .set_end_when(end))
    opt.steps_per_call = k
    for name, v in attrs.items():
        setattr(opt, name, v)
    trained = opt.optimize()
    return opt, trained


@pytest.mark.parametrize("option", [
    {}, {"accum_steps": 2}, {"ema_decay": 0.9}, {"remat": True},
    {"remat": True, "remat_policy": "dots"}, {"clip": "l2"},
    {"trainable_mask": "first"}, {"bn": True}])
def test_graph_bundles_equal_eager_steps(card, option):
    """Two epochs of 10 steps at K = 4 (4 + 4 + 2 a epoch) through one
    captured graph, against K = 1's eager steps: the same losses and
    parameters to the bit, with each TrainStep option the JAX bundle
    takes; two eager warm steps, then every step a replay."""
    _graph_bundles_equal_eager(card, option)


@pytest.mark.parametrize("option", [{}, {"remat": True,
                                         "remat_policy": "dots"},
                                    {"bn": True}])
def test_graph_bundles_equal_eager_steps_bf16(card_bf16, option):
    """As test_graph_bundles_equal_eager_steps, in bfloat16 products:
    the graphs replay the eager bfloat16 steps to the bit."""
    _graph_bundles_equal_eager(card_bf16, option)


def _graph_bundles_equal_eager(card, option):
    from bigdl_tpu_torch.optim import GradientClipping, Trigger

    x, y = _bundle_data()
    option = dict(option)
    bn = option.pop("bn", False)
    if option.get("clip") == "l2":
        option["clip"] = GradientClipping(l2_norm=0.5)
    if option.get("trainable_mask") == "first":
        option["trainable_mask"] = {
            "0_Linear": {"weight": np.arange(12 * 32).reshape(12, 32) % 2
                         == 0, "bias": False},
            f"{4 if bn else 3}_Linear": True}
    runs = []
    for k in (1, 4):
        opt, trained = _bundle_run(card, k, _bundle_mlp(bn=bn), x, y,
                                   Trigger.max_epoch(2), **option)
        runs.append((opt.losses, trained))
    (l1, t1), (l4, t4) = runs
    assert len(l1) == 20 and l4 == l1
    for a, b in zip(t1.model.parameters(), t4.model.parameters()):
        assert torch.equal(a, b)
    assert t4._step.graphs_captured == 1 and t1._step.graphs_captured == 0


def test_graph_bundles_lm_on_the_flash_kernels(card):
    """A 2-layer LM whose attention runs the flash kernels: K = 4 replays
    equal K = 1's eager steps to the bit, and the wrappers' launch counts
    are credited at every replay (12 steps x 2 layers each way)."""
    _graph_bundles_lm(card)


def test_graph_bundles_lm_on_the_flash_kernels_bf16(card_bf16):
    """The same in bfloat16 products, the losses falling."""
    losses = _graph_bundles_lm(card_bf16)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_bundle_graphs_refuse_another_compute_dtype(card_bf16):
    """A TrainStep pins the compute dtype of its graphs at the first
    capture: a bundle in another dtype raises, naming both."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, TrainStep

    x, y = _bundle_data()
    step = TrainStep(_bundle_mlp(dropout=0.0).to(card_bf16),
                     ClassNLLCriterion(), SGD(learning_rate=0.1))
    xs = [torch.from_numpy(x[:32]).to(card_bf16)] * 3
    ys = [torch.from_numpy(y[:32]).to(card_bf16)] * 3
    step.train_bundle(0, xs, ys)
    assert step.graphs_captured == 1
    assert step.graph_dtype == torch.bfloat16
    with compute_dtype(torch.float32):
        with pytest.raises(RuntimeError, match="compute dtype"):
            step.train_bundle(3, xs, ys)
    step.train_bundle(3, xs, ys)     # back in bfloat16: replays


def _graph_bundles_lm(card):
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.ops import reset_launches
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (48, 128)).astype(np.int32)
    tgt = rs.randint(0, 256, (48, 128)).astype(np.int32)
    runs = []
    for k in (1, 4):
        model = Transformer(256, 128, 2, 256, num_layers=2, dropout=0.0,
                            seed=0)
        opt = (Optimizer(model, DataSet.array(ids, tgt),
                         CrossEntropyCriterion(), batch_size=4,
                         device=card)
               .set_optim_method(Adam(learning_rate=1e-3))
               .set_end_when(Trigger.max_iteration(12)))
        opt.steps_per_call = k
        reset_launches()
        trained = opt.optimize()
        torch.cuda.synchronize()
        runs.append((opt.losses, dict(LAUNCHES), trained))
    (l1, n1, _), (l4, n4, t4) = runs
    assert l4 == l1 and len(l1) == 12
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv"):
        assert n1[name] == n4[name] == 24, (n1, n4)
    assert t4._step.graphs_captured == 1
    return np.asarray(l1)


def test_one_graph_per_batch_shape(card):
    """A full batch and a ragged one get a graph each, after their own
    two warm steps; bundles of either shape then only replay."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, TrainStep

    x, y = _bundle_data(64)
    xt, yt = torch.from_numpy(x).to(card), torch.from_numpy(y).to(card)
    step = TrainStep(_bundle_mlp().to(card), ClassNLLCriterion(),
                     SGD(learning_rate=0.1))
    it = 0
    for rows, k, graphs in ((32, 4, 1), (20, 2, 1), (20, 3, 2), (32, 4, 2),
                            (20, 4, 2)):
        step.train_bundle(it, [xt[:rows]] * k, [yt[:rows]] * k)
        it += k
        assert step.graphs_captured == graphs
    assert sorted(s[0][0][0] for s in step._graphs) == [20, 32]


def test_uncapturable_step_raises_and_never_runs_eagerly(card):
    """A layer that reads the card on the host (``float`` of a tensor)
    runs its two warm steps, then the capture raises naming it: step 2
    never runs, eagerly or otherwise (the parameters are those after two
    eager steps)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.module import Module
    from bigdl_tpu_torch.optim import SGD, TrainStep

    class HostRead(Module):
        def forward(self, x):
            return x * float(x.abs().max() > 0)

    def model():
        g = torch.Generator().manual_seed(0)
        return nn.Sequential([nn.Linear(12, 3, generator=g), HostRead(),
                              nn.LogSoftMax()]).to(card)

    x, y = _bundle_data(32)
    xt, yt = torch.from_numpy(x).to(card), torch.from_numpy(y).to(card)
    step = TrainStep(model(), nn.ClassNLLCriterion(), SGD(learning_rate=0.1))
    with pytest.raises(RuntimeError, match="cannot be captured"):
        step.train_bundle(0, [xt] * 4, [yt] * 4)
    twin = TrainStep(model(), nn.ClassNLLCriterion(), SGD(learning_rate=0.1))
    for i in range(TrainStep.WARM_STEPS):
        twin(i, xt, yt)
    for a, b in zip(step.params, twin.params):
        assert torch.equal(a, b)
    assert step.graphs_captured == 0
    assert torch.cuda.get_sync_debug_mode() == 0


def test_step_scalars_reach_every_replay(card):
    """The rate after a Plateau drop and the dropout key of each step
    reach replays: a graph run and an eager twin fed the same batches and
    the same drop agree to the bit, the drop moves the parameters, and
    at lr 0 the same batch's loss changes with the step's dropout key."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Plateau, TrainStep

    x, y = _bundle_data(32)
    xt, yt = torch.from_numpy(x).to(card), torch.from_numpy(y).to(card)

    def make(drop):
        sched = Plateau(factor=0.5, patience=1, mode="min")
        step = TrainStep(_bundle_mlp().to(card), ClassNLLCriterion(),
                         SGD(learning_rate=0.1,
                             learning_rate_schedule=sched))
        return step, sched, drop

    runs = [make(True), make(True), make(False)]
    for i, (step, sched, drop) in enumerate(runs):
        for it in range(12):
            if it == 6 and drop:
                sched.on_score(1.0)
                sched.on_score(1.0)  # no improvement: the factor halves
            if i == 1:
                step(it, xt, yt)
            elif it % 2 == 0:
                step.train_bundle(it, [xt] * 2, [yt] * 2)
    (g, _, _), (e, se, _), (nodrop, _, _) = runs
    assert se.current_factor == 0.5 and g.graphs_captured == 1
    for a, b, c in zip(g.params, e.params, nodrop.params):
        assert torch.equal(a, b) and not torch.equal(a, c)
    frozen = TrainStep(_bundle_mlp().to(card), ClassNLLCriterion(),
                       SGD(learning_rate=0.0))
    losses = torch.cat([frozen.train_bundle(it, [xt] * 4, [yt] * 4)[0]
                        for it in (0, 4)]).tolist()
    assert len(set(losses)) == 8


def test_bundles_from_a_depth_2_ring_equal_the_serial_feed(card, tmp_path):
    """Augmented records streamed over a depth-2 ring into the feed, 4
    batches a bundle copied into the graph's static inputs: the losses of
    the serial feed at K = 1, to the bit (a slot refilled before its copy
    into the graph landed would show)."""
    from bigdl_tpu_torch.data import AugmentedRecordImages
    from bigdl_tpu_torch.models import resnet_cifar
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    ds = AugmentedRecordImages(_image_records(tmp_path), (32, 32),
                               (124.0, 116.0, 104.0), (58.0, 57.0, 57.0),
                               resize_hw=(36, 36), random_crop=True,
                               random_flip=True)

    class Depth2:
        def __getattr__(self, name):
            return getattr(ds, name)

        def stream_batches(self, *a, **kw):
            kw.update(workers=2, ring_depth=2, raw_depth=1)
            return ds.stream_batches(*a, **kw)

    def run(data, k, **attrs):
        opt = (Optimizer(resnet_cifar(8, generator=torch.Generator()
                                      .manual_seed(0)),
                         data, CrossEntropyCriterion(), batch_size=16,
                         device=card)
               .set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
               .set_end_when(Trigger.max_iteration(12)))
        opt.steps_per_call = k
        for name, v in attrs.items():
            setattr(opt, name, v)
        opt.optimize()
        return opt

    torch.backends.cudnn.deterministic = True
    try:
        serial = run(ds, 1, streaming=False, host_prefetch=0)
        bundled = run(Depth2(), 4)
    finally:
        torch.backends.cudnn.deterministic = False
    assert bundled.losses == serial.losses and len(serial.losses) == 12
    assert bundled.metrics.counter("data.dispatch_overlapped_total") > 0
    ds.close()


# ---- the decode engine's closed program set as CUDA graphs ---------------------

LM_SERVE = dict(vocab_size=256, hidden_size=128, num_heads=2, ffn_size=256,
                num_layers=2)
SERVE_GEOMETRY = dict(slots=4, page_size=16, pages_per_slot=8,
                      prompt_chunk=16, prefill_batch=2, max_new_tokens=12,
                      eos_id=1)


def _serve_prompts(n=6, seed=0, hi=60):
    rs = np.random.RandomState(seed)
    return [rs.randint(2, 256, int(k)).astype(np.int32)
            for k in rs.randint(3, hi, n)]


def _serve_engine(card, graphs, int8=False, spec=False, **over):
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.optim.metrics import Metrics
    from bigdl_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                         LMAdapter, SpecConfig)

    cfg = DecodeConfig(**dict(SERVE_GEOMETRY, **over), cuda_graphs=graphs,
                       kv_dtype="int8" if int8 else "float32",
                       speculative=SpecConfig(k=3, sparsity=0.5)
                       if spec else None)
    model = Transformer(**LM_SERVE, dropout=0.0, seed=0).to(card).eval()
    return DecodeEngine(LMAdapter(model, cfg.cap,
                                  weight_quant="int8" if int8 else None),
                        cfg, metrics=Metrics())


def _serve_waves(eng, prompts):
    """A greedy wave, then a sampled one (seeded), through the engine:
    the results and the launch counts of the whole run.  Each wave is
    queued with ``submit_many``, so the engine admits it as one batch and
    two engines run the same schedule (queued one request at a time, an
    engine may admit a wave's first request before the rest arrive, and
    different schedules leave different bytes in the pools)."""
    from bigdl_tpu_torch.serving import DecodeRequest

    out = []
    for temp in (0.0, 1.1):
        reqs = eng.submit_many([
            DecodeRequest(tokens=p, temperature=temp, top_k=20, top_p=0.9,
                          seed=7 + i) for i, p in enumerate(prompts)])
        out += [r.wait(timeout=120) for r in reqs]
    return out


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_graphs_equal_eager_to_the_bit(card, int8, spec, flash):
    """Every program of the closed set replayed from its graph against
    the same functions run eagerly: tokens, summed log-probs and every
    live page (and int8 scale) equal to the bit, the launches of each
    kernel the same, greedy and sampled waves, the chunk verify (greedy
    float32 on the paged kernel) and the scan verify."""
    _decode_graphs_equal_eager(card, int8, spec, flash)


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_graphs_equal_eager_to_the_bit_bf16(card_bf16, int8, spec):
    """The same in bfloat16 products (the draft's FFNs on the bfloat16
    block-sparse kernel under speculation)."""
    n = _decode_graphs_equal_eager(card_bf16, int8, spec, True)
    assert (n.get("block_sparse_matmul_bf16", 0) > 0) == spec
    assert not n.get("block_sparse_matmul")


def test_decode_graphs_refuse_another_compute_dtype(card_bf16):
    """An engine pins the compute dtype of its graphs at warmup: a call in
    another dtype fails its requests, naming both; back in the warmup's
    dtype the engine serves again."""
    eng = _serve_engine(card_bf16, True).warmup()
    try:
        assert eng.graph_dtype == torch.bfloat16
        with compute_dtype(torch.float32):
            with pytest.raises(RuntimeError, match="compute dtype"):
                eng.check_compute_dtype()
            with pytest.raises(Exception, match="compute dtype"):
                _serve_waves(eng, _serve_prompts(n=2))
        assert len(_serve_waves(eng, _serve_prompts(n=2))) == 4
    finally:
        eng.stop()


def _decode_graphs_equal_eager(card, int8, spec, flash):
    from bigdl_tpu_torch.ops import reset_launches

    prompts = _serve_prompts()
    runs = []
    for graphs in (False, True):
        eng = _serve_engine(card, graphs, int8, spec,
                            use_flash_decode=flash).warmup()
        try:
            reset_launches()
            res = _serve_waves(eng, prompts)
            torch.cuda.synchronize()
            runs.append((eng, res, dict(LAUNCHES)))
        finally:
            eng.stop()
    (e0, r0, n0), (e1, r1, n1) = runs
    assert e0.graphs_captured == 0 and e1.graphs_captured == len(
        e1.closed_set()) == 16
    assert e1.metrics.counter("serving.decode.graph_captures") == 16
    for a, b in zip(r0, r1):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert np.float32(a.logp).tobytes() == np.float32(b.logp).tobytes()
    P = e0.cfg.total_pages
    pools = ["_kv_k", "_kv_v"] + (["_kv_sk", "_kv_sv"] if int8 else []) \
        + (["_dr_k", "_dr_v"] if spec else [])
    for name in pools:
        assert torch.equal(getattr(e0, name)[:, :P],
                           getattr(e1, name)[:, :P]), name
    assert n0 == n1 and (bool(n1) == (flash or spec))
    assert e1.stats["steps"] == e0.stats["steps"]
    return n1


def test_decode_sweep_after_warmup_captures_nothing(card):
    """A mixed stream after warmup(): prompt lengths reaching every
    bucket, greedy and sampled, speculation on — zero unexpected
    captures; then every page back on the free list."""
    from bigdl_tpu_torch.serving import DecodeRequest

    eng = _serve_engine(card, True, spec=True).warmup()
    try:
        rs = np.random.RandomState(3)
        reqs = [eng.submit(DecodeRequest(
            tokens=rs.randint(2, 256, int(n)).astype(np.int32),
            max_new_tokens=int(rs.randint(1, 12)),
            temperature=float(i % 2) * 1.2, seed=i))
            for i, n in enumerate([3, 12, 20, 40, 70, 100, 115, 8, 33, 60])]
        res = [r.wait(timeout=120) for r in reqs]
        assert all(len(r.tokens) >= 1 for r in res)
        assert eng.metrics.counter("serving.decode.unexpected_captures") == 0
        assert eng.graphs_captured == len(eng.closed_set())
        deadline = time.time() + 30
        while len(eng._free_pages) != eng.cfg.total_pages:
            assert time.time() < deadline
            time.sleep(0.01)
    finally:
        eng.stop()


def test_decode_program_with_a_host_read_refuses_capture(card):
    """A program that reads the card on the host cannot be captured:
    warmup raises naming the program, and no graph is kept."""
    eng = _serve_engine(card, True)
    prog = eng._programs["step"]
    body = prog.fn

    def reads_the_card(n_blocks, sampled, x):
        if int(x["lengths"].sum()) > 10 ** 9:
            pass
        return body(n_blocks, sampled, x)

    prog.fn = reads_the_card
    try:
        with pytest.raises(RuntimeError,
                           match="step program .* cannot be captured"):
            eng.warmup()
        assert ("step", 1, False) not in eng._graphs
    finally:
        eng.stop()


def test_decode_replays_credit_their_launches(card):
    """Each replay of a step graph credits the capture's launches: 2
    paged-decode launches (one a layer) per step, as eagerly."""
    from bigdl_tpu_torch.ops import reset_launches

    eng = _serve_engine(card, True).warmup()
    try:
        reset_launches()
        steps0 = eng.stats["steps"]
        _serve_waves(eng, _serve_prompts(4))
        steps = eng.stats["steps"] - steps0
        assert steps > 0
        assert LAUNCHES["paged_decode_attention"] == 2 * steps
    finally:
        eng.stop()


def _iterate(eng):
    """One engine iteration on the calling thread (the engine's own
    thread never started)."""
    with eng._iter_lock:
        eng._sweep_cancelled()
        eng._expire(time.time())
        eng._admit()
        eng._decode_step()
        eng._prefill_one()


@pytest.mark.parametrize("int8", [False, True])
def test_cancelled_slot_writes_only_the_sink(card, int8):
    """A slot cancelled between two replays is inactive in the next one:
    its freed pages (those no other slot took since) keep their bytes
    while the other stream advances, and the cancel frees every page."""
    from bigdl_tpu_torch.serving import DecodeRequest, RequestCancelledError

    eng = _serve_engine(card, True, int8, max_new_tokens=60,
                        eos_id=-1).warmup()
    eng._ensure_thread = lambda: None
    try:
        a, b = (eng.submit(DecodeRequest(tokens=p, max_new_tokens=60,
                                         on_token=lambda *_: None))
                for p in _serve_prompts(2, seed=5, hi=20))
        while not (eng._slots[0] and len(eng._slots[0].generated) >= 3):
            _iterate(eng)
        pages = list(eng._slots[0].pages)
        eng.cancel(a.rid, reason="client_disconnect")
        pools = [eng._kv_k, eng._kv_v] + ([eng._kv_sk, eng._kv_sv]
                                          if int8 else [])
        snap = [t[:, pages].clone() for t in pools]
        before = len(eng._slots[1].generated)
        for _ in range(4):
            _iterate(eng)
        torch.cuda.synchronize()
        with pytest.raises(RequestCancelledError):
            a.wait(timeout=1)
        assert len(a.error.partial_tokens) >= 3
        assert len(eng._slots[1].generated) == before + 4
        kept = [i for i, p in enumerate(pages)
                if p not in eng._slots[1].pages]
        assert kept
        for t, old in zip(pools, snap):
            assert torch.equal(t[:, pages][:, kept], old[:, kept])
        assert eng.stats["cancelled"] == 1
        assert eng.metrics.counter("serving.decode.client_disconnects") == 1
        eng.cancel(b.rid)
        _iterate(eng)
        assert len(eng._free_pages) == eng.cfg.total_pages
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# ZeRO-1 on the card: NCCL at world 1 (one card a process; more cards are
# not on the machines these tests run on)
# ---------------------------------------------------------------------------

class _NcclWorld1:
    """An engine over NCCL at world 1 on the card and a gloo group of the
    same rank for the CPU; the process group is gone after the block."""

    def __enter__(self):
        import socket

        import torch.distributed as dist

        from bigdl_tpu_torch.runtime import EngineConfig, init_engine

        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        self.engine = init_engine(EngineConfig(
            coordinator_address=f"127.0.0.1:{port}", num_processes=1,
            process_id=0, timeout_s=300))
        self.nccl = self.engine.mesh.group
        assert dist.get_backend(self.nccl) == "nccl"
        self.gloo = dist.new_group(ranks=[0], backend="gloo")
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        from bigdl_tpu_torch.runtime import Engine

        dist.destroy_process_group()
        Engine.reset()


def test_nccl_world1_collectives_equal_gloo_on_the_cpu(card):
    """Each wire collective over NCCL at world 1, eager and replayed from
    a captured graph, equals the same call over gloo on the CPU to the
    bit, the int8 wire and the int8 delta gather too (the card divides
    each scale by 127 as the CPU does, ``ops.quantized.div127``)."""
    from bigdl_tpu_torch.parallel import collectives as pc

    g = torch.Generator().manual_seed(3)
    x = (torch.randn(1, 5003, generator=g)
         * torch.logspace(-3, 1, 5003)).to(card)
    base = torch.randn(1, 5003, generator=g).to(card)
    with _NcclWorld1() as w:
        ops = {
            "fp32": lambda a, grp: pc.reduce_scatter_wire(a[0], grp, "fp32"),
            "bf16": lambda a, grp: pc.reduce_scatter_wire(a[0], grp, "bf16"),
            "int8": lambda a, grp: pc.reduce_scatter_wire(
                a[0], grp, "int8", block=64),
            "delta": lambda a, grp: pc.all_gather_delta_quantized(
                a[0][0] * 1e-3, a[1], grp, block=64),
        }
        side = torch.cuda.Stream()
        for name, fn in ops.items():
            want = fn((x.cpu(), base.cpu()), w.gloo)
            got = fn((x, base), w.nccl)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), name
            graph = torch.cuda.CUDAGraph()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.graph(graph, stream=side):
                out = fn((x, base), w.nccl)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, got), name
        flat = torch.randn(5003, generator=g).to(card)
        before = flat.clone()
        pc.all_gather(flat, flat, w.nccl)       # in place, one rank
        assert torch.equal(flat, before)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_int8_codec_on_the_card_against_the_cpu(card):
    """The blockwise int8 codec of the int8 wire on CUDA tensors against
    the CPU's: scales, bytes and dequantized values equal to the bit
    (a scale is the correctly rounded amax / 127 on both devices)."""
    from bigdl_tpu_torch.ops.quantized import (dequantize_blockwise,
                                               quantize_blockwise)

    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4096, generator=g) * torch.tensor(
        [[1e-4], [1.0], [300.0]])
    x[1, :64] = 0.0                            # an all-zero block
    for block in (1, 64, 1024):
        qc, sc = quantize_blockwise(x, block)
        qg, sg = quantize_blockwise(x.to(card), block)
        assert torch.equal(sg.cpu(), sc), block
        assert torch.equal(qg.cpu(), qc), block
        assert torch.equal(dequantize_blockwise(qg, sg).cpu(),
                           dequantize_blockwise(qc, sc)), block
        assert torch.equal(dequantize_blockwise(qc.to(card), sc.to(card))
                           .cpu(), dequantize_blockwise(qc, sc)), block


@pytest.mark.parametrize("option", [{}, {"clip": "l2", "ema_decay": 0.9},
                                    {"trainable_mask": "first"}])
def test_sharded_step_at_world1_equals_train_step(card, option):
    """Through the Optimizer at K = 4 (captured graphs): with an NCCL
    process group of one rank the step is ShardedParameterStep on its
    flat buffers, and its losses and parameters equal TrainStep's (no
    process group) to the bit."""
    from bigdl_tpu_torch.optim import (GradientClipping,
                                       ShardedParameterStep, Trigger)

    x, y = _bundle_data()
    option = dict(option)
    if option.get("clip") == "l2":
        option["clip"] = GradientClipping(l2_norm=0.5)
    if option.get("trainable_mask") == "first":
        option["trainable_mask"] = {
            "0_Linear": {"weight": np.arange(12 * 32).reshape(12, 32) % 2
                         == 0, "bias": False}, "3_Linear": True}
    ref_opt, ref = _bundle_run(card, 4, _bundle_mlp(), x, y,
                               Trigger.max_epoch(2), **option)
    with _NcclWorld1():
        opt, got = _bundle_run(card, 4, _bundle_mlp(), x, y,
                               Trigger.max_epoch(2), **option)
        assert isinstance(got._step, ShardedParameterStep)
        assert got._step.graphs_captured == 1
        assert opt.losses == ref_opt.losses and len(opt.losses) == 20
        for a, b in zip(ref.model.parameters(), got.model.parameters()):
            assert torch.equal(a, b)
        assert opt.metrics.snapshot()["gauges"][
            "train.collective_ici_bytes_per_step"] == 0


@pytest.mark.parametrize("mode,block", [("fp32", 1024), ("bf16", 1024),
                                        ("int8", 64)])
def test_psum_wire_graph_equals_eager_and_gloo(card, mode, block):
    """The DCN hop's ``psum_wire`` over NCCL at world 1: replayed from a
    captured graph equal to the eager call, and both equal to the same
    call over gloo on the CPU, to the bit."""
    from bigdl_tpu_torch.parallel import collectives as pc

    g = torch.Generator().manual_seed(7)
    x = (torch.randn(5003, generator=g) * torch.logspace(-3, 1, 5003))
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    with _NcclWorld1() as w:
        want = pc.psum_wire(x, w.gloo, 1, mode, block=block)
        got = pc.psum_wire(x.to(card), w.nccl, 1, mode, block=block)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        side = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        xc = x.to(card)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=side):
            out = pc.psum_wire(xc, w.nccl, 1, mode, block=block)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_through_local_map_equals_the_plain_call(card, causal):
    """The flash kernels reached through ``local_map`` on a world-1
    DeviceMesh (``parallel.local_ops.attention``, as a layout's
    attention runs): forward and q, k, v gradients equal to the call on
    plain tensors to the bit, and the kernels launched."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from bigdl_tpu_torch.ops import flash_attention
    from bigdl_tpu_torch.parallel import local_ops, mesh_and_layout

    g = torch.Generator().manual_seed(9)
    q, k, v, go = (torch.randn(2, 4, 130, 64, generator=g).to(card)
                   for _ in range(4))
    with _NcclWorld1():
        mesh = mesh_and_layout("dp", card).dtensor_mesh
        for placements in ([Shard(0)], [Shard(1)], [Replicate()]):
            leaves = [distribute_tensor(t.clone(), mesh, placements,
                                        src_data_rank=None).requires_grad_()
                      for t in (q, k, v)]
            before = dict(LAUNCHES)
            out = local_ops.attention(
                lambda a, b, c: flash_attention(a, b, c, causal=causal),
                *leaves)
            out.backward(distribute_tensor(go, mesh, out.placements,
                                           src_data_rank=None))
            torch.cuda.synchronize()
            for kname in ("flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkdv"):
                assert LAUNCHES[kname] == before.get(kname, 0) + 1, kname
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            want = flash_attention(*plain, causal=causal)
            want.backward(go)
            assert torch.equal(out.full_tensor(), want)
            for a, b in zip(leaves, plain):
                assert torch.equal(a.grad.full_tensor(), b.grad)


# ---- the converted stock-torch encoder, the Autoformer, the serializer --------


class _StockEncoder(torch.nn.Module):
    """A stock torch encoder classifier: two post-norm layers with dropout
    0.1 and GELU, the first token's state, a three-label head."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(100, 64)
        self.enc = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(64, 2, 128, dropout=0.1,
                                             activation="gelu",
                                             batch_first=True), 2)
        self.head = torch.nn.Linear(64, 3)

    def forward(self, ids):
        return self.head(self.enc(self.emb(ids))[:, 0])


def test_converted_encoder_trains_on_the_flash_kernels(card):
    """``utils.torch_convert`` drops torch's attention dropout (ROADMAP
    C.18), so a converted encoder's training step runs the flash forward
    and both backward entry points, once a layer each, with its dropout
    layers drawing their masks; its loss and gradients agree with
    ``use_flash=False`` (the same masks) within 1e-4 of each gradient's
    norm plus 1e-4 of the total (the key bias apart, ROADMAP C.4)."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import reset_launches
    from bigdl_tpu_torch.utils import prng
    from bigdl_tpu_torch.utils.torch_convert import from_torch_module

    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 100, (4, 80))
    model, _ = from_torch_module(_StockEncoder(), example_input=ids[:1])
    model.to(card).train(True)
    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    assert len(mhas) == 2
    x = torch.from_numpy(ids.astype(np.int32)).to(card)
    y = torch.from_numpy(rs.randint(0, 3, 4)).to(card)
    key = prng.PRNGKey(3, device=card)

    def step(use_flash):
        for m in mhas:
            m.use_flash = use_flash
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = CrossEntropyCriterion()(model(x, key=key), y)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}, \
            dict(LAUNCHES)

    loss_f, g_f, n_f = step(None)
    loss_p, g_p, n_p = step(False)
    for m in mhas:
        m.use_flash = None
    assert {k: n_f.get(k) for k in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkdv")} == {
        "flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
        "flash_attention_bwd_dkdv": 2}
    assert not n_p.get("flash_attention_fwd")
    assert abs(loss_f - loss_p) <= 1e-4 * abs(loss_p)
    total = torch.sqrt(sum(g.square().sum() for g in g_p.values())).item()
    for n in g_p:
        if n.endswith(".bk"):
            continue
        err = (g_f[n] - g_p[n]).norm().item() / (g_p[n].norm().item()
                                                  + 1e-4 * total)
        assert err <= 1e-4, (n, err)


def test_autoformer_forward_on_the_card_against_the_cpu(card):
    """The Autoformer at a small width: the card (cuFFT) picks the CPU's
    delays at every auto-correlation and its float32 forward agrees
    within 1e-4.  The series are seeded so that no two chosen
    correlations nearly tie."""
    from bigdl_tpu_torch.forecast import autoformer

    rs = np.random.RandomState(0)
    t = np.arange(120 + 96)[:, None]
    series = (np.sin(2 * np.pi * t / 24 + rs.rand(1, 7) * 6.28)
              + 0.1 * rs.randn(len(t), 7)).astype(np.float32)
    x = torch.from_numpy(np.stack([series[i:i + 96] for i in range(0, 120,
                                                                   15)]))
    model = autoformer.Autoformer(
        7, 7, 96, 24, hidden=64, heads=4, enc_layers=2, dec_layers=1,
        ff=128, kernel=25, generator=torch.Generator().manual_seed(0)).eval()
    picked = []
    real = autoformer.top_delays

    def record(mean_corr, top_k):
        vals, idx = real(mean_corr, top_k)
        picked.append(idx.cpu())
        return vals, idx

    autoformer.top_delays = record
    try:
        with torch.no_grad():
            want = model(x)
            n_cpu = len(picked)
            got = model.to(card)(x.to(card)).cpu()
    finally:
        autoformer.top_delays = real
    assert n_cpu == len(picked) - n_cpu == 4
    for a, b in zip(picked[:n_cpu], picked[n_cpu:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_serializer_round_trip_from_card_tensors(card, tmp_path):
    """``save_model`` of tensors on the card writes the JAX format;
    ``load_model`` gives them back bit for bit, and a forecaster trained
    on the card saves and loads to the same predictions."""
    from bigdl_tpu_torch.forecast import TCNForecaster
    from bigdl_tpu_torch.utils.serializer import load_model, save_model

    g = torch.Generator(device=card).manual_seed(0)
    tree = {"params": {"w": torch.randn(3, 4, device=card, generator=g),
                       "b": {"x": torch.arange(5.0, device=card)}},
            "state": {}}
    save_model(str(tmp_path / "t"), None, tree)
    got = load_model(str(tmp_path / "t"), template=tree)
    assert np.array_equal(got["params"]["w"], tree["params"]["w"].cpu())
    assert np.array_equal(got["params"]["b"]["x"], np.arange(5.0))

    rs = np.random.RandomState(1)
    x = rs.randn(64, 24, 2).astype(np.float32)
    y = rs.randn(64, 4, 2).astype(np.float32)
    f = TCNForecaster(24, 4, 2, 2, num_channels=(8, 8), device=card)
    f.fit((x, y), epochs=1, batch_size=32)
    f.save(str(tmp_path / "f"))
    back = TCNForecaster(24, 4, 2, 2, num_channels=(8, 8), seed=5,
                         device=card)
    back.load(str(tmp_path / "f"))
    assert np.array_equal(back.predict(x[:8]), f.predict(x[:8]))


# ---------------------------------------------------------------------------
# the decode engine's fleet half, the draft window and translation serving


@pytest.mark.parametrize("int8", [False, True])
def test_attached_prefill_runs_in_the_captured_graphs(card, int8):
    """A prefix-cache attach after warmup(): the attached prefill and the
    steps replay the warmed graphs (no capture), the shared pages keep
    their bytes and scales, 3 hits, and the graphs' tokens and log-probs
    equal an eager engine's to the bit (attached against cold is
    ROADMAP C.2's: chip_smoke.py reports it)."""
    from bigdl_tpu_torch.serving import DecodeRequest

    rs = np.random.RandomState(11)
    prefix = rs.randint(2, 256, 48).astype(np.int32)
    rest = [np.concatenate([prefix, rs.randint(2, 256, 9)]).astype(np.int32)
            for _ in range(3)]
    runs = {}
    for graphs in (True, False):
        eng = _serve_engine(card, graphs, int8,
                            prefix_cache_pages=16).warmup()
        captured = eng.graphs_captured
        try:
            eng.generate([prefix], max_new_tokens=4)
            entry, = eng._prefix_cache._entries.values()
            ids = torch.tensor(entry.pages, device=card)
            pools = ["_kv_k", "_kv_v"] + (["_kv_sk", "_kv_sv"] if int8
                                          else [])
            snap = {p: getattr(eng, p)[:, ids].clone() for p in pools}
            res = [r.wait(timeout=120) for r in eng.submit_many(
                [DecodeRequest(tokens=p, max_new_tokens=6) for p in rest])]
            torch.cuda.synchronize()
            assert eng.graphs_captured == captured
            assert eng.metrics.counter(
                "serving.decode.unexpected_captures") == 0
            assert eng._prefix_cache.stats()["hits"] == 3
            for p, before in snap.items():
                assert torch.equal(getattr(eng, p)[:, ids], before), p
            runs[graphs] = res
        finally:
            eng.stop()
    for a, b in zip(runs[True], runs[False]):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert np.float32(a.logp).tobytes() == np.float32(b.logp).tobytes()


def test_int8_handoff_import_on_the_card(card):
    """An int8 prefill-only export imported on a second warmed engine:
    the pages and scales land bit for bit, the imported slot decodes on
    the int8 paged kernel inside the graphs, and its tokens equal one
    engine's run; a float32 engine refuses the blob."""
    from bigdl_tpu_torch.ops import reset_launches
    from bigdl_tpu_torch.serving import DecodeRequest
    from bigdl_tpu_torch.serving.fleet import pack_handoff, unpack_handoff

    a = _serve_engine(card, True, int8=True).warmup()
    b = _serve_engine(card, True, int8=True).warmup()
    f32 = _serve_engine(card, True)
    try:
        p = _serve_prompts(1, seed=4)[0]
        ref = a.generate([p], max_new_tokens=8)[0]
        pre = a.submit(DecodeRequest(tokens=p, max_new_tokens=1,
                                     export_kv=True))
        pre.wait(timeout=120)
        h = unpack_handoff(pack_handoff(pre.kv_export))
        assert h["k"].dtype == np.int8
        reset_launches()
        got = b.submit_prefilled(h, max_new_tokens=8).wait(timeout=120)
        torch.cuda.synchronize()
        assert got.tokens.tolist() == ref.tokens.tolist()
        assert LAUNCHES["paged_decode_attention_int8"] == 2 * b.stats["steps"]
        assert b.graphs_captured == len(b.closed_set())
        assert b.metrics.counter("serving.decode.unexpected_captures") == 0
        with pytest.raises(ValueError, match="kv_dtype 'int8'"):
            f32.submit_prefilled(h)
    finally:
        for e in (a, b, f32):
            e.stop()


def test_windowed_speculation_captured_without_recapture(card_bf16):
    """``draft_window`` on the card: warmup captures every program of the
    closed set (the draft's ring at every bucket wider than the window),
    traffic reaching every bucket captures nothing more, and the verify
    and block-sparse kernels run (12 verify launches an iteration here:
    2 layers)."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.ops import reset_launches
    from bigdl_tpu_torch.optim.metrics import Metrics
    from bigdl_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                         DecodeRequest, LMAdapter,
                                         SpecConfig)

    cfg = DecodeConfig(**SERVE_GEOMETRY, speculative=SpecConfig(
        k=3, sparsity=0.5, draft_window=20))
    model = Transformer(**LM_SERVE, dropout=0.0, seed=0).to(card_bf16).eval()
    eng = DecodeEngine(LMAdapter(model, cfg.cap), cfg,
                       metrics=Metrics()).warmup()
    try:
        assert eng.graphs_captured == len(eng.closed_set())
        reset_launches()
        rs = np.random.RandomState(9)
        reqs = eng.submit_many([DecodeRequest(
            tokens=rs.randint(2, 256, int(n)).astype(np.int32),
            max_new_tokens=10) for n in (3, 20, 45, 110)])
        res = [r.wait(timeout=120) for r in reqs]
        torch.cuda.synchronize()
        assert all(len(r.tokens) >= 1 for r in res)
        assert eng.graphs_captured == len(eng.closed_set())
        assert eng.metrics.counter("serving.decode.unexpected_captures") == 0
        assert LAUNCHES["paged_verify_attention"] == 2 * eng.stats["steps"]
        assert LAUNCHES["block_sparse_matmul_bf16"] > 0
        buckets = {nb for name, nb, _ in eng.calls if name == "spec"}
        assert max(buckets) * cfg.page_size > 20       # the ring ran
    finally:
        eng.stop()


def test_seq2seq_engine_on_the_card(card):
    """A translation model through ``Seq2SeqService`` on the card,
    graphs beside eager: every decoder layer's self-attention on the
    paged kernel (layers x steps launches), no capture after warmup,
    finite scores, and the graphs' tokens and scores equal eager's to
    the bit (float32 products)."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.ops import reset_launches
    from bigdl_tpu_torch.serving import DecodeConfig, Seq2SeqService

    src = [np.random.RandomState(2).randint(2, 256, n).astype(np.int32)
           for n in (11, 5, 16)]
    out = []
    for graphs in (None, False):
        model = Transformer(256, 128, 2, ffn_size=256, num_layers=2,
                            dropout=0.0, mode="translation", seed=0)
        cfg = DecodeConfig(slots=4, page_size=8, pages_per_slot=2,
                           prompt_chunk=8, max_new_tokens=12, eos_id=1,
                           cuda_graphs=graphs)
        svc = Seq2SeqService(model, 0, 1, max_len=12, src_buckets=(8, 16),
                             decode_config=cfg, device=card).warmup()
        eng = svc.decode_engine
        try:
            captured = eng.graphs_captured
            reset_launches()
            toks, scores = svc.translate(src)
            torch.cuda.synchronize()
            steps = eng.stats["steps"]
            assert steps > 0
            assert LAUNCHES["paged_decode_attention"] == 2 * steps
            assert eng.graphs_captured == captured
            assert np.isfinite(scores).all()
            out.append((toks, scores))
        finally:
            svc.stop()
    (gt, gs), (et, es) = out
    assert np.array_equal(gt, et) and gs.tobytes() == es.tobytes()


def _server_lm(card, graphs):
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    model = Transformer(**LM_SERVE, dropout=0.0, seed=0)
    return InferenceModel(model, device=card, decode=DecodeConfig(
        **SERVE_GEOMETRY, cuda_graphs=graphs))


def test_server_captures_lazily_beside_a_busy_predict_tenant(card):
    """A ``ServingServer`` with an unwarmed decode tenant (its graphs
    captured at first use, on the engine thread) and a predict tenant
    under load from four client threads: no capture fails, the captures
    count as unexpected, every prediction equals the model's direct
    forward, and the tokens equal an eager engine's (each wave queued
    at once under the engine's iteration lock, so both engines run one
    schedule)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.serving import (InferenceModel, ServingConfig,
                                         ServingServer)

    torch.manual_seed(0)
    mlp = nn.Sequential([nn.Linear(64, 512), nn.ReLU(), nn.Linear(512, 64)])
    x_all = np.random.RandomState(1).rand(256, 64).astype(np.float32)
    want = InferenceModel(mlp, device=card).predict(x_all)
    lm = _server_lm(card, None)
    captures = lm.decode_engine.metrics.counter(
        "serving.decode.unexpected_captures")
    srv = ServingServer(models={"lm": lm, "mlp": InferenceModel(
        mlp, device=card)}, config=ServingConfig(batch_size=16)).start()
    stop, errors, served = False, [], [0]

    def client(i):
        rs = np.random.RandomState(10 + i)
        while not stop:
            rows = rs.randint(0, 256, rs.randint(1, 9))
            try:
                rid = srv.enqueue(x_all[rows], model="mlp")
                np.testing.assert_allclose(srv.query(rid, timeout=60),
                                           want[rows], rtol=1e-4,
                                           atol=1e-4)
                served[0] += 1
            except Exception as e:  # noqa: BLE001 — the failure is the bug
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    prompts = _serve_prompts()
    try:
        time.sleep(0.5)
        eng = lm.decode_engine
        with eng._iter_lock:
            rids = [srv.enqueue_generate(p, model="lm") for p in prompts]
        got = [srv.query(r, timeout=120).tolist() for r in rids]
    finally:
        stop = True
        for t in threads:
            t.join(60)
        srv.stop()
        lm.stop()
    assert not errors, errors[:3]
    assert served[0] > 0
    assert eng.metrics.counter(
        "serving.decode.unexpected_captures") > captures
    ref = _server_lm(card, False)
    try:
        assert [r.tolist() for r in ref.generate(prompts)] == got
    finally:
        ref.stop()


def test_http_stream_equals_generate_stream(card):
    """A streamed ``/generate`` over the HTTP frontend on the card gives
    the tokens of ``InferenceModel.generate_stream`` on the same warmed
    engine, greedy and sampled."""
    from bigdl_tpu_torch.serving import (HttpClient, HttpFrontend,
                                         ServingServer)

    im = _server_lm(card, None).warmup()
    # the registry is the process's: count from here
    captures = im.decode_engine.metrics.counter(
        "serving.decode.unexpected_captures")
    srv = ServingServer(im).start()
    fe = HttpFrontend(srv, port=0).start()
    try:
        for p, kw in zip(_serve_prompts(n=4), (
                {}, dict(temperature=1.1, top_k=20, top_p=0.9, seed=7),
                {}, dict(temperature=0.8, seed=3))):
            want = [int(t) for t in im.generate_stream(p, **kw)]
            got = [int(ev["token"]) for ev in HttpClient(fe.url).generate(
                p, stream=True, **kw) if "token" in ev]
            assert got == want and len(got) > 0
        assert im.decode_engine.metrics.counter(
            "serving.decode.unexpected_captures") == captures
    finally:
        fe.stop()
        srv.stop()
        im.stop()


def test_restored_masks_recapture_the_step_bundles(card):
    """ROADMAP C.20 on the card: a step whose bundles were captured on
    all-ones masks takes a pruned run's state at step 4 and its masks;
    its graphs are dropped and captured again on the pruned pattern, and
    its losses for steps 4-7 equal the uninterrupted pruned run's to the
    bit."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops.block_sparse import (BlockSparseLinear,
                                                  collect_masks,
                                                  prune_model_to_sparsity)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.optimizer import restore_block_sparse_masks
    from bigdl_tpu_torch.optim.train_step import TrainStep

    def model():
        g = torch.Generator().manual_seed(0)
        return nn.Sequential([
            BlockSparseLinear(64, 128, (32, 32), generator=g), nn.ReLU(),
            BlockSparseLinear(128, 8, (32, 32), generator=g),
            nn.LogSoftMax()]).to(card)

    rs = np.random.RandomState(0)
    xs = [torch.as_tensor(rs.randn(32, 64).astype(np.float32), device=card)
          for _ in range(8)]
    ys = [torch.as_tensor(rs.randint(0, 8, 32), device=card)
          for _ in range(8)]

    def step_of(m):
        return TrainStep(m, nn.ClassNLLCriterion(),
                         SGD(learning_rate=0.1, momentum=0.9))

    pruned = model()
    prune_model_to_sparsity(pruned, 0.5)
    masks = collect_masks(pruned)
    run, want = step_of(pruned), []
    for s in range(0, 8, 2):
        if s == 4:
            saved = run.checkpoint_arrays()
        want += run.train_bundle(s, xs[s:s + 2], ys[s:s + 2])[0].tolist()
    assert run.graphs_captured >= 1

    fresh = model()
    step = step_of(fresh)
    for s in range(0, 6, 2):
        step.train_bundle(s, xs[s:s + 2], ys[s:s + 2])
    assert step.graphs_captured >= 1
    step.restore(saved["flat_params"], saved["opt_state"],
                 saved["model_state"], saved["ema_flat"])
    assert restore_block_sparse_masks(fresh, step, masks) == 2
    assert step.graphs_captured == 0
    got = []
    for s in range(4, 8, 2):
        got += step.train_bundle(s, xs[s:s + 2], ys[s:s + 2])[0].tolist()
    assert step.graphs_captured >= 1
    assert got == want[4:]
