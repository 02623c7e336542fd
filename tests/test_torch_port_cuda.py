"""The port's CUDA kernels against their plain versions on the card, at
small shapes.  Every test here needs a CUDA card: without one it skips.
The file imports neither JAX nor the JAX package, so it also runs where
only the port is installed; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: float32 sums in another order, rtol and atol 1e-4."""

import pytest
import torch

from bigdl_tpu_torch.nn import MultiHeadAttention
from bigdl_tpu_torch.ops import (LAUNCHES, flash_attention_bwd,
                                 flash_attention_bwd_ref, flash_attention_fwd,
                                 flash_attention_fwd_ref)
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
