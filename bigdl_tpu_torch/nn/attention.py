"""Attention and Transformer blocks — the port of the language-model
half of ``bigdl_tpu.nn.attention``.

Only what the served LM runs is here: plain masked attention (the flash
training kernel and sequence parallelism come with the training slice),
the dense FFN, the pre-LN block and ``Transformer(mode="lm")`` with its
sqrt(d)-scaled embedding, sinusoidal positions and weight-tied output
projection.  Parameter names and layouts follow the JAX params tree so
``bigdl_tpu_torch.utils.convert`` copies weights one to one."""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.layers import Dropout, LayerNorm, Linear, xavier_
from bigdl_tpu_torch.tensor.policy import cast_compute


def positional_encoding(length: int, dim: int,
                        device=None) -> torch.Tensor:
    """Sinusoidal positions (length, dim): sin on even columns, cos on
    odd ones; an odd ``dim`` gives sin ceil(dim/2) columns."""
    n_sin = (dim + 1) // 2
    pos = torch.arange(length, device=device)[:, None].float()
    i = torch.arange(n_sin, device=device)[None, :].float()
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * i / dim)
    pe = torch.zeros(length, dim, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : dim // 2])
    return pe


def dot_product_attention(q, k, v, mask=None):
    """q, k, v: (b, heads, len, dim).  ``mask`` broadcasts to
    (b, h, lq, lk), True = attend."""
    d = q.shape[-1]
    qc, kc = cast_compute(q, k)
    logits = torch.einsum("bhqd,bhkd->bhqk", qc, kc).float() / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1)
    wc, vc = cast_compute(w, v)
    return torch.einsum("bhqk,bhkd->bhqd", wc, vc).float().to(q.dtype)


def _attn_project(attn, x, w, b):
    """``x @ attn.<w> + attn.<b>`` — one of the q/k/v projections."""
    y = torch.matmul(cast_compute(x), cast_compute(getattr(attn, w)))
    return (y.float() + getattr(attn, b)).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with q/k/v/out projections; weights
    (in, out) named ``wq wk wv wo`` with biases ``bq bk bv bo``."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.dropout = Dropout(attn_dropout)
        d = hidden_size
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"),
                     ("wo", "bo")):
            setattr(self, w, nn.Parameter(
                xavier_(torch.empty(d, d), d, d, generator)))
            setattr(self, b, nn.Parameter(torch.zeros(d)))

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, x, mask=None):
        q = self._split(_attn_project(self, x, "wq", "bq"))
        k = self._split(_attn_project(self, x, "wk", "bk"))
        v = self._split(_attn_project(self, x, "wv", "bv"))
        if self.training and self.dropout.p > 0.0:
            raise NotImplementedError("attention dropout in training is not "
                                      "ported yet")
        if self.causal:
            lq, lk = q.shape[2], k.shape[2]
            cmask = torch.ones(lq, lk, dtype=torch.bool,
                               device=x.device).tril()
            mask = cmask if mask is None else (mask & cmask)
        out = dot_product_attention(q, k, v, mask=mask)
        b, h, t, dh = out.shape
        out = out.transpose(1, 2).reshape(b, t, h * dh)
        return _attn_project(self, out, "wo", "bo").to(x.dtype)


class PositionwiseFFN(nn.Module):
    """The transformer FFN: Linear, GELU, Linear.  GELU is the tanh
    approximation, as ``jax.nn.gelu`` defaults to."""

    def __init__(self, hidden_size: int, ffn_size: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l1 = Linear(hidden_size, ffn_size, generator=generator)
        self.l2 = Linear(ffn_size, hidden_size, generator=generator)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        h = F.gelu(self.l1(x), approximate="tanh")
        return self.l2(self.dropout(h))


class TransformerLayer(nn.Module):
    """Pre-LN transformer block: x + attn(ln1(x)), then + ffn(ln2(x))."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int = 0,
                 dropout: float = 0.1, causal: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = MultiHeadAttention(hidden_size, num_heads,
                                       attn_dropout=dropout, causal=causal,
                                       generator=generator)
        self.ffn = PositionwiseFFN(hidden_size, ffn_size or 4 * hidden_size,
                                   dropout=dropout, generator=generator)
        self.ln1 = LayerNorm(hidden_size)
        self.ln2 = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        x = x + self.dropout(self.attn(self.ln1(x), mask=mask))
        return x + self.dropout(self.ffn(self.ln2(x)))


class Transformer(nn.Module):
    """Causal language model (``mode="lm"``): token embedding scaled by
    sqrt(d) plus sinusoidal positions, ``num_layers`` causal pre-LN
    blocks, ``ln_out``, and the output projection tied to the embedding.
    ``forward(ids)`` returns float32 logits (b, t, vocab).

    Weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed``; move the model with ``.to()``.  The
    model is built in inference mode (dropout off), as the JAX forward
    defaults to ``training=False``."""

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 ffn_size: int = 0, num_layers: int = 2,
                 dropout: float = 0.1, mode: str = "lm", seed: int = 0):
        super().__init__()
        if mode != "lm":
            raise ValueError(f"mode {mode!r}: only 'lm' is ported yet "
                             "(translation comes with its own slice)")
        g = torch.Generator().manual_seed(seed)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.mode = mode
        self.embedding = nn.Parameter(
            torch.randn(vocab_size, hidden_size, generator=g)
            * hidden_size ** -0.5)
        self.decoder = nn.ModuleList(
            TransformerLayer(hidden_size, num_heads, ffn_size, dropout,
                             causal=True, generator=g)
            for _ in range(num_layers))
        self.ln_out = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)
        self.train(False)

    def _embed(self, ids):
        e = self.embedding[ids.long()] * math.sqrt(self.hidden_size)
        return e + positional_encoding(ids.shape[1], self.hidden_size,
                                       device=e.device)[None].to(e.dtype)

    def forward(self, ids):
        h = self.dropout(self._embed(ids))
        for layer in self.decoder:
            h = layer(h)
        h = self.ln_out(h)
        logits = torch.matmul(cast_compute(h),
                              cast_compute(self.embedding).T)
        return logits.float()
