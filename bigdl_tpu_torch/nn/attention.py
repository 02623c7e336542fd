"""Attention and Transformer blocks — the port of the language-model
half of ``bigdl_tpu.nn.attention``.

Only what the LM serves and trains through is here: attention with the
flash kernel dispatch (plain masked attention otherwise, and with
attention dropout; sequence parallelism is not ported), the FFN (dense,
or block-sparse with ``ffn_sparsity > 0``), the pre-LN block and
``Transformer(mode="lm")`` with its sqrt(d)-scaled embedding,
sinusoidal positions and weight-tied output projection.  Parameter names
and layouts follow the JAX params tree so
``bigdl_tpu_torch.utils.convert`` copies weights one to one.

Dropout draws from a key (``utils.prng``) that each forward splits as
the JAX modules split their rng: ``Transformer`` into one key for the
embedding and one per layer, ``TransformerLayer`` into four (attention
weights, attention residual, FFN, FFN residual).  Without a key nothing
is dropped in eval mode, and training with dropout > 0 raises."""

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.layers import Dropout, LayerNorm, Linear, xavier_
from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.tensor.policy import cast_compute
from bigdl_tpu_torch.utils import prng


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


def dot_product_attention(q, k, v, mask=None, dropout_p: float = 0.0,
                          key=None, training: bool = False):
    """q, k, v: (b, heads, len, dim).  ``mask`` broadcasts to
    (b, h, lq, lk), True = attend.  In training with ``dropout_p > 0``
    the attention weights are dropped with ``key``'s mask and rescaled
    by 1 / (1 - dropout_p)."""
    d = q.shape[-1]
    qc, kc = cast_compute(q, k)
    logits = torch.einsum("bhqd,bhkd->bhqk", qc, kc).float() / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        if key is None:
            raise ValueError("attention dropout needs a key when training "
                             "with dropout_p > 0")
        keep = 1.0 - dropout_p
        w = w * prng.bernoulli(key, keep, w.shape) / keep
    wc, vc = cast_compute(w, v)
    return torch.einsum("bhqk,bhkd->bhqd", wc, vc).float().to(q.dtype)


def _attn_project(attn, x, w, b):
    """``x @ attn.<w> + attn.<b>`` — one of the q/k/v projections."""
    y = torch.matmul(cast_compute(x), cast_compute(getattr(attn, w)))
    return (y.float() + getattr(attn, b)).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with q/k/v/out projections; weights
    (in, out) named ``wq wk wv wo`` with biases ``bq bk bv bo``.

    ``use_flash`` picks the attention as the JAX layer does: ``None``
    (auto) takes :func:`~bigdl_tpu_torch.ops.flash_attention.flash_attention`
    when there is no mask, no active attention dropout, the tensors are on
    CUDA and ``BIGDL_TPU_FLASH`` is not ``"0"`` (the JAX package's kill
    switch); ``True`` takes it on any device when there is no mask or
    active dropout (its plain version on the CPU); ``False`` never."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 generator: Optional[torch.Generator] = None,
                 use_flash: Optional[bool] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_flash = use_flash
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

    def forward(self, x, mask=None, key=None):
        q = self._split(_attn_project(self, x, "wq", "bq"))
        k = self._split(_attn_project(self, x, "wk", "bk"))
        v = self._split(_attn_project(self, x, "wv", "bv"))
        dropout_active = self.training and self.dropout.p > 0.0
        flash_ok = mask is None and not dropout_active
        if self.use_flash is None:
            use_flash = (flash_ok and q.is_cuda
                         and os.environ.get("BIGDL_TPU_FLASH") != "0")
        else:
            use_flash = self.use_flash and flash_ok
        if use_flash:
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            out = self._plain(q, k, v, mask, key)
        b, h, t, dh = out.shape
        out = out.transpose(1, 2).reshape(b, t, h * dh)
        return _attn_project(self, out, "wo", "bo").to(x.dtype)

    def _plain(self, q, k, v, mask, key=None):
        if self.causal:
            lq, lk = q.shape[2], k.shape[2]
            cmask = torch.ones(lq, lk, dtype=torch.bool,
                               device=q.device).tril()
            mask = cmask if mask is None else (mask & cmask)
        return dot_product_attention(q, k, v, mask=mask,
                                     dropout_p=self.dropout.p, key=key,
                                     training=self.training)


class PositionwiseFFN(nn.Module):
    """The transformer FFN: Linear, GELU, Linear.  GELU is the tanh
    approximation, as ``jax.nn.gelu`` defaults to.  ``ffn_sparsity > 0``
    makes both Linears :class:`~bigdl_tpu_torch.ops.block_sparse.BlockSparseLinear`
    with ``sparse_block`` tiles: dense until a pruning event masks them,
    then through the block-sparse kernel."""

    def __init__(self, hidden_size: int, ffn_size: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64)):
        super().__init__()
        self.ffn_sparsity = float(ffn_sparsity)
        if ffn_sparsity > 0.0:
            # imported here: ops.block_sparse imports nn.layers
            from bigdl_tpu_torch.ops.block_sparse import BlockSparseLinear

            self.l1 = BlockSparseLinear(hidden_size, ffn_size,
                                        block_shape=sparse_block,
                                        target_sparsity=ffn_sparsity,
                                        generator=generator)
            self.l2 = BlockSparseLinear(ffn_size, hidden_size,
                                        block_shape=sparse_block,
                                        target_sparsity=ffn_sparsity,
                                        generator=generator)
        else:
            self.l1 = Linear(hidden_size, ffn_size, generator=generator)
            self.l2 = Linear(ffn_size, hidden_size, generator=generator)
        self.dropout = Dropout(dropout)

    def forward(self, x, key=None):
        h = F.gelu(self.l1(x), approximate="tanh")
        if key is not None:
            h = self.dropout(h, key)
        return self.l2(h)


class TransformerLayer(nn.Module):
    """Pre-LN transformer block: x + attn(ln1(x)), then + ffn(ln2(x)).
    ``key`` splits into four: attention weights, attention residual,
    FFN, FFN residual."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int = 0,
                 dropout: float = 0.1, causal: bool = False,
                 generator: Optional[torch.Generator] = None,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64)):
        super().__init__()
        self.attn = MultiHeadAttention(hidden_size, num_heads,
                                       attn_dropout=dropout, causal=causal,
                                       generator=generator)
        self.ffn = PositionwiseFFN(hidden_size, ffn_size or 4 * hidden_size,
                                   dropout=dropout, generator=generator,
                                   ffn_sparsity=ffn_sparsity,
                                   sparse_block=sparse_block)
        self.ln1 = LayerNorm(hidden_size)
        self.ln2 = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None, key=None):
        r1 = r2 = r3 = r4 = None
        if key is not None:
            r1, r2, r3, r4 = prng.split(key, 4)
        a = self.attn(self.ln1(x), mask=mask, key=r1)
        if r2 is not None:
            a = self.dropout(a, r2)
        x = x + a
        f = self.ffn(self.ln2(x), key=r3)
        if r4 is not None:
            f = self.dropout(f, r4)
        return x + f


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
                 dropout: float = 0.1, mode: str = "lm", seed: int = 0,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64)):
        super().__init__()
        if mode != "lm":
            raise ValueError(f"mode {mode!r}: only 'lm' is ported yet "
                             "(translation comes with its own slice)")
        g = torch.Generator().manual_seed(seed)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.mode = mode
        self.ffn_sparsity = float(ffn_sparsity)
        self.embedding = nn.Parameter(
            torch.randn(vocab_size, hidden_size, generator=g)
            * hidden_size ** -0.5)
        self.decoder = nn.ModuleList(
            TransformerLayer(hidden_size, num_heads, ffn_size, dropout,
                             causal=True, generator=g,
                             ffn_sparsity=ffn_sparsity,
                             sparse_block=sparse_block)
            for _ in range(num_layers))
        self.ln_out = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)
        self.train(False)

    def _embed(self, ids):
        e = self.embedding[ids.long()] * math.sqrt(self.hidden_size)
        return e + positional_encoding(ids.shape[1], self.hidden_size,
                                       device=e.device)[None].to(e.dtype)

    def forward(self, ids, key=None):
        """Logits of ``ids``; ``key`` (``utils.prng``) seeds dropout in
        training: one key for the embedding, one per layer."""
        h = self._embed(ids)
        rs = None
        if key is not None:
            rs = prng.split(key, len(self.decoder) + 1)
            h = self.dropout(h, rs[0])
        for i, layer in enumerate(self.decoder):
            h = layer(h, key=None if rs is None else rs[i + 1])
        h = self.ln_out(h)
        logits = torch.matmul(cast_compute(h),
                              cast_compute(self.embedding).T)
        return logits.float()
