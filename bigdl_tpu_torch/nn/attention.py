"""Attention and Transformer blocks — the port of
``bigdl_tpu.nn.attention``.

Attention with the flash kernel dispatch (plain masked attention
otherwise, and with attention dropout; sequence parallelism is not
ported), self or cross (``context=``, the keys and values projected from
the encoder's memory), on plain tensors or on a layout's DTensors (the
attention and the embedding lookup then run on each rank's shards,
``parallel.local_ops``), the FFN (dense, or block-sparse with
``ffn_sparsity > 0``), the pre-LN encoder and decoder blocks, and
``Transformer`` in both modes: ``"translation"`` (encoder, causal
decoder with cross-attention) and ``"lm"``, each with its sqrt(d)-scaled
embedding, sinusoidal positions and weight-tied output projection; and
the translation model's decoding, :func:`transformer_decode` (greedy or
beam search over the whole prefix) and :func:`transformer_decode_cached`
(per-layer K/V buffers, greedy or sampled).  Parameter names
and layouts follow the JAX params tree so
``bigdl_tpu_torch.utils.convert`` copies weights one to one.  Each
block is a port ``Module``, with a ``name``, so it can be a node of a
keras graph (``MultiHeadAttention(d, heads)(node)``).

Dropout draws from a key (``utils.prng``) that each forward splits as
the JAX modules split their rng: ``Transformer`` into one key for the
embedding and one per layer (encoder, then decoder), ``TransformerLayer``
into four (attention weights, attention residual, FFN, FFN residual),
``TransformerDecoderLayer`` into three (self-attention, cross-attention,
FFN; no residual dropout, as in JAX).  Without a key nothing is dropped
in eval mode, and training with dropout > 0 raises."""

import functools
import math
import os
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.decode import (beam_search, greedy_decode,
                                      sample_decode)
from bigdl_tpu_torch.nn.layers import Dropout, LayerNorm, Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.parallel import local_ops
from bigdl_tpu_torch.tensor.policy import matmul_f32, matmul_promote
from bigdl_tpu_torch.utils import prng


def positional_encoding(length: int, dim: int,
                        device=None) -> torch.Tensor:
    """Sinusoidal positions (length, dim): sin on even columns, cos on
    odd ones; an odd ``dim`` gives sin ceil(dim/2) columns."""
    n_sin = (dim + 1) // 2
    pos = torch.arange(length, device=device)[:, None].float()
    i = torch.arange(n_sin, device=device)[None, :].float()
    # a fill on the device, not a host copy that waits: the forward runs
    # inside captured training steps
    angle = pos / torch.pow(torch.full((), 10000.0, device=device),
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
    logits = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        if key is None:
            raise ValueError("attention dropout needs a key when training "
                             "with dropout_p > 0")
        keep = 1.0 - dropout_p
        w = w * prng.bernoulli(key, keep, w.shape) / keep
    return matmul_f32(w, v).to(q.dtype)


def _attn_project(attn, x, w, b):
    """``x @ attn.<w> + attn.<b>`` — one of the q/k/v projections."""
    y = matmul_f32(x, getattr(attn, w))
    return (y + getattr(attn, b)).to(x.dtype)


class MultiHeadAttention(Module):
    """Multi-head attention with q/k/v/out projections; weights (in, out)
    named ``wq wk wv wo`` with biases ``bq bk bv bo``.  With ``context``
    (cross-attention) the keys and values are projected from it, the
    queries from ``x``; ``context_size`` is the context's width when it
    differs from ``hidden_size``.

    ``use_flash`` picks the attention as the JAX layer does: ``None``
    (auto) takes :func:`~bigdl_tpu_torch.ops.flash_attention.flash_attention`
    when there is no mask, no active attention dropout, the tensors are on
    CUDA and ``BIGDL_TPU_FLASH`` is not ``"0"`` (the JAX package's kill
    switch); ``True`` takes it on any device when there is no mask or
    active dropout (its plain version on the CPU); ``False`` never."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 generator: Optional[torch.Generator] = None,
                 use_flash: Optional[bool] = None,
                 context_size: Optional[int] = None, name=None):
        super().__init__(name)
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_flash = use_flash
        self.dropout = Dropout(attn_dropout)
        d, dc = hidden_size, context_size or hidden_size
        for w, b, fan_in in (("wq", "bq", d), ("wk", "bk", dc),
                             ("wv", "bv", dc), ("wo", "bo", d)):
            setattr(self, w, nn.Parameter(
                init.xavier(generator, (fan_in, d), fan_in, d)))
            setattr(self, b, nn.Parameter(torch.zeros(d)))

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, x, mask=None, key=None, context=None):
        ctx = x if context is None else context
        q = self._split(_attn_project(self, x, "wq", "bq"))
        k = self._split(_attn_project(self, ctx, "wk", "bk").to(x.dtype))
        v = self._split(_attn_project(self, ctx, "wv", "bv").to(x.dtype))
        dropout_active = self.training and self.dropout.p > 0.0
        flash_ok = mask is None and not dropout_active
        if self.use_flash is None:
            use_flash = (flash_ok and q.is_cuda
                         and os.environ.get("BIGDL_TPU_FLASH") != "0")
        else:
            use_flash = self.use_flash and flash_ok
        if flash_ok and local_ops.is_dtensor(q):
            # a layout: the flash kernels or the plain attention on each
            # rank's local batch and heads
            out = local_ops.attention(
                functools.partial(flash_attention, causal=self.causal)
                if use_flash else self._plain, q, k, v)
        elif use_flash:
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            out = self._plain(q, k, v, mask, key)
        b, h, t, dh = out.shape
        out = out.transpose(1, 2).reshape(b, t, h * dh)
        return _attn_project(self, out, "wo", "bo").to(x.dtype)

    def _plain(self, q, k, v, mask=None, key=None):
        if self.causal:
            lq, lk = q.shape[2], k.shape[2]
            cmask = torch.ones(lq, lk, dtype=torch.bool,
                               device=q.device).tril()
            mask = cmask if mask is None else (mask & cmask)
        return dot_product_attention(q, k, v, mask=mask,
                                     dropout_p=self.dropout.p, key=key,
                                     training=self.training)


class PositionwiseFFN(Module):
    """The transformer FFN: Linear, GELU, Linear.  GELU is the tanh
    approximation, as ``jax.nn.gelu`` defaults to.  ``ffn_sparsity > 0``
    makes both Linears :class:`~bigdl_tpu_torch.ops.block_sparse.BlockSparseLinear`
    with ``sparse_block`` tiles: dense until a pruning event masks them,
    then through the block-sparse kernel."""

    def __init__(self, hidden_size: int, ffn_size: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64),
                 name=None):
        super().__init__(name)
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


class TransformerLayer(Module):
    """Pre-LN transformer block: x + attn(ln1(x)), then + ffn(ln2(x)).
    ``key`` splits into four: attention weights, attention residual,
    FFN, FFN residual."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int = 0,
                 dropout: float = 0.1, causal: bool = False,
                 generator: Optional[torch.Generator] = None,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64),
                 name=None):
        super().__init__(name)
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


class TransformerDecoderLayer(Module):
    """Pre-LN decoder block: causal self-attention, cross-attention over
    the encoder's ``memory``, then the FFN, each added to the residual.
    ``key`` splits into three: self-attention, cross-attention, FFN."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int = 0,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64),
                 name=None):
        super().__init__(name)
        self.self_attn = MultiHeadAttention(hidden_size, num_heads,
                                            attn_dropout=dropout,
                                            causal=True, generator=generator)
        self.cross_attn = MultiHeadAttention(hidden_size, num_heads,
                                             attn_dropout=dropout,
                                             generator=generator)
        self.ffn = PositionwiseFFN(hidden_size, ffn_size or 4 * hidden_size,
                                   dropout=dropout, generator=generator,
                                   ffn_sparsity=ffn_sparsity,
                                   sparse_block=sparse_block)
        self.ln1 = LayerNorm(hidden_size)
        self.ln2 = LayerNorm(hidden_size)
        self.ln3 = LayerNorm(hidden_size)

    def forward(self, x, memory, memory_mask=None, key=None):
        r1 = r2 = r3 = None
        if key is not None:
            r1, r2, r3 = prng.split(key, 3)
        x = x + self.self_attn(self.ln1(x), key=r1)
        x = x + self.cross_attn(self.ln2(x), mask=memory_mask, key=r2,
                                context=memory)
        return x + self.ffn(self.ln3(x), key=r3)


class Transformer(Module):
    """Encoder-decoder (``mode="translation"``, ``forward(src, tgt)``:
    ``num_layers`` pre-LN encoder blocks ``encoder``, ``num_layers``
    decoder blocks ``decoder`` with cross-attention) or causal language
    model (``mode="lm"``, ``forward(ids)``: ``num_layers`` causal blocks
    ``decoder``).  The token embedding, scaled by sqrt(d) plus
    sinusoidal positions, feeds both sides and is tied to the output
    projection after ``ln_out``; logits are float32 (b, t, vocab).

    Weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed``; move the model with ``.to()``.  The
    model is built in inference mode (dropout off), as the JAX forward
    defaults to ``training=False``."""

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 ffn_size: int = 0, num_layers: int = 2,
                 dropout: float = 0.1, mode: str = "lm", seed: int = 0,
                 ffn_sparsity: float = 0.0, sparse_block=(64, 64),
                 name=None):
        super().__init__(name)
        if mode not in ("translation", "lm"):
            raise ValueError(f"mode {mode!r}: translation | lm")
        g = torch.Generator().manual_seed(seed)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.mode = mode
        self.ffn_sparsity = float(ffn_sparsity)
        self.embedding = nn.Parameter(
            torch.randn(vocab_size, hidden_size, generator=g)
            * hidden_size ** -0.5)
        sparse = dict(ffn_sparsity=ffn_sparsity, sparse_block=sparse_block)
        if mode == "translation":
            self.encoder = nn.ModuleList(
                TransformerLayer(hidden_size, num_heads, ffn_size, dropout,
                                 generator=g, **sparse)
                for _ in range(num_layers))
            self.decoder = nn.ModuleList(
                TransformerDecoderLayer(hidden_size, num_heads, ffn_size,
                                        dropout, generator=g, **sparse)
                for _ in range(num_layers))
        else:
            self.encoder = nn.ModuleList()
            self.decoder = nn.ModuleList(
                TransformerLayer(hidden_size, num_heads, ffn_size, dropout,
                                 causal=True, generator=g, **sparse)
                for _ in range(num_layers))
        self.ln_out = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)
        self.train(False)

    def _embed(self, ids):
        if local_ops.is_dtensor(self.embedding):
            # a layout: each rank's rows of the table (vocab_lookup)
            e = local_ops.vocab_lookup(self.embedding, ids)
        else:
            e = self.embedding[ids.long()]
        e = e * math.sqrt(self.hidden_size)
        return e + positional_encoding(ids.shape[1], self.hidden_size,
                                       device=e.device)[None].to(e.dtype)

    def encode(self, src, keys=None):
        """The encoder's memory of ``src``; ``keys``: one per encoder
        layer."""
        x = self._embed(src)
        for i, layer in enumerate(self.encoder):
            x = layer(x, key=None if keys is None else keys[i])
        return x

    def project(self, h):
        """``ln_out`` then the tied output projection: float32 logits."""
        return matmul_f32(self.ln_out(h), self.embedding.T)

    def forward(self, src, tgt=None, key=None):
        """Logits of ``src`` (lm) or of ``tgt`` given ``src``
        (translation); ``key`` (``utils.prng``) seeds dropout in
        training: one key for the source embedding, one per layer."""
        n_enc = len(self.encoder)
        rs = None
        if key is not None:
            rs = prng.split(key, n_enc + len(self.decoder) + 1)
        x = self._embed(src)
        if rs is not None:
            x = self.dropout(x, rs[0])
        for i, layer in enumerate(self.encoder):
            x = layer(x, key=None if rs is None else rs[1 + i])
        if self.mode == "translation":
            if tgt is None:
                raise ValueError("translation mode needs (src, tgt)")
            h = self._embed(tgt)
            for i, layer in enumerate(self.decoder):
                h = layer(h, x, key=None if rs is None else rs[1 + n_enc + i])
        else:
            h = x
            for i, layer in enumerate(self.decoder):
                h = layer(h, key=None if rs is None else rs[1 + i])
        return self.project(h)


@contextmanager
def _decoding(model):
    """A translation model in eval mode (no dropout) for a decode, its
    mode restored after."""
    if model.mode != "translation":
        raise ValueError("decode needs a translation-mode Transformer")
    was = model.training
    model.train(False)
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def transformer_decode(model: Transformer, src, bos_id: int, eos_id: int,
                       max_len: int = 32, beam_size: int = 0,
                       length_penalty: float = 0.6):
    """Autoregressive decode of a translation :class:`Transformer` in eval
    mode: the decoder re-attends over the whole fixed-length prefix
    (``max_len + 1`` tokens, BOS-filled) at every step, as the JAX
    package's one ``lax.scan`` does.  ``beam_size`` 0 or 1 is greedy
    (``nn.decode.greedy_decode``), more is beam search with the GNMT
    length penalty.  Returns (tokens, scores): tokens (b, max_len+1)
    greedy or (b, beam, max_len+1), BOS included; the greedy scores are
    the summed log-probs, the beams' the normalized ones."""
    with _decoding(model):
        return _decode_uncached(model, src, bos_id, eos_id, max_len,
                                beam_size, length_penalty)


def _decode_uncached(model, src, bos_id, eos_id, max_len, beam_size,
                     length_penalty):
    b = src.shape[0]
    memory = model.encode(src)
    state = {"memory": memory,
             "prefix": torch.full((b, max_len + 1), bos_id,
                                  dtype=torch.int32, device=src.device),
             "pos": torch.zeros(b, dtype=torch.int32, device=src.device)}

    def step_fn(last, st):
        pos = int(st["pos"][0])                   # equal in every row
        prefix = st["prefix"].clone()
        prefix[:, pos] = last
        h = model._embed(prefix)
        for layer in model.decoder:
            h = layer(h, st["memory"])
        logits = model.project(h)[:, pos]
        return logits, {"memory": st["memory"], "prefix": prefix,
                        "pos": st["pos"] + 1}

    if beam_size and beam_size > 1:
        res = beam_search(step_fn, state, b, model.vocab_size, bos_id,
                          eos_id, beam_size=beam_size, max_len=max_len,
                          length_penalty=length_penalty, device=src.device)
        return res.tokens, res.scores
    tokens, log_probs, _ = greedy_decode(step_fn, state, b, bos_id, eos_id,
                                         max_len=max_len, device=src.device)
    return tokens, log_probs


def _cached_attention(q, k, v, valid=None):
    """Float32 attention of one query a row over a cache: q (b, h, 1,
    hd), k and v (b, h, n, hd); ``valid`` masks cache positions."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    if valid is not None:
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return torch.matmul(torch.softmax(logits, dim=-1), v.float())


def transformer_decode_cached(model: Transformer, src, bos_id: int,
                              eos_id: int, max_len: int = 32, *, key=None,
                              temperature: float = 1.0, top_k: int = 0,
                              top_p: float = 1.0):
    """Greedy (or, with ``key``, sampled: ``nn.decode.sample_decode``)
    decode with per-layer K/V buffers: one token's attention a step over
    the cache instead of the decoder over the whole prefix, and the
    cross-attention's keys and values computed once from the memory.
    The numerics are the JAX function's: the cached attention runs in
    float32 and its output projection promotes to float32.  Returns
    (tokens (b, max_len+1), log_probs (b,))."""
    with _decoding(model):
        return _decode_cached(model, src, bos_id, eos_id, max_len, key,
                              temperature, top_k, top_p)


def _decode_cached(model, src, bos_id, eos_id, max_len, key, temperature,
                   top_k, top_p):
    b, dev = src.shape[0], src.device
    d = model.hidden_size
    mem = model.encode(src)
    layers = list(model.decoder)
    nh, hd = layers[0].self_attn.num_heads, layers[0].self_attn.head_dim

    def heads(x):                      # (b, t, d) -> (b, h, t, hd)
        return x.reshape(b, -1, nh, hd).transpose(1, 2)

    def out_project(attn, a, x):
        a = a.transpose(1, 2).reshape(b, 1, nh * hd)
        return (matmul_promote(a.to(x.dtype), attn.wo) + attn.bo).to(x.dtype)

    cross_kv = [(heads(_attn_project(l.cross_attn, mem, "wk", "bk")),
                 heads(_attn_project(l.cross_attn, mem, "wv", "bv")))
                for l in layers]
    pe = positional_encoding(max_len + 1, d, device=dev)
    scale = math.sqrt(d)
    state = {"k": torch.zeros(b, len(layers), nh, max_len, hd, device=dev),
             "v": torch.zeros(b, len(layers), nh, max_len, hd, device=dev),
             "pos": torch.zeros(b, dtype=torch.int32, device=dev)}
    span = torch.arange(max_len, device=dev)

    def step_fn(last, st):
        pos = int(st["pos"][0])
        x = (model.embedding[last.long()] * scale + pe[pos])[:, None, :]
        ks, vs = st["k"].clone(), st["v"].clone()
        valid = (span <= pos)[None, None, None, :]
        for i, layer in enumerate(layers):
            sa = layer.self_attn
            h = layer.ln1(x)
            q = heads(_attn_project(sa, h, "wq", "bq"))
            ks[:, i, :, pos] = heads(_attn_project(sa, h, "wk", "bk"))[:, :, 0]
            vs[:, i, :, pos] = heads(_attn_project(sa, h, "wv", "bv"))[:, :, 0]
            x = x + out_project(sa, _cached_attention(q, ks[:, i], vs[:, i],
                                                      valid), x)
            ca = layer.cross_attn
            q = heads(_attn_project(ca, layer.ln2(x), "wq", "bq"))
            ck, cv = cross_kv[i]
            x = x + out_project(ca, _cached_attention(q, ck, cv), x)
            x = x + layer.ffn(layer.ln3(x))
        logits = model.project(x)[:, 0]
        return logits, {"k": ks, "v": vs, "pos": st["pos"] + 1}

    if key is not None:
        tokens, log_probs, _ = sample_decode(
            step_fn, state, b, bos_id, eos_id, key, max_len=max_len,
            temperature=temperature, top_k=top_k, top_p=top_p, device=dev)
    else:
        tokens, log_probs, _ = greedy_decode(
            step_fn, state, b, bos_id, eos_id, max_len=max_len, device=dev)
    return tokens, log_probs
