"""Transformer encoders — the port of ``bigdl_tpu.models.
transformer_zoo``: ``TransformerEncoder`` (embedding, sinusoidal
positions, pre-LN blocks, an optional classifier on the first token),
``BERT`` (token, position and segment embeddings, LayerNorm, blocks, a
tanh pooler) and ``BERTClassifier``.  Blocks are the children
``block_{i}``, the JAX params keys; block ``i``'s dropout key is
``prng.fold_in(key, i)``, as in the JAX package."""

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.attention import positional_encoding
from bigdl_tpu_torch.utils import prng


def _fold(key, i):
    return None if key is None else prng.fold_in(key, i)


class _Blocks:
    """Blocks registered as ``block_{i}``."""

    def _add_blocks(self, blocks) -> None:
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"block_{i}", blk)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_blocks)]

    def _run_blocks(self, x, key, mask):
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask=mask, key=_fold(key, i))
        return x


class TransformerEncoder(_Blocks, nn.Module):
    """Token trunk or classifier: embed + positions + ``layers`` blocks
    + LayerNorm, then ``head`` on the first token when ``num_classes``
    is given."""

    def __init__(self, vocab_size: int, hidden: int = 256, layers: int = 4,
                 heads: int = 4, max_len: int = 512, dropout: float = 0.1,
                 causal: bool = False, num_classes: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        g = generator
        self.embed = nn.Embedding(vocab_size, hidden, generator=g)
        self._add_blocks([nn.TransformerLayer(hidden, heads, dropout=dropout,
                                              causal=causal, generator=g)
                          for _ in range(layers)])
        self.ln = nn.LayerNorm(hidden)
        self.max_len = max_len
        self.hidden = hidden
        self.head = (nn.Linear(hidden, num_classes, generator=g)
                     if num_classes is not None else None)

    def forward(self, tokens, mask=None, key=None):
        if tokens.shape[1] > self.max_len:
            raise ValueError(f"sequence length {tokens.shape[1]} exceeds "
                             f"max_len {self.max_len}")
        x = self.embed(tokens)
        x = x + positional_encoding(x.shape[1], x.shape[2],
                                    device=x.device).to(x.dtype)
        x = self.ln(self._run_blocks(x, key, mask))
        return x if self.head is None else self.head(x[:, 0])


class BERT(_Blocks, nn.Module):
    """BERT-style encoder; ``forward`` returns (sequence output, tanh of
    the pooled first token).  ``mask`` (b, L), 1 for a real token."""

    def __init__(self, vocab_size: int, hidden: int = 256, layers: int = 4,
                 heads: int = 4, max_position: int = 512, type_vocab: int = 2,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        g = generator
        self.tok = nn.Embedding(vocab_size, hidden, generator=g)
        self.pos = nn.Embedding(max_position, hidden, generator=g)
        self.seg = nn.Embedding(type_vocab, hidden, generator=g)
        self.ln = nn.LayerNorm(hidden)
        self.dropout = nn.Dropout(dropout)
        self._add_blocks([nn.TransformerLayer(hidden, heads, dropout=dropout,
                                              generator=g)
                          for _ in range(layers)])
        self.pooler = nn.Linear(hidden, hidden, generator=g)
        self.hidden = hidden

    def forward(self, tokens, segments=None, mask=None, key=None):
        if segments is None:
            segments = torch.zeros_like(tokens)
        pos_ids = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = self.ln(self.tok(tokens) + self.pos(pos_ids)
                    + self.seg(segments))
        if key is not None:
            x = self.dropout(x, key)
        att_mask = None if mask is None else mask[:, None, None, :].bool()
        x = self._run_blocks(x, key, att_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BERTClassifier(nn.Module):
    """BERT with a Linear ``head`` on the pooled output."""

    def __init__(self, bert: BERT, num_classes: int,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.bert = bert
        self.head = nn.Linear(bert.hidden, num_classes, generator=generator)

    def forward(self, tokens, segments=None, mask=None, key=None):
        _, pooled = self.bert(tokens, segments, mask=mask, key=key)
        return self.head(pooled)
