"""Sequence models — the port of ``bigdl_tpu.models.rnn_zoo``: the
char/word LM (Embedding -> LSTMs -> TimeDistributed(Linear) ->
LogSoftMax, the reference's PTB model) and Seq2Seq (an encoder LSTM's
final state fed to a ``RecurrentDecoder``).  Weights come from
``generator``."""

from typing import Optional

import torch

from bigdl_tpu_torch import nn


def char_rnn(vocab_size: int, embed_dim: int = 64, hidden: int = 128,
             layers: int = 1,
             generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """Language model: log-probabilities (b, t, vocab) of the next
    token at every step."""
    g = generator
    mods = [nn.Embedding(vocab_size, embed_dim, generator=g)]
    d = embed_dim
    for _ in range(layers):
        mods.append(nn.LSTM(d, hidden, generator=g))
        d = hidden
    mods += [nn.TimeDistributed(nn.Linear(hidden, vocab_size, generator=g)),
             nn.LogSoftMax()]
    return nn.Sequential(mods)


class Seq2Seq(nn.Module):
    """Encoder LSTM -> autoregressive decoder -> a Linear at every step
    (params ``enc``, ``dec``, ``head``)."""

    def __init__(self, input_dim: int, hidden: int, output_len: int,
                 output_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        g = generator
        self.enc = nn.LSTM(input_dim, hidden, return_sequences=False,
                           generator=g)
        self.dec = nn.RecurrentDecoder(nn.LSTM(hidden, hidden, generator=g),
                                       seq_length=output_len)
        self.head = nn.TimeDistributed(nn.Linear(
            hidden, output_dim or input_dim, generator=g))

    def forward(self, x):
        return self.head(self.dec(self.enc(x)))
