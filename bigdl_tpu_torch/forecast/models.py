"""Forecasting trunks — the port of ``bigdl_tpu.forecast.models``: TCN,
the stacked-LSTM net, Seq2Seq and N-Beats, each a ``torch.nn.Module``
whose parameters are named as the JAX package keys them
(``block_0.conv1.weight``, ``lstm_0.w_in``, ``enc.w_in``, ``head.weight``
...).  Input (b, lookback, in_dim), output (b, horizon, out_dim).

Dropout is the JAX models' own: ``h * bernoulli(fold_in(key, i), keep) /
keep`` with the JAX keys (``utils.prng``), through a ``Dropout`` child
that draws it and has no parameters."""

from typing import Optional, Sequence

import torch

from bigdl_tpu_torch.nn.layers import Conv1D, Dropout, Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.rnn import LSTM
from bigdl_tpu_torch.utils import prng


def _fold(key, i):
    return None if key is None else prng.fold_in(key, i)


def _dropout(drop: Dropout, h, key, i):
    """``drop`` with the key ``fold_in(key, i)``; without a key the JAX
    models skip their dropout, and so does this."""
    return h if key is None else drop(h, key=prng.fold_in(key, i))


class TCNBlock(Module):
    """Two dilated causal convs and a residual (a 1x1 conv when the
    widths differ), ReLU after each conv and after the sum; dropout
    after the first two ReLUs (keys ``fold_in(key, 1)``, ``(key, 2)``)."""

    def __init__(self, cin, cout, kernel_size, dilation, dropout=0.1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.conv1 = Conv1D(cin, cout, kernel_size, causal=True,
                            dilation=dilation, generator=generator)
        self.conv2 = Conv1D(cout, cout, kernel_size, causal=True,
                            dilation=dilation, generator=generator)
        self.down = (Conv1D(cin, cout, 1, generator=generator)
                     if cin != cout else None)
        self.drop = Dropout(dropout)

    def forward(self, x, key=None):
        h = _dropout(self.drop, torch.relu(self.conv1(x)), key, 1)
        h = _dropout(self.drop, torch.relu(self.conv2(h)), key, 2)
        res = x if self.down is None else self.down(x)
        return torch.relu(h + res)


class TCN(Module):
    """Stacked TCN blocks (dilation ``2 ** i``) and a Linear head from the
    last time step to ``horizon * out_dim``."""

    def __init__(self, in_dim: int, out_dim: int, horizon: int,
                 channels: Sequence[int] = (32, 32), kernel_size: int = 3,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        cin = in_dim
        self.n_blocks = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"block_{i}", TCNBlock(cin, c, kernel_size,
                                                 2 ** i, dropout, generator))
            cin = c
        self.horizon, self.out_dim = horizon, out_dim
        self.head = Linear(cin, horizon * out_dim, generator=generator)

    def forward(self, x, key=None):
        h = x
        for i in range(self.n_blocks):
            h = getattr(self, f"block_{i}")(h, key=_fold(key, i))
        y = self.head(h[:, -1])
        return y.reshape(x.shape[0], self.horizon, self.out_dim)


class LSTMForecastNet(Module):
    """Stacked LSTMs over the lookback window (dropout between layers,
    key ``fold_in(key, i)``) and a Linear head off the last hidden
    state."""

    def __init__(self, in_dim: int, out_dim: int, horizon: int,
                 hidden: int = 64, layers: int = 2, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.n_layers = layers
        for i in range(layers):
            setattr(self, f"lstm_{i}", LSTM(in_dim if i == 0 else hidden,
                                            hidden, return_sequences=True,
                                            generator=generator))
        self.horizon, self.out_dim = horizon, out_dim
        self.drop = Dropout(dropout)
        self.head = Linear(hidden, horizon * out_dim, generator=generator)

    def forward(self, x, key=None):
        h = x
        for i in range(self.n_layers):
            h = getattr(self, f"lstm_{i}")(h)
            if i < self.n_layers - 1:
                h = _dropout(self.drop, h, key, i)
        y = self.head(h[:, -1])
        return y.reshape(x.shape[0], self.horizon, self.out_dim)


class Seq2SeqNet(Module):
    """An LSTM encoder whose final (h, c) starts an autoregressive LSTM
    decoder: each of the ``horizon`` steps reads the previous prediction
    (zeros first) and a Linear head maps its h to the next one."""

    def __init__(self, in_dim: int, out_dim: int, horizon: int,
                 hidden: int = 64,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.enc = LSTM(in_dim, hidden, return_sequences=False,
                        generator=generator)
        self.dec = LSTM(out_dim, hidden, return_sequences=True,
                        generator=generator)
        self.head = Linear(hidden, out_dim, generator=generator)
        self.horizon, self.out_dim, self.hidden = horizon, out_dim, hidden

    def forward(self, x):
        b = x.shape[0]
        x_proj = self.enc._project(x)
        carry = self.enc._init_carry(b, x.dtype, x.device)
        for t in range(x.shape[1]):
            carry, _ = self.enc._step(carry, x_proj[:, t])
        y = torch.zeros(b, self.out_dim, dtype=x.dtype, device=x.device)
        ys = []
        for _ in range(self.horizon):
            carry, h = self.dec._step(carry, self.dec._project(y))
            y = self.head(h).to(x.dtype)
            ys.append(y)
        return torch.stack(ys, 1)


class NBeatsBlock(Module):
    """``layers`` ReLU Linears, then a backcast and a forecast Linear."""

    def __init__(self, lookback_flat: int, horizon_flat: int, units: int,
                 layers: int = 4,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        dims = [lookback_flat] + [units] * layers
        self.n_fc = layers
        for i in range(layers):
            setattr(self, f"fc_{i}", Linear(dims[i], dims[i + 1],
                                            generator=generator))
        self.backcast = Linear(units, lookback_flat, generator=generator)
        self.forecast = Linear(units, horizon_flat, generator=generator)

    def forward(self, x):
        h = x
        for i in range(self.n_fc):
            h = torch.relu(getattr(self, f"fc_{i}")(h))
        return self.backcast(h), self.forecast(h)


class NBeats(Module):
    """Doubly residual generic N-Beats: each block subtracts its backcast
    from the residual input and adds its forecast to the total."""

    def __init__(self, in_dim: int, out_dim: int, lookback: int,
                 horizon: int, stacks: int = 2, blocks_per_stack: int = 3,
                 units: int = 128,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        if in_dim != out_dim:
            raise ValueError("NBeats is univariate-per-channel: needs "
                             "in_dim == out_dim (target-only input)")
        self.lookback, self.horizon = lookback, horizon
        self.out_dim = out_dim
        self.n_blocks = stacks * blocks_per_stack
        for i in range(self.n_blocks):
            setattr(self, f"block_{i}", NBeatsBlock(
                lookback * in_dim, horizon * out_dim, units,
                generator=generator))

    def forward(self, x):
        b = x.shape[0]
        residual = x.reshape(b, -1)
        total = torch.zeros(b, self.horizon * self.out_dim, dtype=x.dtype,
                            device=x.device)
        for i in range(self.n_blocks):
            bc, fo = getattr(self, f"block_{i}")(residual)
            residual = residual - bc
            total = total + fo
        return total.reshape(b, self.horizon, self.out_dim)
