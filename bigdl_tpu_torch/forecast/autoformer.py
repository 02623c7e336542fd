"""Autoformer — the port of ``bigdl_tpu.forecast.autoformer``: the
decomposition transformer with auto-correlation attention (Wu et al.
2021), parameters named as the JAX package keys them.

The delay correlation is ``torch.fft.rfft`` / ``irfft`` in float32 under
either compute dtype (cuFFT on the card), as the JAX layer casts.  The
``top_k`` delays are picked by a stable descending sort, so ties go to
the lower delay as ``jax.lax.top_k`` sends them; ``torch.topk`` promises
no order there.  The projections go through the port's ``Linear``."""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import Linear
from bigdl_tpu_torch.nn.module import Module


def series_decomp(x, kernel: int):
    """(seasonal, trend) of (b, L, c): the trend is a moving average over
    ``kernel`` steps with the first and last rows repeated as padding."""
    left = kernel // 2
    right = kernel - 1 - left
    xp = torch.cat([x[:, :1].expand(-1, left, -1), x,
                    x[:, -1:].expand(-1, right, -1)], dim=1)
    cs = torch.cumsum(xp, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    trend = (cs[:, kernel:] - cs[:, :-kernel]) / kernel
    return x - trend, trend


def top_delays(mean_corr, top_k: int):
    """The ``top_k`` largest correlations of (b, L) and their delays,
    ties to the lower delay (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(mean_corr, dim=-1, descending=True, stable=True)
    return vals[:, :top_k], idx[:, :top_k]


def auto_correlation(q, k, v, top_k: int):
    """(b, h, L, d) heads: R(tau) by FFT, averaged over heads and
    channels; ``v`` rolled by each of the ``top_k`` strongest delays and
    summed under the softmax of their correlations."""
    b, h, L, d = q.shape
    fq = torch.fft.rfft(q.float(), dim=2)
    fk = torch.fft.rfft(k.float(), dim=2)
    corr = torch.fft.irfft(fq * torch.conj(fk), n=L, dim=2)
    mean_corr = corr.mean(dim=(1, 3))                       # (b, L)
    weights, delays = top_delays(mean_corr, top_k)          # (b, k)
    weights = torch.softmax(weights, dim=-1)
    t = torch.arange(L, device=q.device)
    idx = (t[None, None, :] + delays[:, :, None]) % L       # (b, k, L)
    vf = v.float()[:, None].expand(b, top_k, h, L, d)
    g = torch.gather(vf, 3, idx[:, :, None, :, None].expand(b, top_k, h, L,
                                                             d))
    out = torch.einsum("bkhld,bk->bhld", g, weights)
    return out.to(q.dtype)


class AutoCorrelationLayer(Module):
    """q, k, v projections, auto-correlation over ``heads`` heads with
    ``top_k = max(1, int(factor * ln L))``, the output projection; keys
    and values are cut or zero-padded to the query length."""

    def __init__(self, hidden: int, heads: int, top_k_factor: int = 1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        assert hidden % heads == 0
        self.hidden, self.heads = hidden, heads
        self.head_dim = hidden // heads
        self.factor = top_k_factor
        for w in ("wq", "wk", "wv", "wo"):
            setattr(self, w, Linear(hidden, hidden, generator=generator))

    def forward(self, x, context=None):
        c = x if context is None else context
        b, lq, _ = x.shape
        lk = c.shape[1]

        def split(t, length):
            return t.reshape(b, length, self.heads,
                             self.head_dim).transpose(1, 2)

        q = split(self.wq(x), lq)
        k, v = split(self.wk(c), lk), split(self.wv(c), lk)
        if lk > lq:
            k, v = k[:, :, :lq], v[:, :, :lq]
        elif lk < lq:
            k = F.pad(k, (0, 0, 0, lq - lk))
            v = F.pad(v, (0, 0, 0, lq - lk))
        top_k = max(1, int(self.factor * math.log(max(lq, 2))))
        out = auto_correlation(q, k, v, top_k)
        return self.wo(out.transpose(1, 2).reshape(b, lq, self.hidden))


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


class AutoformerEncoderLayer(Module):
    def __init__(self, hidden: int, heads: int, ff: int, kernel: int = 25,
                 dropout: float = 0.05,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.attn = AutoCorrelationLayer(hidden, heads, generator=generator)
        self.ff1 = Linear(hidden, ff, generator=generator)
        self.ff2 = Linear(ff, hidden, generator=generator)
        self.kernel = kernel
        self.dropout = dropout

    def forward(self, x):
        x, _ = series_decomp(x + self.attn(x), self.kernel)
        f = self.ff2(_gelu(self.ff1(x)))
        y, _ = series_decomp(x + f, self.kernel)
        return y


class Autoformer(Module):
    """The compact Autoformer, (b, lookback, in_dim) -> (b, horizon,
    out_dim): an encoder of decomposition layers; a decoder seeded with
    the last half of the lookback's seasonal part (then zeros) and its
    trend (then the lookback mean), accumulating the trend of each
    decomposition."""

    def __init__(self, in_dim: int, out_dim: int, lookback: int,
                 horizon: int, hidden: int = 64, heads: int = 4,
                 enc_layers: int = 2, dec_layers: int = 1, ff: int = 128,
                 kernel: int = 25,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        g = generator
        self.in_proj = Linear(in_dim, hidden, generator=g)
        self.n_enc, self.n_dec = enc_layers, dec_layers
        for i in range(enc_layers):
            setattr(self, f"enc_{i}", AutoformerEncoderLayer(
                hidden, heads, ff, kernel, generator=g))
        self.dec_seed_proj = Linear(in_dim, hidden, generator=g)
        for i in range(dec_layers):
            setattr(self, f"dec_self_{i}",
                    AutoCorrelationLayer(hidden, heads, generator=g))
            setattr(self, f"dec_cross_{i}",
                    AutoCorrelationLayer(hidden, heads, generator=g))
            setattr(self, f"dec_ff1_{i}", Linear(hidden, ff, generator=g))
            setattr(self, f"dec_ff2_{i}", Linear(ff, hidden, generator=g))
        self.out_proj = Linear(hidden, out_dim, generator=g)
        self.trend_proj = Linear(in_dim, out_dim, generator=g)
        self.kernel = kernel
        self.lookback, self.horizon = lookback, horizon
        self.out_dim = out_dim

    def forward(self, x):
        b = x.shape[0]
        half = self.lookback // 2
        seasonal_init, trend_init = series_decomp(x, self.kernel)
        mean = x.mean(dim=1, keepdim=True)
        trend_seed = torch.cat([trend_init[:, -half:],
                                mean.expand(-1, self.horizon, -1)], dim=1)
        seasonal_seed = torch.cat(
            [seasonal_init[:, -half:],
             x.new_zeros(b, self.horizon, x.shape[-1])], dim=1)
        h = self.in_proj(x)
        for i in range(self.n_enc):
            h = getattr(self, f"enc_{i}")(h)
        hd = self.dec_seed_proj(seasonal_seed)
        trend_acc = self.trend_proj(trend_seed)
        for i in range(self.n_dec):
            hd, t1 = series_decomp(hd + getattr(self, f"dec_self_{i}")(hd),
                                   self.kernel)
            hd, t2 = series_decomp(
                hd + getattr(self, f"dec_cross_{i}")(hd, context=h),
                self.kernel)
            f = getattr(self, f"dec_ff2_{i}")(
                _gelu(getattr(self, f"dec_ff1_{i}")(hd)))
            hd, t3 = series_decomp(hd + f, self.kernel)
            trend_acc = trend_acc + self.out_proj(t1 + t2 + t3)
        y = self.out_proj(hd) + trend_acc
        return y[:, -self.horizon:, :]
