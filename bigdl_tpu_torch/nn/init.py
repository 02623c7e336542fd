"""Weight initialization methods — the port of ``bigdl_tpu.nn.init``.

An init function is ``init_fn(generator, shape, fan_in, fan_out) ->
float32 tensor`` on the CPU: the JAX package's signature with a
``torch.Generator`` in the place of its PRNG key (``None`` draws from
torch's default generator).  The distributions are the JAX ones; the
numbers are torch's, so tests copy weights across
(``utils.convert``) rather than compare draws."""

import math
from typing import Callable, Optional, Sequence

import torch

InitFn = Callable[[Optional[torch.Generator], Sequence[int], int, int],
                  torch.Tensor]


def zeros(generator, shape, fan_in, fan_out):
    return torch.zeros(tuple(shape))


def ones(generator, shape, fan_in, fan_out):
    return torch.ones(tuple(shape))


def const(value: float) -> InitFn:
    def f(generator, shape, fan_in, fan_out):
        return torch.full(tuple(shape), float(value))

    return f


def _uniform(generator, shape, lower, upper):
    return torch.empty(tuple(shape)).uniform_(lower, upper,
                                              generator=generator)


def _normal(generator, shape):
    return torch.randn(tuple(shape), generator=generator)


def random_uniform(lower=-1e-2, upper=1e-2) -> InitFn:
    def f(generator, shape, fan_in, fan_out):
        return _uniform(generator, shape, lower, upper)

    return f


def random_normal(mean=0.0, stdv=1e-2) -> InitFn:
    def f(generator, shape, fan_in, fan_out):
        return mean + stdv * _normal(generator, shape)

    return f


def xavier(generator, shape, fan_in, fan_out):
    """Glorot uniform — the default of Linear."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(generator, shape, -limit, limit)


def msra(generator, shape, fan_in, fan_out):
    """Kaiming/He normal over fan_out (MsraFiller) — ResNet's convs."""
    return math.sqrt(2.0 / fan_out) * _normal(generator, shape)


def kaiming_in(generator, shape, fan_in, fan_out):
    return math.sqrt(2.0 / fan_in) * _normal(generator, shape)


def default_bias(generator, shape, fan_in, fan_out):
    """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    s = 1.0 / math.sqrt(max(fan_in, 1))
    return _uniform(generator, shape, -s, s)
