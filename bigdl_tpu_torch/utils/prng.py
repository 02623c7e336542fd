"""Counter-based random bits — the threefry2x32 keys and samplers the JAX
package draws from (``jax.random`` under ``jax_threefry_partitionable``),
bit for bit, in plain PyTorch.

A key is a (2,) int64 tensor holding two uint32 words (or a (..., 2)
stack of keys).  Torch has no full uint32 arithmetic, so every word lives
in an int64 and is masked to 32 bits after each add and rotate.  The same
key gives the same bits as the JAX function of the same name:

- :func:`PRNGKey` (``jax.random.PRNGKey`` of an int32 seed),
  :func:`fold_in`, :func:`split`;
- :func:`random_bits`, :func:`uniform` and :func:`bernoulli` (float32),
  whose element ``i`` of the row-major flattened shape hashes the 64-bit
  counter ``i`` (the partitionable layout);
- :func:`threefry2x32`, the 20-round hash itself.

Keys live on the caller's device; every function works batched over
leading key dimensions."""

from typing import Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under
    key ``(k1, k2)``; all int64 tensors of uint32 values, broadcast
    together.  Returns the two output words."""
    k3 = k1 ^ k2 ^ _KS_PARITY
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.PRNGKey`` builds it
    with 64-bit types off: the seed as int32, key ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _data(data, like: torch.Tensor) -> torch.Tensor:
    """``data`` as uint32 words in int64 on ``like``'s device (negative
    int32 values wrap, as JAX's cast to uint32 does)."""
    d = torch.as_tensor(data, device=like.device)
    return d.to(torch.int64) & _M32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key from ``key`` and an integer (or an int tensor, one per
    key of a (..., 2) stack), as ``jax.random.fold_in``."""
    d = _data(data, key)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys (num, 2), as ``jax.random.split``."""
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(cnt), cnt)
    return torch.stack([o1, o2], dim=-1)


def _shape(shape: Union[int, Sequence[int]]):
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 of uint32 values);
    a (..., 2) stack of keys gives (..., *shape)."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, cnt >> 32, cnt & _M32)
    return (b1 ^ b2).reshape(tuple(lead) + shape)


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """float32 uniform in [minval, maxval), as ``jax.random.uniform``: 23
    random mantissa bits under exponent 0, minus 1, scaled, and floored
    at ``minval``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """bool samples, True with probability ``p``, as
    ``jax.random.bernoulli`` (``uniform < p`` in float32)."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)
