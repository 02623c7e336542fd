"""Ulysses sequence parallelism — the port of ``bigdl_tpu.parallel.ulysses``:
exact attention by all-to-all head redistribution (DeepSpeed-Ulysses,
arXiv:2309.14509).

    in:   q/k/v sharded over the SEQUENCE (each rank: all heads, L/P tokens)
    a2a:  q/k/v sharded over the HEADS    (each rank: h/P heads, all L)
    ...attention over the whole sequence for the rank's heads...
    a2a:  the output back to sequence sharding

The all-to-alls are ``torch.distributed.all_to_all_single`` on the seq
group, inside an autograd function whose backward is the inverse
all-to-all.  The head-sharded attention is ``ops.flash_attention``
(``causal`` as the JAX function's explicit lower-triangular mask
computes it): the flash kernels on the card, their plain versions on
the CPU.  The heads must divide by the group's size."""

from typing import Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.parallel.ring_attention import (group_place,
                                                     seq_sharded_call)


def _a2a(x: torch.Tensor, group, n: int, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    """Split ``split_axis`` into ``n`` chunks, send chunk j to rank j,
    concatenate the received chunks along ``concat_axis`` in rank order
    (JAX's tiled ``all_to_all``)."""
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.a2a = (group, n, split_axis, concat_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.a2a
        return (_a2a(g.contiguous(), group, n, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(x, group, split_axis: int, concat_axis: int):
    """Differentiable tiled all-to-all over ``group`` (the identity on
    one rank)."""
    _, n = group_place(group)
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      scale: Optional[float] = None):
    """Sequence-parallel exact attention by head redistribution over the
    ranks of ``group``.  q, k, v: (batch, heads, block_len, head_dim),
    this rank's block with all heads (as :func:`ring_attention`).
    Returns this rank's output block, shaped and typed as ``q``."""
    h = q.shape[1]
    _, p = group_place(group)
    if h % p != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the seq axis ({p}); "
            "use ring_attention for head counts below the axis size")
    qh, kh, vh = (all_to_all(t, group, 1, 2) for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal, sm_scale=scale)
    return all_to_all(out.to(q.dtype), group, 2, 1)


def ulysses_attention_sharded(q, k, v, group=None, causal: bool = False):
    """:func:`ulysses_attention` over GLOBAL (b, h, L, d) tensors that
    every rank holds (``ring_attention.seq_sharded_call``)."""
    return seq_sharded_call(ulysses_attention, q, k, v, group, causal)
