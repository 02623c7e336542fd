"""Ring attention — the port of ``bigdl_tpu.parallel.ring_attention``:
exact sequence-parallel attention over the ranks of a ``seq`` group.

Every rank holds one block of the sequence's q, k and v.  The k/v blocks
travel round the ring (``torch.distributed.batch_isend_irecv`` to the
next rank, from the previous one) and each rank folds every visiting
block into its result.  Where the JAX function runs an online softmax
over each block, the port hands each block to the flash forward
(``ops.flash_attention.flash_attention_fwd``, a kernel on the card, its
plain version on the CPU), which returns the block's output and its
per-row logsumexp, and merges the partial results by their lse: the
same function, exact.  What a rank does with a visiting block depends
on where it came from: its own block is attended causally under
``causal``, an earlier rank's block fully, a later rank's block is
skipped under ``causal`` (its keys all lie after the rank's queries).

The gradient is a ``torch.autograd.Function`` whose backward runs the
ring again: for every visiting block the flash backward
(``flash_attention_bwd``) with the global output and lse, dQ summed on
the rank, each block's dK and dV travelling with it and arriving, after
one rotation more, at the block's owner.

:func:`fold_block`, :func:`merge_partials` and :func:`fold_block_bwd`
are the per-step fold, kept apart from the transport so that one card
can drive the fold of every rank (:func:`ring_fold`, the rotation done
by indexing) and hold it against one flash call over the whole
sequence."""

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)


def group_place(group) -> Tuple[int, int]:
    """(this rank's index in ``group``, the group's size); a ``None``
    group is this process alone."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _block_mode(q_idx: int, kv_idx: int, causal: bool) -> Optional[bool]:
    """How block ``q_idx``'s queries attend block ``kv_idx``'s keys: the
    flash call's ``causal`` flag, or None when the block is skipped."""
    if kv_idx == q_idx:
        return causal
    if kv_idx < q_idx or not causal:
        return False
    return None


def fold_block(q, k, v, q_idx: int, kv_idx: int, causal: bool,
               scale: float):
    """One visiting block's (out, lse) for this rank's queries, or None
    when ``causal`` skips it."""
    mode = _block_mode(q_idx, kv_idx, causal)
    if mode is None:
        return None
    return flash_attention_fwd(q, k, v, causal=mode, sm_scale=scale)


def merge_partials(out_a, lse_a, out_b, lse_b):
    """Two partial attentions of the same queries over disjoint keys,
    merged by their logsumexps (float32)."""
    lse = torch.logaddexp(lse_a, lse_b)
    out = (out_a.float() * torch.exp(lse_a - lse)[..., None]
           + out_b.float() * torch.exp(lse_b - lse)[..., None])
    return out, lse


def fold_block_bwd(q, k, v, out, lse, g, q_idx: int, kv_idx: int,
                   causal: bool, scale: float):
    """One visiting block's (dq, dk, dv) from the global ``out`` and
    ``lse``, or None when ``causal`` skips it."""
    mode = _block_mode(q_idx, kv_idx, causal)
    if mode is None:
        return None
    return flash_attention_bwd(q, k, v, out, lse, g, causal=mode,
                               sm_scale=scale)


def _rotate(tensors: Sequence[torch.Tensor], group, idx: int, n: int
            ) -> List[torch.Tensor]:
    """Send ``tensors`` to the next rank of the ring and receive the
    previous rank's."""
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in sends]
           + [dist.P2POp(dist.irecv, t, prv, group) for t in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def _ring_forward(q, k, v, idx, n, causal, scale, rotate):
    kb, vb, acc = k, v, None
    for step in range(n):
        part = fold_block(q, kb, vb, idx, (idx - step) % n, causal, scale)
        if part is not None:
            acc = part if acc is None else merge_partials(*acc, *part)
        if step < n - 1:
            kb, vb = rotate([kb, vb])
    out, lse = acc
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, g, idx, n, causal, scale, rotate):
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    kb, vb = k, v
    for step in range(n):
        part = fold_block_bwd(q, kb, vb, out, lse, g, idx,
                              (idx - step) % n, causal, scale)
        if part is not None:
            dq += part[0]
            dk += part[1]
            dv += part[2]
        if step < n - 1:
            kb, vb, dk, dv = rotate([kb, vb, dk, dv])
        else:
            # the block this rank holds now is the next rank's own
            dk, dv = rotate([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        idx, n = group_place(group)
        rotate = lambda ts: _rotate(ts, group, idx, n)  # noqa: E731
        out, lse = _ring_forward(q, k, v, idx, n, causal, scale, rotate)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, idx, n, causal, scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, idx, n, causal, scale = ctx.ring
        rotate = lambda ts: _rotate(ts, group, idx, n)  # noqa: E731
        dq, dk, dv = _ring_backward(q, k, v, out, lse, g.contiguous(), idx,
                                    n, causal, scale, rotate)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: Optional[float] = None):
    """Sequence-parallel exact attention over the ranks of ``group``.

    q, k, v: (batch, heads, block_len, head_dim), this rank's block of
    the sequence (block ``dist.get_rank(group)``; ``group=None`` is one
    block, this process alone).  Returns this rank's output block,
    shaped and typed as ``q``; differentiable."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    return _RingAttention.apply(q, k, v, group, bool(causal), float(scale))


def ring_fold(qs, ks, vs, causal: bool = False,
              scale: Optional[float] = None):
    """The ring's forward for every rank on one process: ``qs``, ``ks``,
    ``vs`` are the P blocks the P ranks would hold; the rotation is done
    by indexing, each rank's blocks folded in the ring's order.  Returns
    (outs, lses), one a rank."""
    n = len(qs)
    scale = (1.0 / math.sqrt(qs[0].shape[-1])) if scale is None else scale
    res = []
    for i in range(n):
        acc = None
        for step in range(n):
            j = (i - step) % n
            part = fold_block(qs[i], ks[j], vs[j], i, j, causal, scale)
            if part is not None:
                acc = part if acc is None else merge_partials(*acc, *part)
        res.append((acc[0].to(qs[i].dtype), acc[1]))
    return [o for o, _ in res], [l for _, l in res]


def ring_fold_bwd(qs, ks, vs, outs, lses, gs, causal: bool = False,
                  scale: Optional[float] = None):
    """The ring's backward for every rank on one process, each block's
    dK / dV summed in the order the ring sums them.  Returns (dqs, dks,
    dvs)."""
    n = len(qs)
    scale = (1.0 / math.sqrt(qs[0].shape[-1])) if scale is None else scale
    dqs = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    dks = [torch.zeros_like(k, dtype=torch.float32) for k in ks]
    dvs = [torch.zeros_like(v, dtype=torch.float32) for v in vs]
    for step in range(n):
        for i in range(n):
            j = (i - step) % n
            part = fold_block_bwd(qs[i], ks[j], vs[j], outs[i], lses[i],
                                  gs[i], i, j, causal, scale)
            if part is not None:
                dqs[i] += part[0]
                dks[j] += part[1]
                dvs[j] += part[2]
    return dqs, dks, dvs


def seq_sharded_call(kernel, q, k, v, group=None, causal: bool = False):
    """``kernel`` (ring or Ulysses attention) over GLOBAL (b, h, L, d)
    tensors that every rank of ``group`` holds: each rank runs its block
    and the output blocks are all-gathered back to (b, h, L, d).  Forward
    only (the gather has no gradient)."""
    idx, n = group_place(group)
    c = q.shape[2] // n
    if c * n != q.shape[2]:
        raise ValueError(f"sequence length {q.shape[2]} does not split "
                         f"into {n} blocks")
    blk = [t.narrow(2, idx * c, c).contiguous() for t in (q, k, v)]
    out = kernel(*blk, group=group, causal=causal).contiguous()
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts, dim=2)


def ring_attention_sharded(q, k, v, group=None, causal: bool = False):
    """:func:`ring_attention` over GLOBAL (b, h, L, d) tensors
    (:func:`seq_sharded_call`)."""
    return seq_sharded_call(ring_attention, q, k, v, group, causal)
