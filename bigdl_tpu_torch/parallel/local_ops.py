"""Ops whose local shards a layout computes through DTensor's
``local_map``: the hand-written kernels, which take plain tensors, and
the lookups that DTensor would otherwise gather a whole table for.

- :func:`attention`: q, k, v (b, heads, len, dim) DTensors; the batch
  stays sharded on the data axes and the heads on tp, anything else
  (a seq-sharded length, a split head dim) is first redistributed to
  ``Replicate`` (GSPMD's choice for a layout's ``seq`` axis; ring and
  Ulysses attention run on the classic mesh's ``seq`` axis,
  ``parallel.ring_attention``), and ``fn`` (the flash kernels or the
  plain attention) runs on each rank's local shards.
- :func:`vocab_lookup`: rows of a vocab-sharded table.  Where the ids
  are replicated and the table's rows split, each rank looks up the ids
  in its own rows and the result is ``Partial(sum)`` (GSPMD's masked
  lookup and one all-reduce); where the ids split (the batch), the table
  is gathered on that axis alone (fsdp's gather of a parameter).
- :func:`row_local`: a row-wise op over the last dim (the fused
  LayerNorm) on local rows, the last dim gathered first.
- :func:`paged_attention`: the decode engine's attention over its paged
  KV pool (the paged decode and verify kernels, or the buffer attention
  of the static reference) on whole heads: q and the new k / v are
  gathered to every rank, which holds a replicated pool (see
  ``serving/decode_engine.py``, ``_AdapterBase``).
- :func:`int8_layer`: an int8 twin's forward (the int8 matmul kernel) on
  each rank's output columns, the contraction dim and the input
  gathered.
- :func:`block_sparse`: the block-sparse product on whole operands (a
  block mask is a plan over the whole weight).
- :func:`spatial`: an NHWC op over H and W (a pool) on local batch
  rows and channels, H and W gathered first.
- :func:`replicated`: a DTensor's whole value as a plain tensor (the
  engine samples from every rank's whole logits)."""

from bigdl_tpu_torch.ops.common import is_dtensor


def attention(fn, q, k, v):
    """``fn(q, k, v)`` on local shards: batch (dim 0) and heads (dim 1)
    keep their splits, every other placement becomes ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    keep = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in q.placements]
    mapped = local_map(fn, out_placements=keep,
                       in_placements=(keep, keep, keep),
                       redistribute_inputs=True, device_mesh=q.device_mesh)
    return mapped(q, k, v)


def spatial(fn, x):
    """``fn(x)`` on local shards of an NHWC DTensor ``x``: its batch and
    channel splits stay, any other becomes ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    keep = [p if isinstance(p, Shard) and p.dim in (0, x.ndim - 1)
            else Replicate() for p in x.placements]
    mapped = local_map(fn, out_placements=keep, in_placements=(keep,),
                       redistribute_inputs=True, device_mesh=x.device_mesh)
    return mapped(x)


def row_local(fn, x, *params):
    """``fn(x, *params)`` on local rows: ``x`` keeps every split but of
    its last dim, ``params`` (per-feature vectors) are replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    last = x.ndim - 1
    keep = [Replicate() if isinstance(p, Shard) and p.dim == last
            or not isinstance(p, Shard) else p for p in x.placements]
    rep = [Replicate()] * x.device_mesh.ndim
    ins = (keep,) + tuple(rep if isinstance(p, DTensor) else None
                          for p in params)
    mapped = local_map(fn, out_placements=keep, in_placements=ins,
                       redistribute_inputs=True, device_mesh=x.device_mesh)
    return mapped(x, *params)


def vocab_lookup(table, ids):
    """``table[ids]`` for a DTensor ``table`` (vocab, ...) and ids (a
    DTensor or a plain tensor, taken as replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    tpl, outp, gradp = [], [], []
    for tp, ip in zip(table.placements, ids.placements):
        if isinstance(ip, Shard):
            # rows split by the ids' axis: the table gathered on it, the
            # gradient each rank's partial sum
            tpl.append(Replicate())
            outp.append(ip)
            gradp.append(Partial())
        elif isinstance(tp, Shard) and tp.dim == 0:
            tpl.append(tp)
            outp.append(Partial())
            gradp.append(tp)
        elif isinstance(tp, Shard) and tp.dim == 1:
            tpl.append(tp)
            outp.append(Shard(ids.ndim))
            gradp.append(tp)
        else:
            tpl.append(Replicate())
            outp.append(Replicate())
            gradp.append(Replicate())
    _, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, tpl)
    lo, n_rows = int(offset[0]), int(table.shape[0])

    def lookup(t, i):
        i = i.long()
        if t.shape[0] == n_rows:
            return t[i]
        rel = i - lo
        ok = (rel >= 0) & (rel < t.shape[0])
        rows = t[rel.clamp(0, max(t.shape[0] - 1, 0))]
        return rows * ok.unsqueeze(-1).to(rows.dtype)

    mapped = local_map(lookup, out_placements=outp,
                       in_placements=(tpl, ids.placements),
                       in_grad_placements=(gradp, ids.placements),
                       redistribute_inputs=True, device_mesh=mesh)
    return mapped(table, ids)


def _rep(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _as_dtensor(t, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (a DTensor as
    it is)."""
    from torch.distributed.tensor import DTensor

    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, _rep(mesh), run_check=False)


def paged_attention(fn, q, k, v):
    """``fn(q, k, v) -> (a, k, v)`` on plain tensors of whole heads: q,
    k and v (b, heads, len, dim) DTensors are replicated first, and
    ``fn`` (the engine's attention, which writes k and v into its pool)
    runs on every rank.  Returns ``a`` as a replicated DTensor, ``k``
    and ``v`` as plain tensors."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    rep = _rep(mesh)
    mapped = local_map(fn, out_placements=(rep, rep, rep),
                       in_placements=(rep, rep, rep),
                       redistribute_inputs=True, device_mesh=mesh)
    a, k, v = mapped(q, k, v)
    return a, k.to_local(), v.to_local()


def int8_layer(fn, x, w_q, scales, bias=None, act_scale=None):
    """``fn(x, w_q, scales, bias, act_scale)`` (an int8 twin's forward
    on plain tensors) on each rank's output columns: where ``w_q`` (K, N)
    splits N, the scales and the bias split with it and so does the
    output's last dim; every other split (K, a grouped weight) is
    gathered, and so is ``x``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w_q.device_mesh
    cols = [w_q.ndim == 2 and isinstance(p, Shard) and p.dim == 1
            for p in w_q.placements]
    rep = _rep(mesh)
    wp = [Shard(1) if c else r for c, r in zip(cols, rep)]
    vp = [Shard(0) if c else r for c, r in zip(cols, rep)]
    out = [Shard(x.ndim - 1) if c else r for c, r in zip(cols, rep)]
    args = (_as_dtensor(x, mesh), w_q, _as_dtensor(scales, mesh),
            _as_dtensor(bias, mesh), _as_dtensor(act_scale, mesh))
    ins = (rep, wp, vp, None if bias is None else vp,
           None if act_scale is None else rep)
    mapped = local_map(fn, out_placements=out, in_placements=ins,
                       redistribute_inputs=True, device_mesh=mesh)
    return mapped(*args)


def block_sparse(fn, x, w):
    """``fn(x, w)`` (the block-sparse product) on whole operands: both
    replicated, the output replicated."""
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    rep = _rep(mesh)
    mapped = local_map(fn, out_placements=rep, in_placements=(rep, rep),
                       redistribute_inputs=True, device_mesh=mesh)
    return mapped(_as_dtensor(x, mesh), w)


def replicated(t):
    """A DTensor's full value as a plain tensor (a plain one as it is)."""
    return t.full_tensor() if is_dtensor(t) else t
