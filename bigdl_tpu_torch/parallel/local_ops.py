"""Ops whose local shards a layout computes through DTensor's
``local_map``: the hand-written kernels, which take plain tensors, and
the lookups that DTensor would otherwise gather a whole table for.

- :func:`attention`: q, k, v (b, heads, len, dim) DTensors; the batch
  stays sharded on the data axes and the heads on tp, anything else
  (a seq-sharded length, a split head dim) is first redistributed to
  ``Replicate`` (GSPMD's choice without ring attention, ROADMAP A.4),
  and ``fn`` (the flash kernels or the plain attention) runs on each
  rank's local shards.
- :func:`vocab_lookup`: rows of a vocab-sharded table.  Where the ids
  are replicated and the table's rows split, each rank looks up the ids
  in its own rows and the result is ``Partial(sum)`` (GSPMD's masked
  lookup and one all-reduce); where the ids split (the batch), the table
  is gathered on that axis alone (fsdp's gather of a parameter).
- :func:`row_local`: a row-wise op over the last dim (the fused
  LayerNorm) on local rows, the last dim gathered first."""

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
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
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


def replicated(t):
    """A DTensor's full value as a plain tensor (a plain one as it is)."""
    return t.full_tensor() if is_dtensor(t) else t
