"""The ZeRO-1 cycle's wire layer — the port of
``bigdl_tpu.parallel.collectives`` over ``torch.distributed``.

The flat gradient is a ``(n, w)`` view, row ``r`` the chunk rank ``r``
owns; a collective of one bucket of columns ``[c0, c1)`` reduces
``g2d[:, c0:c1]``.  Every function takes the process group explicitly
and uses the group's own backend (NCCL for CUDA tensors, gloo for CPU
tensors); none falls back to another.

- ``reduce_scatter_wire``: ``fp32`` and ``bf16`` through
  ``reduce_scatter_tensor`` (bf16 cast before the wire and summed
  there), ``int8`` through :func:`reduce_scatter_quantized`: each rank
  quantizes every row per ``block`` values (``ops.quantized``'s
  blockwise codec: int8 payload, one float32 scale a block), one
  ``all_to_all_single`` each for payload and scales, and the received
  chunks are dequantized and summed in float32 in source-rank order.
  Per-source scales keep each rank's own magnitude; int8 is never
  summed.
- :func:`all_gather_delta_quantized` (``param_comm="int8"``): gathers
  the int8 update delta and its scales and adds them to the replicated
  base rows; the gathered bytes are the same on every rank, so the
  parameters stay equal to the bit across ranks.
- :func:`psum_wire` (the hierarchical DCN hop): the sum over the DCN
  group of one reduced slice, ``all_reduce`` in fp32 or bf16 (the
  slice's own dtype), or :func:`psum_quantized` for int8: an
  all-to-all scatter with a dequantized sum (as the int8 reduce-scatter)
  and an all-gather of the re-quantized summed sub-chunk, so every rank
  dequantizes the same bytes.
- ``bucket_columns`` splits the shard width into column buckets (one
  collective each; shard ownership, and so the optimizer state and
  checkpoints, identical for any bucket size).
- The byte estimators are the ledger's source: the wire dtype's bytes
  with int8 scales and block padding, one reduce-scatter or all-gather
  of an n-element vector counting the whole vector."""

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bigdl_tpu_torch.ops.common import round_up as _round_up
from bigdl_tpu_torch.ops.quantized import (dequantize_blockwise,
                                           quantize_blockwise)

# gradient-sync wire formats (ShardedParameterStep.grad_comm)
GRAD_COMM_MODES = ("fp32", "bf16", "int8")

# updated-param all-gather wire formats (ShardedParameterStep.param_comm):
# no bf16 (it would round the master params themselves; the int8 delta
# works because the base is already replicated to the bit)
PARAM_COMM_MODES = ("fp32", "int8")

# 1024 elements a float32 scale: 0.4% of the payload
DEFAULT_QUANT_BLOCK = 1024

_SCALE_BYTES = 4  # float32 per-block scales

# torch 2.13 renamed the flat collectives; older releases have only the
# first names
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def wire_itemsize(mode: str) -> float:
    """Payload bytes a gradient element on the wire (scales apart)."""
    return {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}[mode]


def _pad_last(x: torch.Tensor, mult: int) -> torch.Tensor:
    w = x.shape[-1]
    wq = _round_up(w, mult)
    return x if wq == w else F.pad(x, (0, wq - w))


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Every rank's ``inp`` into the contiguous ``out`` (n * inp.numel()
    elements, any shape) in rank order; ``inp`` may be ``out``'s own rank
    slice (in place)."""
    if not (out.is_contiguous() and inp.is_contiguous()):
        raise ValueError("all_gather takes contiguous tensors")
    _all_gather(out.view(-1), inp.view(-1), group=group)


def reduce_scatter_quantized(g2d: torch.Tensor, group, *,
                             block: int = DEFAULT_QUANT_BLOCK
                             ) -> torch.Tensor:
    """This rank's ``(w,)`` float32 chunk of the sum over ranks of
    ``g2d`` (n, w), with int8 payload and float32 block scales on the
    wire.  The block is clamped to ``w``, so a narrow chunk never pads
    up to a full block."""
    n, w = g2d.shape
    block = max(1, min(block, w))
    q, scales = quantize_blockwise(_pad_last(g2d.float(), block), block)
    q_in, s_in = torch.empty_like(q), torch.empty_like(scales)
    dist.all_to_all_single(q_in, q.contiguous(), group=group)
    dist.all_to_all_single(s_in, scales.contiguous(), group=group)
    deq = dequantize_blockwise(q_in, s_in)
    summed = deq[0].clone()
    for j in range(1, n):            # source-rank order
        summed.add_(deq[j])
    return summed[:w]


def all_gather_delta_quantized(delta: torch.Tensor, base_rows: torch.Tensor,
                               group, *, block: int = DEFAULT_QUANT_BLOCK,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Every rank's new parameter rows ``base_rows + dequantize(delta)``
    (n, w): this rank's ``delta`` (w,) goes over the wire as int8 with
    float32 block scales and ``base_rows`` are every rank's old rows,
    replicated.  ``out`` may be ``base_rows`` (added in place)."""
    n, w = base_rows.shape
    block = max(1, min(block, w))
    q, scales = quantize_blockwise(_pad_last(delta.float(), block), block)
    q_all = torch.empty((n,) + q.shape, dtype=q.dtype, device=q.device)
    s_all = torch.empty((n,) + scales.shape, dtype=scales.dtype,
                        device=scales.device)
    all_gather(q_all, q, group)
    all_gather(s_all, scales, group)
    rows = dequantize_blockwise(q_all, s_all)[:, :w]
    if out is None:
        return base_rows + rows
    return torch.add(base_rows, rows, out=out)


def psum_quantized(vec: torch.Tensor, group, n: int, *,
                   block: int = DEFAULT_QUANT_BLOCK) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``group`` of the float32 vector
    ``vec`` (w,) with int8 wire bytes, in two quantized phases: each
    rank's ``ceil(w / n)``-wide sub-chunk (rounded up to the block) is
    reduce-scattered by :func:`reduce_scatter_quantized`, re-quantized
    and all-gathered.  The result is the same to the bit on every
    rank."""
    w = vec.shape[0]
    block = max(1, min(block, -(-w // n)))
    chunk = _round_up(-(-w // n), block)
    gp = F.pad(vec.float(), (0, n * chunk - w))
    part = reduce_scatter_quantized(gp.view(n, chunk), group, block=block)
    q, scales = quantize_blockwise(part, block)
    q_all = q.new_empty(n * chunk)
    s_all = scales.new_empty(n * (chunk // block))
    all_gather(q_all, q.contiguous(), group)
    all_gather(s_all, scales.contiguous(), group)
    return dequantize_blockwise(q_all, s_all)[:w]


def psum_wire(vec: torch.Tensor, group, n: int, mode: str, *,
              block: int = DEFAULT_QUANT_BLOCK) -> torch.Tensor:
    """The DCN hop of one reduced slice: the sum over ``group`` (``n``
    ranks) in the slice's own dtype (fp32, bf16), or through
    :func:`psum_quantized` (int8, float32 out)."""
    if mode == "int8":
        return psum_quantized(vec, group, n, block=block)
    out = vec.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter_wire(g2d: torch.Tensor, group, mode: str, *,
                        block: int = DEFAULT_QUANT_BLOCK) -> torch.Tensor:
    """This rank's reduced ``(w,)`` chunk of one bucket ``g2d`` (n, w):
    float32 for int8, the wire dtype otherwise."""
    if mode == "int8":
        return reduce_scatter_quantized(g2d, group, block=block)
    flat = g2d.reshape(-1)
    if mode == "bf16":
        flat = flat.to(torch.bfloat16)
    out = torch.empty(g2d.shape[1], dtype=flat.dtype, device=flat.device)
    _reduce_scatter(out, flat.contiguous(), group=group)
    return out


def bucket_columns(shard_size: int, ndev: int,
                   bucket_bytes: Optional[int] = None,
                   wire_bytes: float = 4.0,
                   block: Optional[int] = None) -> List[Tuple[int, int]]:
    """Contiguous column buckets ``[(c0, c1), ...]`` covering
    ``[0, shard_size)``: each bucket's whole flat-gradient segment
    (``ndev * cols * wire_bytes``) at most ``bucket_bytes`` (None: one
    bucket), widths rounded down to ``block`` (at least one) so only
    the last pads."""
    if shard_size <= 0 or not bucket_bytes or bucket_bytes <= 0:
        return [(0, max(shard_size, 0))]
    cols = max(1, int(bucket_bytes / max(wire_bytes, 1e-9)) // max(ndev, 1))
    if block:
        cols = max(block, (cols // block) * block)
    out = []
    c0 = 0
    while c0 < shard_size:
        c1 = min(shard_size, c0 + cols)
        out.append((c0, c1))
        c0 = c1
    return out


def rs_wire_bytes(w: int, n: int, mode: str,
                  block: int = DEFAULT_QUANT_BLOCK) -> int:
    """Wire bytes to reduce-scatter one bucket of per-rank width ``w``
    over ``n`` ranks; int8 counts the padded payload and the scales."""
    if n <= 1 or w <= 0:
        return 0
    if mode == "int8":
        block = max(1, min(block, w))
        wq = _round_up(w, block)
        return n * wq + n * (wq // block) * _SCALE_BYTES
    return int(n * w * wire_itemsize(mode))


def ag_wire_bytes(w: int, n: int, mode: str,
                  block: int = DEFAULT_QUANT_BLOCK) -> int:
    """Wire bytes to all-gather one bucket's updated parameters:
    ``n * w * 4`` for fp32, the int8 delta's padded payload and scales
    for int8."""
    if n <= 1 or w <= 0:
        return 0
    if mode == "int8":
        block = max(1, min(block, w))
        wq = _round_up(w, block)
        return n * wq + n * (wq // block) * _SCALE_BYTES
    return int(n * w * 4)


def psum_wire_bytes(w: int, n: int, mode: str,
                    block: int = DEFAULT_QUANT_BLOCK) -> int:
    """Wire bytes of the DCN psum of a ``w``-element slice over ``n``
    ranks: two phases of about the slice's wire bytes (int8: padded
    payload and scales, twice)."""
    if n <= 1 or w <= 0:
        return 0
    if mode == "int8":
        block = max(1, min(block, -(-w // n)))
        chunk = _round_up(-(-w // n), block)
        return 2 * (n * chunk + n * (chunk // block) * _SCALE_BYTES)
    return int(2 * w * wire_itemsize(mode))


def layout_ledger(n_params: int, ndev: int, dcn: int = 1,
                  mode: str = "fp32", bucket_bytes: Optional[int] = None,
                  block: int = DEFAULT_QUANT_BLOCK,
                  param_comm: str = "fp32") -> Dict[str, float]:
    """The per-step collective bytes of a ZeRO-1 cycle over ``n_params``
    parameters on ``ndev`` ranks a slice and ``dcn`` slices, from the
    layout alone (the JAX ledger's keys and numbers)."""
    if mode not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm {mode!r}: one of {GRAD_COMM_MODES}")
    if param_comm not in PARAM_COMM_MODES:
        raise ValueError(f"param_comm {param_comm!r}: one of "
                         f"{PARAM_COMM_MODES}")
    n_pad = _round_up(n_params, ndev)
    shard = n_pad // ndev
    cols = bucket_columns(shard, ndev, bucket_bytes, wire_itemsize(mode),
                          block if mode == "int8" else None)
    grad_ici = sum(rs_wire_bytes(c1 - c0, ndev, mode, block)
                   for c0, c1 in cols)
    param_ici = sum(ag_wire_bytes(c1 - c0, ndev, param_comm, block)
                    for c0, c1 in cols)
    dcn_bytes = sum(psum_wire_bytes(c1 - c0, dcn, mode, block)
                    for c0, c1 in cols)
    return {
        "grad_comm": mode,
        "param_comm": param_comm,
        "n_params": float(n_params),
        "n_params_padded": float(n_pad),
        "comm_buckets": float(len(cols)),
        "grad_sync_ici_bytes_per_step": float(grad_ici),
        "param_sync_ici_bytes_per_step": float(param_ici),
        "ici_bytes_per_step": float(grad_ici + param_ici),
        "grad_sync_dcn_bytes_per_step": float(dcn_bytes),
        "dcn_bytes_per_step": float(dcn_bytes),
    }
