"""Attention kernels — the port of ``bigdl_tpu.ops.flash_attention``.

Three functions, each with hand-written CUDA kernels (``csrc/``) beside a
plain PyTorch version of the same math:

- :func:`flash_attention` — blockwise (flash) attention for training, a
  ``torch.autograd.Function`` whose forward (``flash_attention_fwd.cu``)
  and backward (``flash_attention_bwd.cu``) are both kernels;
- :func:`paged_decode_attention` — single-query attention over a paged KV
  cache, for serving, over float32 or int8 pages
  (``paged_decode_attention.cu``);
- :func:`paged_verify_attention` — the multi-query sibling that scores a
  speculative chunk of k+1 queries per slot in one call, float32 or int8
  pages (``paged_verify_attention.cu``).

A wrapper launches its kernel for CUDA tensors and takes the plain
version (``*_ref``) only for tensors that lie on the CPU.  There is no
fallback: a CUDA tensor either reaches the kernel or the call raises."""

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.ops.common import launch

KERNEL = "paged_decode_attention"
KERNEL_INT8 = "paged_decode_attention_int8"
VERIFY = "paged_verify_attention"
VERIFY_INT8 = "paged_verify_attention_int8"
FLASH_FWD = "flash_attention_fwd"
FLASH_BWD_DQ = "flash_attention_bwd_dq"
FLASH_BWD_DKDV = "flash_attention_bwd_dkdv"
_HEAD_DIMS = (32, 64, 128)
# the TPU kernel's _NEG_INF: masked scores, and the running max's start
_NEG_INF = -1e30

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
_VIEW = [_P, _LL, _LL, _LL]  # pointer, batch / head / seq strides
# batch, heads, sq, skv, head_dim, sm_scale, causal
_FLASH_DIMS = [_I] * 5 + [_F, _I]
# kernel -> (library in csrc/, C symbol, argument types)
_SIGNATURES = {
    KERNEL: (KERNEL, "paged_decode_attention_f32",
             [_P] * 4 + [_I] + [_P] * 2 + [_I] * 5 + [_F]),
    KERNEL_INT8: (KERNEL, "paged_decode_attention_i8",
                  [_P] * 6 + [_I] + [_P] * 2 + [_I] * 5 + [_F]),
    VERIFY: (VERIFY, "paged_verify_attention_f32",
             [_P] * 4 + [_I] + [_P] * 2 + [_I] * 6 + [_F]),
    VERIFY_INT8: (VERIFY, "paged_verify_attention_i8",
                  [_P] * 6 + [_I] + [_P] * 2 + [_I] * 6 + [_F]),
    FLASH_FWD: (FLASH_FWD, "flash_attention_fwd_f32",
                _VIEW * 3 + [_P] * 2 + _FLASH_DIMS),
    FLASH_BWD_DQ: ("flash_attention_bwd", "flash_attention_bwd_dq_f32",
                   _VIEW * 5 + [_P] * 3 + _FLASH_DIMS),
    FLASH_BWD_DKDV: ("flash_attention_bwd", "flash_attention_bwd_dkdv_f32",
                     _VIEW * 4 + [_P] * 4 + _FLASH_DIMS),
}


def _launch(kernel: str, device: torch.device, *args) -> None:
    launch(kernel, _SIGNATURES[kernel], device, *args)


def _check_paged(q, k_pages, v_pages, page_table, rows, k_scales,
                 v_scales, rows_name):
    """Shapes, scales and one device of a paged call; ``q`` is (slots,
    heads, [chunk,] head_dim).  Returns the device."""
    if q.ndim not in (3, 4) or k_pages.ndim != 4:
        raise ValueError(f"q must be (slots, heads, [chunk,] head_dim) and "
                         f"pages (pages, heads, page, head_dim), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    S, h, d = q.shape[0], q.shape[1], q.shape[-1]
    quantized = k_pages.dtype == torch.int8
    if quantized != (v_pages.dtype == torch.int8):
        raise ValueError(f"k_pages and v_pages must share a type, got "
                         f"{k_pages.dtype} and {v_pages.dtype}")
    if quantized and (k_scales is None or v_scales is None):
        raise ValueError("int8 k_pages/v_pages need k_scales/v_scales "
                         "(one float32 abs-max scale per pool page)")
    if not quantized and (k_scales is not None or v_scales is not None):
        raise ValueError(f"k_scales/v_scales only apply to int8 pages, got "
                         f"{k_pages.dtype} pages")
    if tuple(v_pages.shape) != tuple(k_pages.shape) \
            or (k_pages.shape[1], k_pages.shape[3]) != (h, d):
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if quantized and (tuple(k_scales.shape) != (k_pages.shape[0],)
                      or tuple(v_scales.shape) != (k_pages.shape[0],)):
        raise ValueError(f"k_scales/v_scales must be ({k_pages.shape[0]},), "
                         f"got {tuple(k_scales.shape)} and "
                         f"{tuple(v_scales.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != S \
            or tuple(rows.shape) != (S,):
        raise ValueError(f"page_table must be (slots, n_blocks) and "
                         f"{rows_name} (slots,) for {S} slots, got "
                         f"{tuple(page_table.shape)} and "
                         f"{tuple(rows.shape)}")
    scales = (k_scales, v_scales) if quantized else ()
    devices = {t.device for t in (q, k_pages, v_pages, page_table, rows,
                                  *scales)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"paged attention runs on CUDA tensors (kernel) or "
                         f"CPU tensors (plain version), got {device}")
    page_dt = torch.int8 if quantized else torch.float32
    for name, t, dt in (("q", q, torch.float32), ("k_pages", k_pages, page_dt),
                        ("v_pages", v_pages, page_dt),
                        ("page_table", page_table, torch.int32),
                        (rows_name, rows, torch.int32),
                        *((("k_scales", k_scales, torch.float32),
                           ("v_scales", v_scales, torch.float32))
                          if quantized else ())):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not supported by the kernel "
                         f"(one of {_HEAD_DIMS})")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    (rows_name, rows), *((("k_scales", k_scales),
                                          ("v_scales", v_scales))
                                         if quantized else ())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_table.shape[1] > 0 and page_table.stride(1) != 1:
        raise ValueError("page_table rows must be contiguous")
    return device


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scales=None, v_scales=None,
                           sm_scale: Optional[float] = None):
    """Single-query attention of each slot over only its own pages.

    ``q``: (slots, heads, head_dim) float32.  ``k_pages``/``v_pages``:
    (num_pages, heads, page_size, head_dim) — one layer's page pool,
    float32, or int8 with ``k_scales``/``v_scales`` (num_pages,) float32,
    one abs-max scale per pool page.  ``page_table``: (slots, n_blocks)
    int32, each slot's ordered page list (a row-strided slice of a wider
    table is accepted).  ``lengths``: (slots,) int32, the highest valid
    cache position per slot, INCLUSIVE.  Returns (slots, heads,
    head_dim)."""
    device = _check_paged(q, k_pages, v_pages, page_table, lengths,
                          k_scales, v_scales, "lengths")
    if q.ndim != 3:
        raise ValueError(f"q must be (slots, heads, head_dim), got "
                         f"{tuple(q.shape)}")
    d = q.shape[2]
    scale = float(d ** -0.5 if sm_scale is None else sm_scale)
    if device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          lengths, k_scales=k_scales,
                                          v_scales=v_scales, sm_scale=scale)
    S, h, _ = q.shape
    page = k_pages.shape[2]
    out = torch.empty_like(q)
    scales = ()
    if k_pages.dtype == torch.int8:
        kernel, scales = KERNEL_INT8, (k_scales.data_ptr(),
                                       v_scales.data_ptr())
    else:
        kernel = KERNEL
    _launch(kernel, device, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), *scales, page_table.data_ptr(),
            page_table.stride(0), lengths.data_ptr(), out.data_ptr(), S, h,
            page, page_table.shape[1], d, scale)
    return out


def _gather_pages(pages, scales, pt):
    """(P, h, page, d)[pt (S, nb)] -> (S, h, nb*page, d) float32, each
    page times its scale for int8 pools."""
    S, nb = pt.shape
    P, h, page, d = pages.shape
    g = pages[pt].float()
    if scales is not None:
        g = g * scales[pt][..., None, None, None]
    return g.permute(0, 2, 1, 3, 4).reshape(S, h, nb * page, d)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               k_scales=None, v_scales=None,
                               sm_scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_decode_attention`: gather
    each slot's pages (dequantized for int8) into a contiguous cache,
    mask positions past ``lengths``, softmax in float32 (a row with
    denominator 0 divides by 1, as the TPU kernel does)."""
    return paged_verify_attention_ref(q[:, :, None], k_pages, v_pages,
                                      page_table, lengths, k_scales=k_scales,
                                      v_scales=v_scales,
                                      sm_scale=sm_scale)[:, :, 0]


def paged_verify_attention(q, k_pages, v_pages, page_table, positions, *,
                           k_scales=None, v_scales=None,
                           sm_scale: Optional[float] = None):
    """Speculative-verify attention: ``q`` (slots, heads, chunk,
    head_dim) float32 holds a chunk of queries per slot, query ``c`` of
    slot ``s`` at cache position ``positions[s] + c``, attending keys at
    positions ``<= positions[s] + c``; ``chunk`` is any value >= 1.  The
    chunk's own K/V must already be in the pages.  Pages, scales and
    ``page_table`` as :func:`paged_decode_attention`; ``positions``
    (slots,) int32.  Returns (slots, heads, chunk, head_dim)."""
    device = _check_paged(q, k_pages, v_pages, page_table, positions,
                          k_scales, v_scales, "positions")
    if q.ndim != 4:
        raise ValueError(f"q must be (slots, heads, chunk, head_dim), got "
                         f"{tuple(q.shape)}")
    S, h, C, d = q.shape
    scale = float(d ** -0.5 if sm_scale is None else sm_scale)
    if device.type == "cpu":
        return paged_verify_attention_ref(q, k_pages, v_pages, page_table,
                                          positions, k_scales=k_scales,
                                          v_scales=v_scales, sm_scale=scale)
    page = k_pages.shape[2]
    out = torch.empty_like(q)
    scales = ()
    if k_pages.dtype == torch.int8:
        kernel, scales = VERIFY_INT8, (k_scales.data_ptr(),
                                       v_scales.data_ptr())
    else:
        kernel = VERIFY
    _launch(kernel, device, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), *scales, page_table.data_ptr(),
            page_table.stride(0), positions.data_ptr(), out.data_ptr(), S, h,
            page, page_table.shape[1], C, d, scale)
    return out


def paged_verify_attention_ref(q, k_pages, v_pages, page_table, positions,
                               *, k_scales=None, v_scales=None,
                               sm_scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_verify_attention`: gather
    (and dequantize) each slot's pages, mask key positions past
    ``positions + c`` per query, softmax in float32; a row with
    denominator 0 divides by 1."""
    S, h, C, d = q.shape
    nb = page_table.shape[1]
    page = k_pages.shape[2]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    pt = page_table.long()
    k = _gather_pages(k_pages, k_scales, pt)
    v = _gather_pages(v_pages, v_scales, pt)
    sc = torch.einsum("shcd,shkd->shck", q.float() * scale, k)
    key = torch.arange(nb * page, device=q.device)
    lim = positions.long()[:, None] + torch.arange(C, device=q.device)
    valid = (key[None, None, :] <= lim[:, :, None])[:, None]
    sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(torch.finfo(sc.dtype).min)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("shck,shkd->shcd", p, v)
    return (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


# ---- blockwise (flash) attention ------------------------------------------

def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """(sq, skv) True where key j is visible to query i: j <= i, top-left
    aligned as the TPU kernel masks (also when sq != skv)."""
    return torch.ones(sq, skv, dtype=torch.bool, device=device).tril()


def flash_attention_fwd_ref(q, k, v, *, causal: bool, sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward: (out, lse), ``lse`` (b, h, sq)
    the per-row logsumexp of the scaled scores.  Computed in float32 (or
    float64 for float64 inputs); a row with no visible key divides by 1."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct) * sm_scale, k.to(ct))
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], q.device)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(ct)) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_ref(q, k, v, out, lse, g, *, causal: bool,
                            sm_scale: float):
    """Plain version of the flash backward, the recurrence of the TPU
    package's ``_blockwise_bwd``: p = exp(q·kᵀ·scale − lse),
    D = rowsum(g ⊙ out), dS = p ⊙ (g·vᵀ − D)·scale.  Returns (dq, dk, dv)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = q.to(ct), k.to(ct), v.to(ct), g.to(ct)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.to(ct)[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(q.shape[2], k.shape[2], q.device),
                          0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    delta = (gf * out.to(ct)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash(q, k, v, *more) -> torch.device:
    """Shapes (q (b, h, sq, d), k and v (b, h, skv, d)) and one device;
    on CUDA also float32 and a head_dim the kernels take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (batch, heads, seq, head_dim), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[1],
                                            k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    devices = {t.device for t in (q, k, v, *more)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    device = devices.pop()
    if device.type == "cuda":
        for t in (q, k, v, *more):
            if t.dtype != torch.float32:
                raise ValueError(f"the flash kernels take float32, got "
                                 f"{t.dtype}")
        if d not in _HEAD_DIMS:
            raise ValueError(f"head_dim {d} is not supported by the "
                             f"kernels (one of {_HEAD_DIMS})")
    elif device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA tensors (kernels) "
                         f"or CPU tensors (plain versions), got {device}")
    return device


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels read it in place: a contiguous
    head_dim row, the other strides whole float4s and a 16-byte aligned
    start.  Else a contiguous copy.  So the transposed (b, h, s, d) views
    that ``MultiHeadAttention`` and autograd hand over are passed by
    their strides, without a copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % 4 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _view(t: torch.Tensor):
    """The (pointer, batch, head, seq strides) a C entry point takes for
    one (b, h, s, d) operand."""
    return (t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """The flash forward: (out, lse).  CUDA tensors launch
    ``flash_attention_fwd.cu``; CPU tensors take
    :func:`flash_attention_fwd_ref`."""
    device = _check_flash(q, k, v)
    scale = float(q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)
    if device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal,
                                       sm_scale=scale)
    q, k, v = _rows(q), _rows(k), _rows(v)
    b, h, sq, d = q.shape
    out = q.new_empty((b, h, sq, d))
    lse = q.new_empty((b, h, sq))
    _launch(FLASH_FWD, device, *_view(q), *_view(k), *_view(v),
            out.data_ptr(), lse.data_ptr(), b, h, sq, k.shape[2], d, scale,
            int(bool(causal)))
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """The flash backward: (dq, dk, dv) from the forward's residuals and
    the output gradient ``g``.  CUDA tensors launch the two kernels of
    ``flash_attention_bwd.cu`` (dq, which also writes D = rowsum(g ⊙ out),
    then dk/dv); CPU tensors take :func:`flash_attention_bwd_ref`."""
    device = _check_flash(q, k, v, out, g, lse)
    if tuple(out.shape) != tuple(q.shape) or tuple(g.shape) != tuple(
            q.shape) or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"out and g must be {tuple(q.shape)} and lse "
                         f"{tuple(q.shape[:3])}, got {tuple(out.shape)}, "
                         f"{tuple(g.shape)} and {tuple(lse.shape)}")
    scale = float(q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)
    if device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal,
                                       sm_scale=scale)
    q, k, v, out, g = (_rows(t) for t in (q, k, v, out, g))
    lse = lse.contiguous()
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dims = (b, h, sq, skv, d, scale, int(bool(causal)))
    delta = lse.new_empty((b, h, sq))
    dq = q.new_empty((b, h, sq, d))
    dk = q.new_empty((b, h, skv, d))
    dv = q.new_empty((b, h, skv, d))
    _launch(FLASH_BWD_DQ, device, *_view(q), *_view(k), *_view(v),
            *_view(out), *_view(g), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *dims)
    _launch(FLASH_BWD_DKDV, device, *_view(q), *_view(k), *_view(v),
            *_view(g), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *dims)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward, as the TPU package's
    ``jax.custom_vjp``: the forward saves (q, k, v, out, lse) and the
    backward rebuilds p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused blockwise attention.  q: (batch, heads, sq, head_dim); k, v:
    (batch, heads, skv, head_dim), ``skv`` may differ from ``sq``.
    ``causal`` masks keys after the query, top-left aligned; the scale
    defaults to head_dim ** -0.5.  Differentiable: the backward is a
    kernel too on CUDA.  Returns (batch, heads, sq, head_dim)."""
    _check_flash(q, k, v)
    scale = float(q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
