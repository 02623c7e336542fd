"""Paged decode-step attention — the port of
``bigdl_tpu.ops.flash_attention.paged_decode_attention``.

The wrapper launches the hand-written CUDA kernel
(``csrc/paged_decode_attention.cu``) for CUDA tensors and takes the
plain PyTorch version, :func:`paged_decode_attention_ref`, only for
tensors that lie on the CPU.  There is no fallback: a CUDA tensor
either reaches the kernel or the call raises."""

import ctypes
from typing import Optional

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.common import LAUNCHES

KERNEL = "paged_decode_attention"
_HEAD_DIMS = (32, 64, 128)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.load(KERNEL)
        fn = lib.paged_decode_attention_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_decode_attention_error.argtypes = [ctypes.c_int]
        lib.paged_decode_attention_error.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_decode_attention_error)
    return _fn


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(f"q must be (slots, heads, head_dim) and pages "
                         f"(pages, heads, page, head_dim), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    S, h, d = q.shape
    if k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8:
        raise ValueError("int8 KV pages are not ported yet; "
                         "pass float32 pages")
    if tuple(v_pages.shape) != tuple(k_pages.shape) \
            or (k_pages.shape[1], k_pages.shape[3]) != (h, d):
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != S \
            or tuple(lengths.shape) != (S,):
        raise ValueError(f"page_table must be (slots, n_blocks) and "
                         f"lengths (slots,) for {S} slots, got "
                         f"{tuple(page_table.shape)} and "
                         f"{tuple(lengths.shape)}")
    devices = {t.device for t in (q, k_pages, v_pages, page_table,
                                  lengths)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return devices.pop()


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale: Optional[float] = None):
    """Single-query attention of each slot over only its own pages.

    ``q``: (slots, heads, head_dim) float32.  ``k_pages``/``v_pages``:
    (num_pages, heads, page_size, head_dim) float32 — one layer's page
    pool.  ``page_table``: (slots, n_blocks) int32, each slot's ordered
    page list (a row-strided slice of a wider table is accepted).
    ``lengths``: (slots,) int32, the highest valid cache position per
    slot, INCLUSIVE.  Returns (slots, heads, head_dim)."""
    device = _check(q, k_pages, v_pages, page_table, lengths)
    d = q.shape[2]
    scale = float(d ** -0.5 if sm_scale is None else sm_scale)
    if device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          lengths, sm_scale=scale)
    if device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on CUDA tensors "
                         f"(kernel) or CPU tensors (plain version), got "
                         f"{device}")
    for name, t, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("page_table", page_table, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not supported by the kernel "
                         f"(one of {_HEAD_DIMS})")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_table.shape[1] > 0 and page_table.stride(1) != 1:
        raise ValueError("page_table rows must be contiguous")
    S, h, _ = q.shape
    page = k_pages.shape[2]
    out = torch.empty_like(q)
    fn, err_str = _entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), page_table.stride(0),
                 lengths.data_ptr(), out.data_ptr(), S, h, page,
                 page_table.shape[1], d, scale, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    LAUNCHES[KERNEL] += 1
    return out


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               sm_scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_decode_attention`: gather
    each slot's pages into a contiguous cache, mask positions past
    ``lengths``, softmax in float32 (a row with denominator 0 divides by
    1, as the TPU kernel does)."""
    S, h, d = q.shape
    nb = page_table.shape[1]
    page = k_pages.shape[2]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    pt = page_table.long()
    k = k_pages[pt].float().permute(0, 2, 1, 3, 4).reshape(S, h, nb * page, d)
    v = v_pages[pt].float().permute(0, 2, 1, 3, 4).reshape(S, h, nb * page, d)
    sc = torch.einsum("shd,shkd->shk", q.float() * scale, k)
    pos = torch.arange(nb * page, device=q.device)
    valid = (pos[None, :] <= lengths[:, None].long())[:, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(torch.finfo(sc.dtype).min)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("shk,shkd->shd", p, v)
    return (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
