"""Int8 quantization — the port of ``bigdl_tpu.ops.quantized``: symmetric
abs-max scales, per-channel and blockwise int8, the per-page quantization
of KV page images with the monotone scale floor the decode engine's int8
pages rest on, and the int8 matmul with the quantized dense layer on it.

Every rounding is ``torch.round`` (half to even, as ``jnp.round``) of
``x / scale`` in float32, the order the JAX package divides in, so the
int8 payloads and scales are the JAX ones bit for bit.

:func:`int8_matmul` is the int8 x int8 -> int32 product of a (K, N)
weight: on CUDA tensors the hand-written kernel ``csrc/int8_matmul.cu``
(tensor-core ``mma.sync`` s8 on a ``cp.async`` ring), on CPU tensors its
plain version :func:`int8_matmul_plain`.  The kernel takes its weight
K-major, (N, K): :func:`int8_matmul_nk` is that entry, with the rescale
``acc * sx * w_scales (+ bias)`` optionally fused into its epilogue, and
:func:`int8_plan` the tiles and K splits it launches.
:func:`quantized_linear` is the int8 dense layer on it, with the JAX
package's three activation modes."""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops.common import cdiv, launch, round_up

KERNEL = "int8_matmul"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, ldx, w, ldw, M, K, N, bm, bn, splits, kt_per, ws, ws_ints, out,
# out_f32, sx, sx_mode, sw, bias
_SIGNATURE = (KERNEL, "int8_matmul_s8",
              [_P, _LL, _P, _LL] + [_I] * 7 + [_P, _LL, _P, _I, _P, _I, _P,
                                               _P])
# k bytes a stage of the kernel stages; output tiles that fill less than
# half of the card's 132 SMs split K, each split at least this many
# k-tiles (the kernel's ring holds 4)
INT8_BK = 64
_SMS = 132
_MIN_SPLIT_TILES = 4


def abs_max_scales(x: torch.Tensor, axis) -> torch.Tensor:
    """Symmetric abs-max calibration: the scale that fits ``x / scale``
    into int8, floored at 1e-8 / 127."""
    amax = x.abs().amax(dim=axis)
    return torch.clamp(amax, min=1e-8) / 127.0


def quantize_int8(w: torch.Tensor, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 quantization of a weight; ``axis`` is
    the reduced (contracted) axis, so an (in, out) weight with axis=0
    gets per-out-column scales (out,)."""
    scales = abs_max_scales(w, axis)
    q = torch.clamp(torch.round(w / scales.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scales.float()


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    axis: int = 0) -> torch.Tensor:
    return q.float() * scales.unsqueeze(axis)


def quantize_blockwise(x: torch.Tensor, block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the LAST dimension:
    ``x`` (..., L) with ``L % block == 0``; one abs-max scale per run of
    ``block`` values.  Returns (q int8 (..., L), scales float32
    (..., L // block))."""
    lead, L = x.shape[:-1], x.shape[-1]
    if L % block != 0:
        raise ValueError(f"last dim {L} not a multiple of block {block}")
    xb = x.reshape(*lead, L // block, block)
    scales = abs_max_scales(xb, -1)
    q = torch.clamp(torch.round(xb / scales[..., None]), -127, 127)
    return q.to(torch.int8).reshape(*lead, L), scales.float()


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`; the block size follows from
    the shapes."""
    lead, L = q.shape[:-1], q.shape[-1]
    nb = scales.shape[-1]
    xb = q.float().reshape(*lead, nb, L // nb)
    return (xb * scales[..., None]).reshape(*lead, L)


def quantize_pages(pages: torch.Tensor,
                   floor_scales: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-page symmetric int8 quantization of KV page images: ``pages``
    (..., heads, page_size, head_dim) float32, ONE abs-max scale per
    trailing 3-dim page image, so the scales are (...,).

    ``floor_scales`` (shape of the scales) makes the scale MONOTONE over
    a page's occupancy: ``max(floor, amax / 127)``.  A page whose
    contents came from that grid then requantizes exactly, which is what
    makes the engine's dequantize -> insert -> requantize write-back
    safe; a floor of 0 marks a fresh page, whose stale payload
    dequantizes to zeros until something is written."""
    lead = pages.shape[:-3]
    h, p, d = pages.shape[-3:]
    flat = pages.reshape(*lead, h * p * d)
    if floor_scales is None:
        q, scales = quantize_blockwise(flat, flat.shape[-1])
        return q.reshape(pages.shape), scales[..., 0]
    amax = flat.abs().amax(dim=-1)
    scales = torch.maximum(amax / 127.0, floor_scales.float())
    safe = torch.clamp(scales, min=1e-12)[..., None]
    q = torch.clamp(torch.round(flat / safe), -127, 127).to(torch.int8)
    return q.reshape(pages.shape), scales.float()


def dequantize_pages(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: int8 pages (..., h, p, hd) and
    per-page scales (...,) -> float32 pages."""
    return q.float() * scales[..., None, None, None]


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`, exact: the products and sums
    in float64, where every partial sum of int8 products is an integer far
    below 2^53 (float32's 2^24 is not: K = 4608 reaches 7.4e7)."""
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


@functools.lru_cache(maxsize=4096)
def int8_plan(m: int, k: int, n: int) -> Tuple[int, int, int, int]:
    """The int8 kernel's launch plan for an (M, K) x (K, N) product, a
    function of the shapes alone: (tile rows, tile columns, K splits,
    64-byte k-tiles a split).  Tiles are 128 x 128, or 128 x 64 where
    N <= 64.  Where the tiles fill less than half of the card's 132 SMs
    (the head at every batch, the late stages at small ones), K is cut
    into splits of at least four k-tiles, until the blocks number about
    one a SM; every split is non-empty and together they cover K.  Each
    split costs an int32 partial of (M, N) in the workspace."""
    bm, bn = 128, (64 if n <= 64 else 128)
    k_tiles = cdiv(k, INT8_BK)
    tiles = cdiv(m, bm) * cdiv(n, bn)
    splits = 1
    if tiles < _SMS // 2:
        splits = max(1, min(cdiv(_SMS, tiles), k_tiles // _MIN_SPLIT_TILES))
    per = max(1, cdiv(k_tiles, splits))
    return bm, bn, max(1, cdiv(k_tiles, per)), per


def rescale_plain(acc: torch.Tensor, sx: Optional[torch.Tensor],
                  w_scales: torch.Tensor, bias=None) -> torch.Tensor:
    """The int8 layer's output rescale as plain float32 passes, in the
    order the kernel's epilogue repeats: ``acc * sx`` (per row, a scalar,
    or skipped when ``sx`` is None), then ``* w_scales``, then ``+
    bias``."""
    y = acc.float()
    if sx is not None:
        y = y * sx
    y = y * w_scales[None, :]
    if bias is not None:
        y = y + bias
    return y


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``x_q`` (M, K) times int8 ``w_q`` (K, N) -> int32 (M, N),
    exact, for any M, K, N.  CUDA tensors launch the kernel and must be
    contiguous (the weight is handed to it K-major, a copy of (N, K));
    CPU tensors take the plain version."""
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) x (K, N), got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got {x_q.dtype} "
                         f"and {w_q.dtype}")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on different devices: {x_q.device} "
                         f"and {w_q.device}")
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA tensors (kernel) or CPU "
                         f"tensors (plain version), got {x_q.device}")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("the int8_matmul kernel takes contiguous row-major "
                         "operands")
    return int8_matmul_nk(x_q, w_q.t().contiguous())


def int8_matmul_nk(x_q: torch.Tensor, w_nk: torch.Tensor,
                   w_scales: Optional[torch.Tensor] = None,
                   sx: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 ``x_q`` (M, K) times the K-major int8 weight ``w_nk`` (N, K)
    — the entry the int8 layers call.  Without ``w_scales``: int32 (M,
    N), exact.  With ``w_scales`` (N,): float32 ``acc * sx * w_scales (+
    bias)``, fused into the kernel's epilogue on CUDA (bit-equal to
    :func:`rescale_plain` on the same payloads); ``sx`` is (M, 1) or (M,)
    per row, a scalar, or None (per-channel scales folded into the
    weight).

    ``x_q``'s rows may be a row-strided view (:func:`quantize_activations`
    pads them to 16 bytes); a weight that is not a contiguous (N, K) is
    copied into one.  CPU tensors take the plain version."""
    if x_q.ndim != 2 or w_nk.ndim != 2 or x_q.shape[1] != w_nk.shape[1]:
        raise ValueError(f"int8_matmul_nk takes (M, K) x (N, K), got "
                         f"{tuple(x_q.shape)} and {tuple(w_nk.shape)}")
    if x_q.dtype != torch.int8 or w_nk.dtype != torch.int8:
        raise ValueError(f"int8_matmul_nk takes int8 operands, got "
                         f"{x_q.dtype} and {w_nk.dtype}")
    if x_q.device != w_nk.device:
        raise ValueError(f"operands on different devices: {x_q.device} "
                         f"and {w_nk.device}")
    if x_q.device.type == "cpu":
        acc = int8_matmul_plain(x_q, w_nk.t())
        return acc if w_scales is None else rescale_plain(acc, sx, w_scales,
                                                          bias)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul_nk runs on CUDA tensors (kernel) or "
                         f"CPU tensors (plain version), got {x_q.device}")
    (m, k), n = x_q.shape, w_nk.shape[0]
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"int8_matmul: ({m}, {k}) x ({k}, {n}) has a dim "
                         f"past the kernel's int32 sizes")
    if k > 1 and x_q.stride(1) != 1:
        raise ValueError("the int8 kernel takes x rows with unit stride")
    if not w_nk.is_contiguous():
        w_nk = w_nk.contiguous()
    ldx = x_q.stride(0) if m > 1 else k
    dev = x_q.device
    bm, bn, splits, per = int8_plan(m, k, n)
    # int32 partials of a split K, summed by the same call
    ws_ints = splits * m * n if splits > 1 else 0
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dev) \
        if ws_ints else None
    sxv = sw = b = None
    mode = 0
    if w_scales is None:
        out = torch.empty((m, n), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        sw = _f32_vector(w_scales, n, "w_scales", dev)
        b = None if bias is None else _f32_vector(bias, n, "bias", dev)
        if sx is not None:
            sxv = _f32_vector(sx, sx.numel(), "sx", dev)
            mode = 1 if sxv.numel() == 1 else 2
            if mode == 2 and sxv.numel() != m:
                raise ValueError(f"sx must be a scalar or one scale per "
                                 f"row ({m}), got {tuple(sx.shape)}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch(KERNEL, _SIGNATURE, dev, x_q.data_ptr(), ldx, w_nk.data_ptr(), k,
           m, k, n, bm, bn, splits, per, ptr(ws), ws_ints, out.data_ptr(),
           int(w_scales is not None), ptr(sxv), mode, ptr(sw), ptr(b))
    return out


def _f32_vector(t, n: int, name: str, device) -> torch.Tensor:
    """``t`` as n contiguous, 16-byte aligned float32 values on ``device``
    (the kernel's epilogue reads them in float4s; an exact conversion for
    float16 / bfloat16 values).  A tensor that already is one (a layer's
    scales, a per-row sx) passes as it is, with no torch call."""
    if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
            and t.device == device and t.numel() == n
            and t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    v = torch.as_tensor(t, device=device).to(torch.float32).reshape(-1)
    if v.numel() != n:
        raise ValueError(f"{name} must hold {n} values, got "
                         f"{tuple(torch.as_tensor(t).shape)}")
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def quantize_activations(x2: torch.Tensor, act_scale=None,
                         row_align: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Rows of ``x2`` (M, K) to int8, as the JAX ``quantized_linear``
    quantizes them: per-row abs-max scales (``act_scale=None``, dynamic),
    one calibrated scalar scale, or calibrated per-column scales (K,).
    Returns (row-major int8 (M, K), the scale it divided by, per-column
    or not).  With ``row_align`` (16 for the kernel's 16-byte staging)
    the rows start ``round_up(K, row_align)`` bytes apart, a view of a
    padded buffer whose padding is never read; by default they are
    contiguous.  Runs in the profiler range ``int8_quantize_activations``."""
    with torch.profiler.record_function("int8_quantize_activations"):
        per_channel = act_scale is not None and torch.as_tensor(
            act_scale).ndim == 1
        if act_scale is None:
            sx = abs_max_scales(x2, 1)[:, None]              # (M, 1)
        else:
            sx = torch.as_tensor(act_scale, dtype=torch.float32,
                                 device=x2.device)
            if per_channel:
                sx = sx[None, :]                             # (1, K)
        # row-major whatever x2's strides: the kernel takes rows of unit
        # stride
        q = torch.clamp(torch.round(x2 / sx), -127, 127)
        m, k = q.shape
        pitch = round_up(k, row_align)
        if pitch == k:
            x_q = q.to(torch.int8).contiguous()
        else:
            x_q = torch.empty((m, pitch), dtype=torch.int8,
                              device=q.device)[:, :k]
            x_q.copy_(q)
    return x_q, sx, per_channel


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scales: torch.Tensor, bias=None,
                     act_scale=None) -> torch.Tensor:
    """Dense layer on a pre-quantized (in, out) int8 weight with
    per-out-column ``w_scales``: the activations are quantized (see
    :func:`quantize_activations`), multiplied on the int8 kernel
    (:func:`int8_matmul_nk` with ``w_q``'s K-major transpose, which the
    int8 modules store so that it needs no copy), and rescaled ``acc *
    sx * w_scales`` in that order, in the kernel's epilogue on CUDA.
    With per-column ``act_scale`` the caller has folded the scales into
    the weight's rows before quantizing it, so the rescale is ``acc *
    w_scales``."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q, sx, per_channel = quantize_activations(x.reshape(-1, k), act_scale,
                                                row_align=16)
    y = int8_matmul_nk(x_q, w_q.t(), w_scales,
                       None if per_channel else sx, bias)
    return y.reshape(*lead, w_q.shape[1]).to(x.dtype)
