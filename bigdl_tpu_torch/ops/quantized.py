"""Int8 quantization — the port of ``bigdl_tpu.ops.quantized``: symmetric
abs-max scales, per-channel and blockwise int8, the per-page quantization
of KV page images with the monotone scale floor the decode engine's int8
pages rest on, and the int8 matmul with the quantized dense layer on it.

Every rounding is ``torch.round`` (half to even, as ``jnp.round``) of
``x / scale`` in float32, the order the JAX package divides in, so the
int8 payloads and scales are the JAX ones bit for bit.

:func:`int8_matmul` is the int8 x int8 -> int32 product: on CUDA tensors
the hand-written kernel ``csrc/int8_matmul.cu`` (tensor-core
``mma.sync`` s8), on CPU tensors its plain version
:func:`int8_matmul_plain`.  :func:`quantized_linear` is the int8 dense
layer on it, with the JAX package's three activation modes."""

import ctypes
from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops.common import launch

KERNEL = "int8_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, out, M, K, N
_SIGNATURE = (KERNEL, "int8_matmul_s8", [_P, _P, _P, _I, _I, _I])


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


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``x_q`` (M, K) times int8 ``w_q`` (K, N) -> int32 (M, N),
    exact, for any M, K, N.  CUDA tensors launch the kernel and must be
    contiguous; CPU tensors take the plain version."""
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
    (m, k), n = x_q.shape, w_q.shape[1]
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"int8_matmul: ({m}, {k}) x ({k}, {n}) has a dim "
                         f"past the kernel's int32 sizes")
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    launch(KERNEL, _SIGNATURE, x_q.device, x_q.data_ptr(), w_q.data_ptr(),
           out.data_ptr(), m, k, n)
    return out


def quantize_activations(x2: torch.Tensor, act_scale=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Rows of ``x2`` (M, K) to int8, as the JAX ``quantized_linear``
    quantizes them: per-row abs-max scales (``act_scale=None``, dynamic),
    one calibrated scalar scale, or calibrated per-column scales (K,).
    Returns (contiguous int8 (M, K), the scale it divided by, per-column
    or not).  Runs in the profiler range ``int8_quantize_activations``."""
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
        # contiguous whatever x2's strides: the kernel takes row-major
        # operands
        x_q = torch.clamp(torch.round(x2 / sx), -127, 127).to(
            torch.int8).contiguous()
    return x_q, sx, per_channel


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scales: torch.Tensor, bias=None,
                     act_scale=None) -> torch.Tensor:
    """Dense layer on a pre-quantized (in, out) int8 weight with
    per-out-column ``w_scales``: the activations are quantized (see
    :func:`quantize_activations`), multiplied on :func:`int8_matmul`, and
    rescaled ``acc * sx * w_scales`` in that order.  With per-column
    ``act_scale`` the caller has folded the scales into the weight's rows
    before quantizing it, so the rescale is ``acc * w_scales``."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q, sx, per_channel = quantize_activations(x.reshape(-1, k), act_scale)
    acc = int8_matmul(x_q, w_q).float()
    y = (acc * w_scales[None, :] if per_channel
         else acc * sx * w_scales[None, :])
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, w_q.shape[1]).to(x.dtype)
