"""Int8 quantization helpers — the port of the plain-array half of
``bigdl_tpu.ops.quantized``: symmetric abs-max scales, per-channel and
blockwise int8, and the per-page quantization of KV page images with the
monotone scale floor the decode engine's int8 pages rest on.

Plain PyTorch, no kernel.  Every rounding is ``torch.round`` (half to
even, as ``jnp.round``) of ``x / scale`` in float32, the order the JAX
package divides in, so the int8 payloads and scales are the JAX ones bit
for bit.  (``int8_matmul`` / ``quantized_linear``, the int8 MXU matmul,
are not ported: no path of the port reaches them yet.)"""

from typing import Optional, Tuple

import torch


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
