"""Mixed-precision policy — the port of ``bigdl_tpu.tensor.policy``.

Params live in float32.  Matmuls and convolutions take their inputs in
the compute dtype, cast at the same call sites as in the JAX package
(:func:`cast_compute`), and accumulate in float32.  As the JAX package
defaults to bfloat16 on its accelerator and float32 elsewhere, the port
defaults to bfloat16 for a CUDA tensor and float32 for a CPU tensor:
the default is resolved per tensor device, so a CPU run on a machine
with a card stays float32.  :func:`set_compute_dtype` or the
:func:`compute_dtype` context pins one dtype for every device
(``compute_dtype(torch.float32)`` pins float32 on the card).

A product of compute-dtype operands is :func:`matmul_f32`: its result
is float32 with no output rounding (JAX's
``preferred_element_type=float32``), and its gradients follow JAX's VJP
(:class:`_MatmulF32`).  A float32 operand against a cast one
promotes to a float32 product (:func:`matmul_promote`).  Convolutions
on bfloat16 inputs round their output to bfloat16, as the JAX package's
``_conv_accum`` leaves them (``nn.layers.conv2d_nhwc``).

:func:`apply_precision_policy` keeps TF32 off, so the float32 path is
exact float32, and keeps cuBLAS's bfloat16 sums in float32."""

from contextlib import contextmanager
from typing import Optional

import torch

from bigdl_tpu_torch.ops.common import is_dtensor

# None = the device's default (bfloat16 on CUDA, float32 elsewhere)
_COMPUTE_DTYPE = [None]

_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        if dtype not in _NAMES:
            raise ValueError(f"compute dtype {dtype!r}: bfloat16 | float32")
        return _NAMES[dtype]
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute dtype {dtype}: bfloat16 | float32")
    return dtype


def apply_precision_policy() -> None:
    """Exact float32 products and convolutions (no TF32), and float32
    sums inside cuBLAS's bfloat16 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def set_compute_dtype(dtype) -> None:
    """Pin ``dtype`` for every device; ``None`` restores the per-device
    default."""
    _COMPUTE_DTYPE[0] = None if dtype is None else _as_dtype(dtype)


def get_compute_dtype(device=None) -> torch.dtype:
    """The pinned dtype, else the default of ``device``: bfloat16 for a
    CUDA device, float32 otherwise (and without a device)."""
    if _COMPUTE_DTYPE[0] is not None:
        return _COMPUTE_DTYPE[0]
    if device is not None and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


@contextmanager
def compute_dtype(dtype):
    """Pin ``dtype`` inside the block and restore what was set before
    (a pinned dtype or the per-device default)."""
    old = _COMPUTE_DTYPE[0]
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE[0] = old


def cast_compute(*tensors):
    """Cast op inputs to the compute dtype of the first one's device
    (no-op when already matching)."""
    dt = get_compute_dtype(tensors[0].device)
    out = tuple(t if t.dtype == dt else t.to(dt) for t in tensors)
    return out if len(out) > 1 else out[0]


def _product_f32(a, b, out_dtype: Optional[torch.dtype] = None):
    """``a @ b`` (``b`` 2-D or batched like ``a``) with a float32 result,
    rounded to ``out_dtype`` when given.  On CUDA (equal-dtype operands)
    one cuBLAS product with float32 accumulation (``out_dtype=float32``,
    or the operands' own dtype where the result is rounded to it
    anyway); on the CPU, and for a layout's DTensors (DTensor has no
    sharding rule for ``mm`` / ``bmm`` with ``out_dtype``), the operands
    widened exactly and multiplied in float32."""
    if a.device.type != "cuda" or is_dtensor(a) or is_dtensor(b):
        y = torch.matmul(a.float(), b.float())
        return y if out_dtype is None else y.to(out_dtype)
    if out_dtype == a.dtype:
        return torch.matmul(a, b)
    k = a.shape[-1]
    if b.dim() == 2:
        y = torch.mm(a.reshape(-1, k), b, out_dtype=torch.float32)
        y = y.reshape(*a.shape[:-1], b.shape[-1])
    else:
        lead = a.shape[:-2]
        y = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                      b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        y = y.reshape(*lead, *y.shape[-2:])
    return y if out_dtype is None else y.to(out_dtype)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two bfloat16 operands, float32 out, with JAX's VJP of
    ``matmul(bf16, bf16, preferred_element_type=float32)``: the float32
    cotangent ``g`` meets each operand, and each gradient is rounded to
    its operand's dtype (the cast's own VJP widens it back):
    ``da = bf16(g @ bᵀ)``, ``db = bf16(aᵀ @ g)``.

    On the CPU ``g`` stays float32, as in JAX.  On the card a float32 ×
    bfloat16 product has no tensor-core form, so ``g`` is rounded to
    bfloat16 before each backward product, as the TPU's MXU rounds a
    float32 operand at its default precision (ROADMAP C.15)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if g.device.type == "cuda":
            g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product_f32(g, b.transpose(-1, -2), a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:    # summed over a's leading dims
                a2 = a.reshape(-1, a.shape[-1]).t()
                g2 = g.reshape(-1, g.shape[-1])
            else:
                a2, g2 = a.transpose(-1, -2), g
            db = _product_f32(a2, g2, b.dtype)
        return da, db


def matmul_f32(x, w):
    """``cast_compute(x) @ cast_compute(w)`` with a float32 result: JAX's
    ``matmul(xc, wc, preferred_element_type=float32)``.  ``w`` is 2-D
    (broadcast over ``x``'s leading dims) or batched like ``x``.  In
    float32 this is ``torch.matmul``; in bfloat16 the product
    accumulates in float32 and its output is not rounded."""
    xc, wc = cast_compute(x, w)
    if xc.dtype == torch.float32:
        return torch.matmul(xc, wc)
    return _MatmulF32.apply(xc, wc)


def matmul_promote(a, w):
    """``a @ cast_compute(w)`` for a float32 ``a``: JAX promotes the cast
    operand back to float32, so this is a float32 product of ``a`` and
    the rounded ``w`` (``jnp.matmul(a, cast_compute(w),
    preferred_element_type=float32)``)."""
    return torch.matmul(a.float(), cast_compute(w).float())
