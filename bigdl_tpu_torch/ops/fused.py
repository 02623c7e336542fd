"""Fused LayerNorm — the port of ``bigdl_tpu.ops.fused``.

:func:`fused_layernorm` normalizes over the last axis with gamma and
beta.  On CUDA tensors the forward is the hand-written kernel
``csrc/fused_layernorm.cu`` (one warp a row, the row held in registers
between the two reductions); on CPU tensors it is the plain version
:func:`fused_layernorm_plain`.  Both take the mean, then the mean of the
squared deviations, then ``rsqrt(var + eps)``, as the JAX kernel does.
The backward is the closed-form LayerNorm VJP in plain torch, as the JAX
package's is (no kernel there either).  The JAX ``block_rows`` (the TPU
autotune cache's tile) and ``interpret`` arguments have no counterpart
here."""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.ops.common import launch

KERNEL = "fused_layernorm"
_P = ctypes.c_void_p
# x, gamma, beta, out, rows, d, eps
_SIGNATURE = (KERNEL, "fused_layernorm_f32",
              [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_float])


def fused_layernorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, eps: float = 1e-5
                          ) -> torch.Tensor:
    """Plain version of the kernel: LayerNorm over the last axis in
    float32, the result in ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return ((x32 - mean) * inv * gamma.float() + beta.float()).to(x.dtype)


def _ln_forward(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm runs on CUDA tensors (kernel) or "
                         f"CPU tensors (plain version), got {x.device}")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32:
            raise ValueError(f"the fused_layernorm kernel takes float32, "
                             f"got {name} {t.dtype}")
    d = x.shape[-1]
    # a view of a transposed tensor is copied, never read with the
    # wrong strides
    x2 = x.reshape(-1, d).contiguous()
    g, b = gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x2)
    launch(KERNEL, _SIGNATURE, x.device, x2.data_ptr(), g.data_ptr(),
           b.data_ptr(), out.data_ptr(), x2.shape[0], d, float(eps))
    return out.reshape(x.shape)


class _FusedLayerNorm(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves (x, gamma, beta), the
    backward recomputes the statistics in float32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return _ln_forward(x, gamma, beta, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        lead = tuple(range(x.ndim - 1))
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mean) * inv
        dgamma = (gf * xhat).sum(dim=lead)
        dbeta = gf.sum(dim=lead)
        gy = gf * gamma.float()
        dx = inv * (gy - gy.mean(dim=-1, keepdim=True)
                    - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
        # each gradient in its primal's dtype
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None)


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, *, eps: float = 1e-5
                    ) -> torch.Tensor:
    """LayerNorm of ``x`` (..., d) over its last axis with ``gamma`` and
    ``beta`` (d,); the statistics in float32, the result in ``x``'s
    dtype.  CUDA tensors launch the kernel and must be float32 (any
    layout: a non-contiguous ``x`` is copied first); CPU tensors take the
    plain version.  Differentiable in all three."""
    d = x.shape[-1]
    if tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
        raise ValueError(f"gamma and beta must be ({d},) for x "
                         f"{tuple(x.shape)}, got {tuple(gamma.shape)} and "
                         f"{tuple(beta.shape)}")
    if not (x.device == gamma.device == beta.device):
        raise ValueError(f"x, gamma and beta on different devices: "
                         f"{x.device}, {gamma.device}, {beta.device}")
    return _FusedLayerNorm.apply(x, gamma, beta, float(eps))
