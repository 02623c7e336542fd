"""Mixed-precision policy — the port of ``bigdl_tpu.tensor.policy``.

Params live in float32.  Matmul inputs are cast to the compute dtype at
the same call sites as in the JAX package (:func:`cast_compute`).  The
compute dtype is float32 on every device for now, with TF32 off for
matmuls and cuDNN, so the card computes what the CPU tests check.
Whether to default to bfloat16 on the card is a decision for a measured
later change."""

import torch

_COMPUTE_DTYPE = [torch.float32]


def apply_precision_policy() -> None:
    """Pin full float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_compute_dtype(dtype) -> None:
    _COMPUTE_DTYPE[0] = torch.float32 if dtype is None else dtype


def get_compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE[0]


def cast_compute(*tensors):
    """Cast op inputs to the compute dtype (no-op when already matching)."""
    dt = get_compute_dtype()
    out = tuple(t if t.dtype == dt else t.to(dt) for t in tensors)
    return out if len(out) > 1 else out[0]
