"""Kernel layer: hand-written CUDA kernels (``csrc/``), their wrappers
and plain PyTorch versions."""

from bigdl_tpu_torch.ops.common import (LAUNCHES, cdiv, reset_launches,
                                        resolve_device, round_up)
from bigdl_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_fwd, flash_attention_fwd_ref, paged_decode_attention,
    paged_decode_attention_ref)

__all__ = ["LAUNCHES", "cdiv", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref", "paged_decode_attention",
           "paged_decode_attention_ref", "reset_launches", "resolve_device",
           "round_up"]
