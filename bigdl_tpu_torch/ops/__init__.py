"""Kernel layer: hand-written CUDA kernels (``csrc/``), their wrappers
and plain PyTorch versions."""

from bigdl_tpu_torch.ops.common import (LAUNCHES, cdiv, reset_launches,
                                        resolve_device, round_up)
from bigdl_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_fwd, flash_attention_fwd_ref, paged_decode_attention,
    paged_decode_attention_ref)
from bigdl_tpu_torch.ops.quantized import (int8_matmul, int8_matmul_plain,
                                           quantized_linear)

__all__ = ["LAUNCHES", "cdiv", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref", "int8_matmul", "int8_matmul_plain",
           "paged_decode_attention", "paged_decode_attention_ref",
           "quantized_linear", "reset_launches",
           "resolve_device", "round_up"]
