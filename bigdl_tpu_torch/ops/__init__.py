"""Kernel layer: hand-written CUDA kernels (``csrc/``), their wrappers
and plain PyTorch versions."""

from bigdl_tpu_torch.ops.common import (LAUNCHES, cdiv, reset_launches,
                                        resolve_device, round_up)
from bigdl_tpu_torch.ops.flash_attention import (paged_decode_attention,
                                                 paged_decode_attention_ref)

__all__ = ["LAUNCHES", "cdiv", "paged_decode_attention",
           "paged_decode_attention_ref", "reset_launches", "resolve_device",
           "round_up"]
