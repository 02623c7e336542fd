"""Data parallelism over ``torch.distributed`` — the port of
``bigdl_tpu.parallel``'s ZeRO-1 wire layer (``collectives``)."""

from bigdl_tpu_torch.parallel import collectives

__all__ = ["collectives"]
