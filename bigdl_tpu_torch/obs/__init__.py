"""Observability — the port of ``bigdl_tpu.obs``'s histogram."""

from bigdl_tpu_torch.obs.hist import LogHistogram

__all__ = ["LogHistogram"]
