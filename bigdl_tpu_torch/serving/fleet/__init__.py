"""Decode fleet — the port of ``bigdl_tpu.serving.fleet``: the pieces a
multi-worker pool places and splits generation with.

- :class:`~bigdl_tpu_torch.serving.fleet.router.FleetRouter` — KV-aware
  placement of generate requests over the decode-pressure snapshots
  workers report (``DecodeEngine.decode_pressure``).
- :mod:`~bigdl_tpu_torch.serving.fleet.handoff` — the serialized page
  transfer of the prefill/decode split (``DecodeRequest(export_kv=True)``
  on one engine, ``DecodeEngine.submit_prefilled`` on another), in the
  JAX package's wire format.
- :class:`~bigdl_tpu_torch.serving.fleet.prefix_cache.PrefixCache` — per-
  engine reuse of the KV pages of shared token prefixes
  (``DecodeConfig.prefix_cache_pages``).

All three are pure Python over numpy and import no torch."""

from bigdl_tpu_torch.serving.fleet.handoff import (HandoffError, pack_handoff,
                                                   unpack_handoff)
from bigdl_tpu_torch.serving.fleet.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.fleet.router import FleetRouter

__all__ = ["FleetRouter", "HandoffError", "PrefixCache", "pack_handoff",
           "unpack_handoff"]
