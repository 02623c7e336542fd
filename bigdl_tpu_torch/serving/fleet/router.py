"""KV-aware request placement over worker decode-pressure signals; a
copy of ``bigdl_tpu.serving.fleet.router``.

Round-robin is the right default for stateless predicts, but a generate
request pins a decode *slot* and a run of KV *pages* for its whole
lifetime — placement should follow where that capacity actually is.
Workers already report it: ``/health`` carries a ``decode`` block (free
slots, free pages, prefill backlog — see
``ServingServer.decode_pressure``) plus the pool-wide ``slo_health``
score.  :class:`FleetRouter` turns one snapshot of those signals into a
placement:

- **decode worker** — any worker not dedicated to prefill, scored by
  free slots plus free-page headroom, scaled by ``slo_health`` and
  penalized by queued + in-flight generate work.  Ties break on the
  lower index so placement is deterministic and testable.
- **prefill worker** — only when the topology has dedicated
  ``role="prefill"`` workers (the physical split of
  docs/serving.md §Decode fleet): the least-backlogged prefill worker
  runs the chunked prompt and hands the finished KV pages to the decode
  worker over the :mod:`~bigdl_tpu_torch.serving.fleet.handoff` channel.
  With no prefill-role workers the decode worker prefills locally and
  the second element is None.

The router is pure policy — no I/O, no locks; the pool proxy feeds it
cached ``/health`` snapshots and owns staleness/fallback (a worker with
no decode block, e.g. mid-boot or predict-only, simply scores at zero
pressure-headroom and the proxy's round-robin candidate order still
applies as the fallback)."""

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["FleetRouter"]

# score weights: a free slot is the scarce unit; page headroom breaks
# ties between equally-empty workers; queued work discounts a worker
# that looks free but has admissions racing for it
_W_PAGES = 1.0
_W_BACKLOG = 0.25
_W_PREFILL_BACKLOG = 0.5

# page-headroom weighting by the worker's reported ``page_dtype``
# (docs/quantization.md §Serving memory hierarchy): pages of different
# storage dtypes are NOT interchangeable capacity.  At a fixed HBM
# budget an int8 pool fits ~4x the pages an f32 pool does, so a worker
# reporting the same free-page FRACTION holds ~4x the absolute free
# token capacity — the headroom term counts free pages in
# f32-page-equivalent units rather than scoring the two as equal.
# Workers from before page_dtype existed report nothing and keep the
# f32 weight.
_DTYPE_PAGE_FACTOR = {"float32": 1.0, "bfloat16": 2.0, "int8": 4.0}


def _page_headroom(d: Dict[str, Any]) -> float:
    total_pages = max(float(d.get("total_pages", 0)), 1.0)
    frac = float(d.get("free_pages", 0)) / total_pages
    return frac * _DTYPE_PAGE_FACTOR.get(
        str(d.get("page_dtype", "float32")), 1.0)


class FleetRouter:
    """Pure placement policy: health snapshots in, worker indices out."""

    @staticmethod
    def decode_score(health: Dict[str, Any]) -> float:
        d = health.get("decode") or {}
        slo = float(health.get("slo_health", 1.0))
        free_slots = float(d.get("free_slots", 0))
        backlog = (float(d.get("queued", 0))
                   + float(d.get("generate_inflight", 0)))
        return slo * (free_slots + _W_PAGES * _page_headroom(d)) \
            - _W_BACKLOG * backlog

    @staticmethod
    def prefill_score(health: Dict[str, Any]) -> float:
        d = health.get("decode") or {}
        slo = float(health.get("slo_health", 1.0))
        return slo * (1.0 + _page_headroom(d)) \
            - _W_PREFILL_BACKLOG * float(d.get("prefill_backlog", 0))

    def route(self, healths: Sequence[Dict[str, Any]]
              ) -> Tuple[Optional[int], Optional[int]]:
        """Pick ``(decode_idx, prefill_idx)`` into ``healths``.

        ``prefill_idx`` is None unless the snapshot contains dedicated
        ``role="prefill"`` workers distinct from the chosen decode
        worker; ``(None, None)`` means nothing routable (caller falls
        back to round-robin)."""
        decode_cands: List[int] = []
        prefill_cands: List[int] = []
        for i, h in enumerate(healths):
            if not isinstance(h, dict) or not h.get("alive", True):
                continue
            role = h.get("role", "both")
            if role in ("both", "decode"):
                decode_cands.append(i)
            if role == "prefill":
                prefill_cands.append(i)
        if not decode_cands:
            # a prefill-only fleet can't decode; let the caller fall back
            return (None, None)
        best = max(decode_cands,
                   key=lambda i: (self.decode_score(healths[i]), -i))
        if not prefill_cands:
            return (best, None)
        pre = max(prefill_cands,
                  key=lambda i: (self.prefill_score(healths[i]), -i))
        return (best, pre if pre != best else None)
