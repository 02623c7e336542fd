"""Prefix/KV-cache reuse — shared-prompt pages prefilled once per worker;
a copy of ``bigdl_tpu.serving.fleet.prefix_cache``.

At fleet scale most prompts share a long common system prefix; paying a
full prefill per request for bytes the worker already computed is pure
waste.  The cache keys *whole finished KV pages* by the token prefix
they cover (the dict lookup hashes the token tuple and verifies equality,
so a hash collision can never alias two different prefixes):

- On completion the engine *donates* the page-aligned prompt-prefix pages
  of a cold request instead of freeing them — ownership moves to the
  cache, so the pages stay out of the engine's free list and page
  accounting stays exact.
- On admission the engine looks up the longest cached page-aligned
  *strict* prefix of the new prompt (strict so the final prefill chunk —
  the one that selects the first token — always runs locally) and maps
  the cached page ids read-only into the slot's page table.  Prefill
  resumes at the attach boundary; the request allocates its own pages
  for everything beyond it (copy-on-extend: shared pages are never
  written — prefill writes at positions >= the attach length, decode at
  positions >= the prompt length).
- Eviction is LRU over entries with zero attached slots only, triggered
  when admission runs out of free pages and bounded by ``max_pages`` at
  insert time — the cache can never starve the live page pool, and never
  frees a page a live slot references.

Byte parity with a cold prefill holds because a position's K/V is a
deterministic causal function of the tokens at or before it and the
engine's prefill math is chunk-boundary- and batch-row-independent (the
padding invariants docs/serving.md §Autoregressive decode pins); the
attach merely substitutes identical bytes for identical work.
tests/test_fleet.py proves it greedy and seeded for the JAX engine, and
tests/test_torch_port_fleet.py for the port on the CPU.  On the card the
port's products go through cuBLAS and its own kernels, which promise
neither chunk-boundary nor row-count independence (ROADMAP C.2): there
the agreement of attached and cold runs is measured, not assumed.

Thread model: ``match/attach/detach/insert/evict`` are called from the
engine thread only; ``stats()`` may be read from any thread.  A small
lock keeps the counters coherent for scrapers.
"""

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache"]


class _Entry:
    __slots__ = ("key", "pages", "refs", "tick")

    def __init__(self, key: Tuple[int, ...], pages: Sequence[int],
                 tick: int):
        self.key = key
        self.pages = list(pages)
        self.refs = 0           # live slots attached to these pages
        self.tick = tick        # LRU clock (monotonic counter, not time)


class PrefixCache:
    """Token-prefix -> KV-page cache with refcounted LRU eviction."""

    def __init__(self, max_pages: int, page_size: int,
                 page_dtype: str = "float32"):
        if max_pages <= 0:
            raise ValueError(f"max_pages must be positive, got {max_pages}")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.max_pages = int(max_pages)
        self.page_size = int(page_size)
        # the storage dtype every cached page shares (docs/quantization.md
        # §Serving memory hierarchy): a cache holding int8 pages + scales
        # must never accept or serve f32 page ids, and vice versa —
        # attaching a mismatched page would dequantize garbage
        self.page_dtype = str(page_dtype)
        self._entries: Dict[Tuple[int, ...], _Entry] = {}
        self._tick = 0
        self._pages_held = 0
        self._lock = threading.Lock()
        self.stats_counters = {"hits": 0, "misses": 0, "insertions": 0,
                               "rejected_insertions": 0, "evictions": 0,
                               "evicted_pages": 0}

    # -- lookup / refcounting (engine thread) ---------------------------

    def match(self, tokens: Sequence[int]) -> Optional[_Entry]:
        """Longest cached page-aligned STRICT prefix of ``tokens``.

        Does not count a hit or take a reference — admission may still
        push the request back (no free pages); call :meth:`attach` once
        the slot is actually granted, or nothing on push-back."""
        n = len(tokens)
        if n < 2:
            return None
        longest = ((n - 1) // self.page_size) * self.page_size
        with self._lock:
            for length in range(longest, 0, -self.page_size):
                entry = self._entries.get(
                    tuple(int(t) for t in tokens[:length]))
                if entry is not None:
                    return entry
        return None

    def attach(self, entry: _Entry) -> None:
        """A slot now references ``entry``'s pages (counts the hit)."""
        with self._lock:
            self._tick += 1
            entry.refs += 1
            entry.tick = self._tick
            self.stats_counters["hits"] += 1

    def detach(self, entry: _Entry) -> None:
        """The slot released ``entry``'s pages."""
        with self._lock:
            entry.refs -= 1
            if entry.refs < 0:  # pragma: no cover - accounting bug guard
                raise AssertionError(
                    f"prefix-cache refcount underflow for {entry.key!r}")

    def record_miss(self) -> None:
        with self._lock:
            self.stats_counters["misses"] += 1

    # -- population / eviction (engine thread) --------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               page_dtype: Optional[str] = None) -> bool:
        """Donate ``pages`` covering exactly ``tokens``.  Returns False
        (caller keeps ownership and frees the pages) when the prefix is
        already cached or the ``max_pages`` budget cannot be made by
        evicting idle entries.  ``page_dtype`` (when given) must match
        the cache's — mixed-dtype page donation is an engine bug, not a
        capacity condition, so it raises instead of returning False."""
        if page_dtype is not None and page_dtype != self.page_dtype:
            raise ValueError(
                f"prefix-cache page dtype mismatch: cache holds "
                f"{self.page_dtype!r} pages, donation is {page_dtype!r}")
        key = tuple(int(t) for t in tokens)
        n = len(pages)
        if n == 0 or len(key) != n * self.page_size:
            return False
        with self._lock:
            if key in self._entries or n > self.max_pages:
                self.stats_counters["rejected_insertions"] += 1
                return False
            over = self._pages_held + n - self.max_pages
            if over > 0 and not self._evict_locked(over):
                self.stats_counters["rejected_insertions"] += 1
                return False
            self._tick += 1
            self._entries[key] = _Entry(key, pages, self._tick)
            self._pages_held += n
            self.stats_counters["insertions"] += 1
            return True

    def evict(self, need_pages: int,
              protect: Optional[_Entry] = None) -> List[int]:
        """Free >= ``need_pages`` pages from idle (refs == 0) entries,
        oldest first; returns the freed page ids (possibly fewer than
        asked when everything else is live).  ``protect`` shields the
        entry the caller is about to attach — it has refs == 0 until the
        admission commits, but its pages are spoken for."""
        with self._lock:
            return self._evict_locked(need_pages, protect) or []

    def _evict_locked(self, need_pages: int,
                      protect: Optional[_Entry] = None) -> List[int]:
        freed: List[int] = []
        while len(freed) < need_pages:
            idle = [e for e in self._entries.values()
                    if e.refs == 0 and e is not protect]
            if not idle:
                break
            victim = min(idle, key=lambda e: e.tick)
            del self._entries[victim.key]
            self._pages_held -= len(victim.pages)
            freed.extend(victim.pages)
            self.stats_counters["evictions"] += 1
            self.stats_counters["evicted_pages"] += len(victim.pages)
        return freed

    # -- introspection (any thread) --------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats_counters)
            out["entries"] = len(self._entries)
            out["pages"] = self._pages_held
            out["page_dtype"] = self.page_dtype
            return out

    @property
    def pages_held(self) -> int:
        with self._lock:
            return self._pages_held

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
