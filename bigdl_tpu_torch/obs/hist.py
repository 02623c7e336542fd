"""Bounded log-bucketed histogram — the port of ``bigdl_tpu.obs.hist``
(``LogHistogram``, the histogram ``optim.metrics`` keeps).

One histogram is a fixed array of counts over exponentially growing
buckets (bucket ``i`` covers ``[base*growth^(i-1), base*growth^i)``):
O(1) observe, O(buckets) percentile, bounded memory however many samples
arrive.  With the defaults (0.1 ms base, x2 growth, 40 buckets) the range
spans 0.1 ms to ~15 hours with <= 2x relative error.

Sliding window: beside the cumulative counts, each histogram keeps a
small ring of time-sliced sub-histograms, rotated lazily on observe and
read; ``window_percentile`` / ``window_fraction_over`` answer over the
trailing window only.  An empty window returns NaN, like an empty
histogram.

Not internally locked: the owner (``optim.metrics.Metrics``) serializes
access under its registry lock.
"""

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BASE = 1e-4
_DEFAULT_GROWTH = 2.0
_DEFAULT_BUCKETS = 40
_DEFAULT_WINDOW_S = 60.0
_DEFAULT_WINDOW_SLICES = 6


def percentile_from(counts: Sequence[int], bounds: Sequence[float],
                    n: int, mx: float, q: float) -> float:
    """THE bucket-upper-bound percentile rule, over raw fields — shared
    by live histograms and readers of ``snapshot()`` dicts, so the rule
    cannot fork.
    NaN on empty; the answer is the holding bucket's upper bound clamped
    to the observed max."""
    if n == 0:
        return float("nan")
    rank = max(1, math.ceil(n * q / 100.0))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            bound = bounds[i] if i < len(bounds) else mx
            return min(float(bound), mx)
    return mx


class LogHistogram:
    """Fixed-size log-bucketed histogram of non-negative samples."""

    __slots__ = ("base", "growth", "counts", "n", "sum", "min", "max",
                 "_log_growth", "window_s", "_slice_s", "_slices",
                 "_clock")

    def __init__(self, base: float = _DEFAULT_BASE,
                 growth: float = _DEFAULT_GROWTH,
                 n_buckets: int = _DEFAULT_BUCKETS,
                 window_s: float = _DEFAULT_WINDOW_S,
                 window_slices: int = _DEFAULT_WINDOW_SLICES,
                 clock=time.time):
        if base <= 0 or growth <= 1:
            raise ValueError(f"need base > 0, growth > 1; got {base}, {growth}")
        if window_s <= 0 or window_slices < 1:
            raise ValueError(f"need window_s > 0, window_slices >= 1; got "
                             f"{window_s}, {window_slices}")
        self.base = base
        self.growth = growth
        self._log_growth = math.log(growth)
        # counts[0] covers [0, base); counts[-1] is the overflow bucket
        self.counts: List[int] = [0] * (n_buckets + 2)
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # sliding-window ring: (slice_start_t, counts, n, max) per slice,
        # newest last.  Rotated lazily — no timer thread; an idle
        # histogram simply has only stale slices, which window reads drop
        self.window_s = window_s
        self._slice_s = window_s / window_slices
        self._slices: List[Tuple[float, List[int], int, float]] = []
        self._clock = clock

    def _bucket(self, v: float) -> int:
        if v < self.base:
            return 0
        i = 1 + int(math.log(v / self.base) / self._log_growth)
        return min(i, len(self.counts) - 1)

    def _rotate(self, now: float) -> None:
        """Drop slices fully outside the window; open a fresh slice when
        the newest one's span has elapsed.  Called lazily from observe
        and window reads — rotation and observation are serialized by
        the owner's lock, so a slice is never mutated after it ages out
        (the concurrent-observe regression specs pin this)."""
        cutoff = now - self.window_s
        keep = 0
        for start, _, _, _ in self._slices:
            if start + self._slice_s > cutoff:
                break
            keep += 1
        if keep:
            del self._slices[:keep]
        if not self._slices or now >= self._slices[-1][0] + self._slice_s:
            # align slice starts to the slice grid so rotation cadence is
            # independent of observation timing
            start = math.floor(now / self._slice_s) * self._slice_s
            self._slices.append((start, [0] * len(self.counts), 0,
                                 -math.inf))

    def observe(self, v: float, now: Optional[float] = None) -> None:
        v = float(v)
        if v != v or v < 0:
            # a negative/NaN "latency" is a clock bug upstream; clamping to
            # the underflow bucket beats corrupting every percentile after
            v = 0.0
        now = self._clock() if now is None else now
        self._rotate(now)
        start, counts, n, mx = self._slices[-1]
        if v == math.inf:
            # slower-than-measurable (timeout sentinel): the OVERFLOW
            # bucket — recording it as fastest would invert every
            # percentile.  sum stays finite so the mean survives
            self.counts[-1] += 1
            self.n += 1
            self.max = math.inf
            counts[-1] += 1
            self._slices[-1] = (start, counts, n + 1, math.inf)
            return
        b = self._bucket(v)
        self.counts[b] += 1
        self.n += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        counts[b] += 1
        self._slices[-1] = (start, counts, n + 1, max(mx, v))

    def upper_bounds(self) -> List[float]:
        """Inclusive upper bound of each bucket except the +Inf overflow."""
        return [self.base * self.growth ** i
                for i in range(len(self.counts) - 1)]

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]): the upper bound of
        the bucket holding the q-th sample, clamped to the observed max so
        a single slow request doesn't report a bound 2x above reality.

        Empty histogram: NaN — "no data" must be distinguishable from "a
        0.0s latency" (0.0 once fed a dashboard a phantom perfect p99);
        a single observation reports that observation (its bucket bound
        clamped to the observed max == the sample itself)."""
        return self._percentile_of(self.counts, self.n, self.max, q)

    def _percentile_of(self, counts: List[int], n: int, mx: float,
                       q: float) -> float:
        return percentile_from(counts, self.upper_bounds(), n, mx, q)

    def quantiles(self, qs: Sequence[float] = (50, 95, 99)
                  ) -> Dict[str, float]:
        return {f"p{g:g}": self.percentile(g) for g in qs}

    # -- sliding-window reads (the SLO burn-rate view) ----------------------
    def _window_merge(self, now: Optional[float],
                      window_s: Optional[float]
                      ) -> Tuple[List[int], int, float]:
        """Merged (counts, n, max) over slices inside the trailing
        ``window_s`` (capped at the histogram's own window).  Rotates
        first, so an idle histogram's stale slices never leak in."""
        now = self._clock() if now is None else now
        w = self.window_s if window_s is None \
            else min(window_s, self.window_s)
        self._rotate(now)
        counts = [0] * len(self.counts)
        n, mx = 0, -math.inf
        cutoff = now - w
        for start, c, sn, smx in self._slices:
            # a slice counts when any part of its span is in the window
            if start + self._slice_s <= cutoff or sn == 0:
                continue
            for i, v in enumerate(c):
                counts[i] += v
            n += sn
            mx = max(mx, smx)
        return counts, n, mx

    def window_count(self, now: Optional[float] = None,
                     window_s: Optional[float] = None) -> int:
        return self._window_merge(now, window_s)[1]

    def window_percentile(self, q: float, now: Optional[float] = None,
                          window_s: Optional[float] = None) -> float:
        """q-th percentile over the trailing window only.  An empty
        WINDOW returns NaN even when the cumulative histogram has data —
        same contract as an empty histogram (no recent data is not a
        0.0s recent latency)."""
        counts, n, mx = self._window_merge(now, window_s)
        return self._percentile_of(counts, n, mx, q)

    def window_fraction_over(self, threshold: float,
                             now: Optional[float] = None,
                             window_s: Optional[float] = None) -> float:
        """Fraction of window samples above ``threshold`` — the bad-event
        ratio SLO burn rates divide by the error budget.  Counted at
        bucket granularity: a sample is 'over' when its whole bucket lies
        above the threshold (lower bound >= threshold), so the answer is
        conservative by at most one bucket (<=2x at the default growth,
        exact when the threshold sits on a bucket boundary).  NaN on an
        empty window."""
        counts, n, mx = self._window_merge(now, window_s)
        if n == 0:
            return float("nan")
        bounds = self.upper_bounds()
        over = 0
        for i, c in enumerate(counts):
            lower = 0.0 if i == 0 else bounds[i - 1]
            if lower >= threshold:
                over += c
        return over / n

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy for exporters (taken under the owner's lock)."""
        return {"counts": list(self.counts), "bounds": self.upper_bounds(),
                "n": self.n, "sum": self.sum,
                "min": self.min if self.n else 0.0,
                "max": self.max if self.n else 0.0}
