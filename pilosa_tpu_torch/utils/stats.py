"""The log-bucket Histogram the admission controller's service-time
estimate reads, and the batcher's batch-size record: the port's copy of
the one class it needs out of pilosa_tpu/utils/stats.py (the statsd and
Prometheus clients around it are not ported)."""

from __future__ import annotations

import bisect
from typing import Tuple

# bucket upper bounds: 1, 2.5 and 5 times each power of ten, 1e-3..5e4
HIST_BOUNDS: Tuple[float, ...] = tuple(m * (10.0**e) for e in range(-3, 5) for m in (1.0, 2.5, 5.0))


class Histogram:
    """Fixed log-bucket histogram: counts per bucket plus exact count,
    sum, min and max. Quantiles interpolate linearly inside the owning
    bucket and clamp to the observed [min, max], so a constant stream
    reports that constant, not a bucket edge. Not self-locking."""

    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.buckets = [0] * (len(HIST_BOUNDS) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        self.buckets[bisect.bisect_left(HIST_BOUNDS, value)] += 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = HIST_BOUNDS[i - 1] if i > 0 else 0.0
                hi = HIST_BOUNDS[i] if i < len(HIST_BOUNDS) else self.vmax
                frac = (rank - cum) / n
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.vmin, min(self.vmax, est))
            cum += n
        return self.vmax

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.vmin,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": self.vmax,
        }
