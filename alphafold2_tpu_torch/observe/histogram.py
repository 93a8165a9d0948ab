"""Streaming histogram with percentile snapshots.

Port of ``alphafold2_tpu/observe/histogram.py``, the same buckets and
arithmetic, so a snapshot of the same observations is the same dict.
Log-spaced buckets (bounded memory whatever the stream length) with exact
min/max/sum tracking: percentile estimates carry the bucket's relative
error (~``growth - 1``) but clamp to the true extremes, which is what a
latency distribution needs — p50/p95/p99 to a few percent, never a bogus
tail. Replaces the serve engine's single ``latency_s`` scalar with real
distributions (queue wait, dispatch time, batch occupancy, pad ratio).
"""

from __future__ import annotations

import math
import threading


class Histogram:
    """Thread-safe streaming histogram over non-negative values.

    ``growth`` is the geometric bucket ratio (default 1.1 → ≤5% relative
    percentile error); values at or below ``floor`` share one underflow
    bucket (exact zeros are common: queue wait of the first dispatch,
    pad ratio of an exact-fit request)."""

    def __init__(self, growth: float = 1.1, floor: float = 1e-9):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self._growth = growth
        self._log_growth = math.log(growth)
        self._floor = floor
        self._counts: dict = {}  # bucket index -> count; -inf bucket is None
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def _index(self, value: float):
        if value <= self._floor:
            return None  # underflow bucket
        return int(math.floor(math.log(value / self._floor) / self._log_growth))

    def observe(self, value: float) -> None:
        value = float(value)
        if value < 0 or not math.isfinite(value):
            raise ValueError(f"histogram values must be finite and >= 0: {value}")
        with self._lock:
            idx = self._index(value)
            self._counts[idx] = self._counts.get(idx, 0) + 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100])."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q / 100.0 * self._count
        seen = 0
        # None (underflow) sorts before every finite bucket index
        for idx in sorted(
            self._counts, key=lambda i: -math.inf if i is None else i
        ):
            seen += self._counts[idx]
            if seen >= rank:
                if idx is None:
                    return self._min if math.isfinite(self._min) else 0.0
                # geometric bucket midpoint, clamped to observed extremes
                mid = self._floor * self._growth ** (idx + 0.5)
                return min(max(mid, self._min), self._max)
        return self._max

    def snapshot(self, unit_scale: float = 1.0, digits: int = 4) -> dict:
        """One summary dict: count/mean/p50/p95/p99/min/max, values scaled
        by ``unit_scale`` (e.g. 1e3 for seconds → ms in a record)."""
        with self._lock:
            if self._count == 0:
                return {"count": 0}

            def r(v):
                return round(v * unit_scale, digits)

            return {
                "count": self._count,
                "mean": r(self._sum / self._count),
                "p50": r(self._percentile_locked(50)),
                "p95": r(self._percentile_locked(95)),
                "p99": r(self._percentile_locked(99)),
                "min": r(self._min),
                "max": r(self._max),
            }
