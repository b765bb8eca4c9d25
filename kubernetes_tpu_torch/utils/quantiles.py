"""Streaming quantile estimation: the P-squared (P²) algorithm.

Jain & Chlamtac, "The P² algorithm for dynamic calculation of quantiles
and histograms without storing observations" (CACM 1985): five markers
per tracked quantile, O(1) per observation, no sample buffer. This is
the live pod-to-bind p50/p99 the metrics endpoint exposes as gauges --
the same estimate the AutoBatchController can consume, without the
bench's sort-everything post-processing.

Accuracy is a function of the stream, not the implementation: for the
unimodal latency distributions the scheduler produces, the estimate
lands within a few percent of the exact percentile (unit-pinned against
numpy in tests/test_flightrecorder.py).
"""

from __future__ import annotations

import threading
from bisect import insort
from typing import Dict, Optional, Sequence


class P2Quantile:
    """One P² estimator for a single quantile ``q`` in (0, 1).

    Not thread-safe on its own; ``QuantileSet`` adds the lock the
    concurrent bind paths need.
    """

    __slots__ = ("q", "_n", "_init", "_heights", "_pos", "_desired", "_incr")

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._n = 0
        self._init: list = []  # first five observations, kept sorted
        self._heights: list = []  # marker heights q_i
        self._pos: list = []  # marker positions n_i (1-based)
        self._desired: list = []  # desired positions n'_i
        self._incr = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def observe(self, x: float) -> None:
        self._n += 1
        if self._n <= 5:
            insort(self._init, x)
            if self._n == 5:
                self._heights = list(self._init)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._desired = [
                    1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0,
                ]
            return
        h = self._heights
        pos = self._pos
        # locate the cell; extreme observations move the end markers
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (h[k] <= x < h[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._incr[i]
        # adjust the three interior markers toward their desired spots
        for i in (1, 2, 3):
            d = self._desired[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                d <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                step = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, step)
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:
                    h[i] = self._linear(i, step)
                pos[i] += step

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    @property
    def count(self) -> int:
        return self._n

    def value(self) -> float:
        """Current estimate (0.0 before the first observation; the
        exact sample quantile while fewer than five have arrived)."""
        if self._n == 0:
            return 0.0
        if self._n < 5:
            idx = min(len(self._init) - 1, int(self.q * len(self._init)))
            return self._init[idx]
        return self._heights[2]


class QuantileSet:
    """A locked bundle of P² estimators over one stream (e.g. p50 +
    p99 pod-to-bind), observable from concurrent bind threads."""

    def __init__(self, quantiles: Sequence[float] = (0.5, 0.99)) -> None:
        self._lock = threading.Lock()
        self._est: Dict[float, P2Quantile] = {
            q: P2Quantile(q) for q in quantiles
        }

    def observe(self, x: float) -> None:
        with self._lock:
            for est in self._est.values():
                est.observe(x)

    def observe_many(self, values: Sequence[float]) -> None:
        if not values:
            return
        with self._lock:
            for est in self._est.values():
                for x in values:
                    est.observe(x)

    def value(self, q: float) -> float:
        with self._lock:
            est = self._est.get(q)
            return est.value() if est is not None else 0.0

    @property
    def count(self) -> int:
        with self._lock:
            for est in self._est.values():
                return est.count
            return 0

    def reset(self) -> None:
        """Drop accumulated state (bench trials that want a fresh
        window; production never calls this)."""
        with self._lock:
            self._est = {q: P2Quantile(q) for q in self._est}

    def quantiles(self) -> Sequence[float]:
        return tuple(self._est)


def exact_quantile(values: Sequence[float], q: float) -> Optional[float]:
    """Reference implementation for tests/benches: the same index rule
    bench.py uses for its p99 (sorted, floor(n*q) clamped)."""
    if not values:
        return None
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(len(vs) * q))]
