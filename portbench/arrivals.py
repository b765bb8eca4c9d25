"""Arrival processes for open-loop traffic, frozen here so that a change
to the program cannot move the load the benchmark offers. No cell runs
open-loop traffic yet: the harness runs closed bursts only.

``poisson_trace`` is a copy of the program's generator of the same name
(``streaming/arrivals.poisson_trace``); a test pins the two to the same
offsets for one seed.
"""

from __future__ import annotations

from typing import List

import numpy as np


def poisson_trace(rate: float, duration: float, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` pods/s for ``duration``
    seconds: i.i.d. exponential inter-arrival gaps, cumulatively summed.
    Sorted float64 offsets in seconds from the trace's start."""
    if rate <= 0 or duration <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    t = 0.0
    # draw in slabs until the horizon is covered; the tail slab
    # overshoots and is trimmed
    while t < duration:
        n = max(64, int(rate * (duration - t) * 1.2) + 32)
        gaps = rng.exponential(1.0 / rate, size=n)
        offs = t + np.cumsum(gaps)
        out.append(offs)
        t = float(offs[-1])
    offsets = np.concatenate(out)
    return offsets[offsets < duration]

