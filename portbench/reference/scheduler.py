"""A frozen, plain NumPy scheduler: the semantics the cells are judged by.

It places pods one at a time, in queue order (priority, then arrival),
on a cluster it builds from the benchmark's own inputs, exactly as the
reference kube-scheduler's default profile decides for the pods the
cells send:

* Filter: NodeResourcesFit (fit.go:181-252: the pod-count dimension
  always; every fixed dimension unless the pod requests nothing but a
  pod slot) and PodTopologySpread with ``DoNotSchedule``
  (filtering.go:322: the count of selector-matching pods in the node's
  domain, plus one when the pod matches its own selector, less the
  smallest count over the cluster's domains, at most ``maxSkew``).
* Score: NodeResourcesLeastAllocated plus NodeResourcesBalancedAllocation
  at weight 1 each, over the non-zero requests (util/non_zero.go). Every
  other default score plugin gives every node the same integer for
  these pods, so it cannot move the ranking and is left out.
* The lowest node row wins a tie. Rows are the order in which the nodes
  were created.

The scores are float32, every operation rounded on its own (no fused
multiply-add), with the +1e-4 guard before each floor: the rounding the
port computes in, which has to give upstream's integer scores.
``Arithmetic`` names the rounding; ``BF16`` rounds each operation to
bfloat16 instead.

This module imports nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

F32 = np.float32
_HUNDRED = F32(100.0)
_EPS = F32(1e-4)
_ONE = F32(1.0)
_TWO = F32(2.0)
_ZERO = F32(0.0)

#: columns of a resource vector: milliCPU, memory KiB, ephemeral KiB, pods
CPU, MEM, EPH, PODS = range(4)
#: util/non_zero.go: a pod that requests no CPU or memory still counts
#: 100m and 200Mi towards the scores
DEFAULT_NZ_CPU = 100
DEFAULT_NZ_MEM_KIB = 200 * 1024


def _to_bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), kept in
    float32 storage."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


@dataclass(frozen=True)
class Arithmetic:
    """The precision of the score arithmetic: ``round`` is applied to the
    result of every floating-point operation."""

    name: str
    round: Callable[[np.ndarray], np.ndarray]


FLOAT32 = Arithmetic("float32", lambda x: np.asarray(x, dtype=np.float32))
BF16 = Arithmetic("bfloat16", _to_bf16)


def resource_scores(cap: np.ndarray, nzr_after: np.ndarray,
                    ar: Arithmetic = FLOAT32) -> np.ndarray:
    """LeastAllocated + BalancedAllocation for nodes of capacity ``cap``
    [n, 2] (milliCPU, memory KiB) holding ``nzr_after`` [n, 2] non-zero
    requests once the pod is placed. float32 [n]."""
    q = ar.round
    capf = q(cap.astype(np.float64))
    reqf = q(nzr_after.astype(np.float64))
    safe = np.maximum(capf, _ONE)
    # least_allocated.go: ((cap - req) * 100 / cap) per dimension, floored,
    # then the floored mean of the two
    raw = np.floor(q(q(q(q(capf - reqf) * _HUNDRED) / safe) + _EPS))
    per_dim = np.where((capf == 0) | (reqf > capf), _ZERO, raw)
    least = np.floor(q(q(q(per_dim[:, 0] + per_dim[:, 1]) / _TWO) + _EPS))
    # balanced_allocation.go: 100 * (1 - |cpuFraction - memFraction|)
    frac = np.where(capf == 0, _ONE, q(reqf / safe))
    diff = np.abs(q(frac[:, 0] - frac[:, 1]))
    bal = np.trunc(q(q(q(_ONE - diff) * _HUNDRED) + _EPS))
    bal = np.where((frac[:, 0] >= _ONE) | (frac[:, 1] >= _ONE), _ZERO, bal)
    return q(least.astype(np.float32) + bal.astype(np.float32))


def _least_dim_f32(cap, req):
    if cap == 0 or req > cap:
        return _ZERO
    return np.floor((cap - req) * _HUNDRED / max(cap, _ONE) + _EPS)


def _score_one_f32(cap_cpu: int, cap_mem: int, req_cpu: int,
                   req_mem: int) -> np.float32:
    """``resource_scores`` in float32 for one node, on numpy float32
    scalars (each operation rounds to float32, as the array form does)."""
    cc, cm, rc, rm = F32(cap_cpu), F32(cap_mem), F32(req_cpu), F32(req_mem)
    least = np.floor(
        (_least_dim_f32(cc, rc) + _least_dim_f32(cm, rm)) / _TWO + _EPS)
    fc = _ONE if cc == 0 else rc / max(cc, _ONE)
    fm = _ONE if cm == 0 else rm / max(cm, _ONE)
    if fc >= _ONE or fm >= _ONE:
        bal = _ZERO
    else:
        bal = np.trunc((_ONE - abs(fc - fm)) * _HUNDRED + _EPS)
    return F32(least) + F32(bal)


def _fits_one(alloc: List[int], used: List[int], req: Tuple[int, ...]) -> bool:
    """``Cluster._fits`` for one node, on Python ints."""
    if req[CPU] == 0 and req[MEM] == 0 and req[EPH] == 0:
        return req[PODS] <= alloc[PODS] - used[PODS]
    return all(r <= a - u for r, a, u in zip(req, alloc, used))


@dataclass(frozen=True)
class Spread:
    """One DoNotSchedule topology spread constraint."""

    max_skew: int
    topology_key: str
    match_labels: Tuple[Tuple[str, str], ...]

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.match_labels)


@dataclass(frozen=True)
class PodSpec:
    """What the reference reads of a pod: its requests in the columns
    above (pods column 1), its labels and its spread constraints."""

    req: Tuple[int, int, int, int]
    labels: Tuple[Tuple[str, str], ...] = ()
    spread: Tuple[Spread, ...] = ()

    @property
    def nzr(self) -> Tuple[int, int]:
        cpu, mem = self.req[CPU], self.req[MEM]
        return (cpu or DEFAULT_NZ_CPU, mem or DEFAULT_NZ_MEM_KIB)

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


@dataclass
class _ShapeCache:
    """Per pod shape: the fit and the score of every node, and the score
    with -inf where the pod does not fit. Refreshed row by row."""

    fits: np.ndarray
    masked: np.ndarray


@dataclass
class Cluster:
    """Nodes in row order: ``alloc`` [n, 4] and, per topology key, each
    node's domain value (an index; -1 where the node lacks the key)."""

    alloc: np.ndarray
    domains: Dict[str, np.ndarray]
    arithmetic: Arithmetic = FLOAT32
    req: np.ndarray = field(init=False)
    nzr: np.ndarray = field(init=False)
    _cache: Dict[Tuple, _ShapeCache] = field(init=False, default_factory=dict)
    _placed: List[Tuple[int, PodSpec]] = field(init=False, default_factory=list)
    _spread_counts: Dict[Spread, np.ndarray] = field(
        init=False, default_factory=dict
    )

    def __post_init__(self):
        self.alloc = np.asarray(self.alloc, dtype=np.int64)
        n = self.alloc.shape[0]
        self.req = np.zeros((n, 4), dtype=np.int64)
        self.nzr = np.zeros((n, 2), dtype=np.int64)
        # the domain indices some node holds, per topology key
        self._present = {k: np.unique(v[v >= 0])
                         for k, v in self.domains.items()}

    # -- the per-node terms --------------------------------------------

    def _fits(self, rows, req: Tuple[int, ...]) -> np.ndarray:
        free = self.alloc[rows] - self.req[rows]
        r = np.asarray(req, dtype=np.int64)
        ok = r[None, :] <= free
        if r[CPU] == 0 and r[MEM] == 0 and r[EPH] == 0:
            return ok[:, PODS]
        return ok.all(axis=1)

    def _scores(self, rows, nzr: Tuple[int, int]) -> np.ndarray:
        after = self.nzr[rows] + np.asarray(nzr, dtype=np.int64)[None, :]
        return resource_scores(self.alloc[rows, :2], after, self.arithmetic)

    def _shape(self, pod: PodSpec) -> _ShapeCache:
        key = (pod.req, pod.nzr)
        c = self._cache.get(key)
        if c is None:
            rows = slice(None)
            fits = self._fits(rows, pod.req)
            score = self._scores(rows, pod.nzr)
            c = _ShapeCache(fits, np.where(fits, score, -np.inf))
            self._cache[key] = c
        return c

    def _refresh(self, row: int) -> None:
        """Bring every cached shape's entry for ``row`` up to date."""
        rows = np.array([row])
        alloc = self.alloc[row].tolist()
        used = self.req[row].tolist()
        nzr = self.nzr[row].tolist()
        for (req, pod_nzr), c in self._cache.items():
            fit = _fits_one(alloc, used, req)
            c.fits[row] = fit
            if not fit:
                c.masked[row] = -np.inf
            elif self.arithmetic is FLOAT32:
                c.masked[row] = _score_one_f32(
                    alloc[CPU], alloc[MEM],
                    nzr[0] + pod_nzr[0], nzr[1] + pod_nzr[1])
            else:
                c.masked[row] = self._scores(rows, pod_nzr)[0]

    # -- topology spread -------------------------------------------------

    def _domain_counts(self, sp: Spread) -> Tuple[np.ndarray, np.ndarray]:
        """(count per domain of placed pods matching the selector, the
        domain index of every node)."""
        dom = self.domains[sp.topology_key]
        counts = self._spread_counts.get(sp)
        if counts is None:
            counts = np.zeros(int(dom.max()) + 1 if dom.size else 0, np.int64)
            for row, pod in self._placed:
                if dom[row] >= 0 and sp.matches(pod.label_dict):
                    counts[dom[row]] += 1
            self._spread_counts[sp] = counts
        return counts, dom

    # -- placing ---------------------------------------------------------

    def feasible_scores(self, pod: PodSpec) -> np.ndarray:
        """Each node's score for ``pod``, -inf where a filter rejects it."""
        masked = self._shape(pod).masked
        if not pod.spread:
            return masked
        masked = masked.copy()
        labels = pod.label_dict
        for sp in pod.spread:
            counts, dom = self._domain_counts(sp)
            present = counts[self._present[sp.topology_key]]
            lowest = present.min() if present.size else 0
            self_match = 1 if sp.matches(labels) else 0
            node_count = np.where(dom >= 0, counts[np.maximum(dom, 0)], 0)
            ok = (dom >= 0) & (node_count + self_match - lowest <= sp.max_skew)
            masked[~ok] = -np.inf
        return masked

    def place(self, pod: PodSpec) -> int:
        """Schedule one pod: the first row of the highest score among the
        feasible nodes, or -1. The cluster takes the pod in."""
        masked = self.feasible_scores(pod)
        row = int(np.argmax(masked))
        if not np.isfinite(masked[row]):
            return -1
        self.add(row, pod)
        return row

    def add(self, row: int, pod: PodSpec) -> None:
        """Take in a pod placed on ``row``."""
        self.req[row] += pod.req
        self.nzr[row] += pod.nzr
        self._placed.append((row, pod))
        labels = pod.label_dict
        for sp, counts in self._spread_counts.items():
            dom = self.domains[sp.topology_key][row]
            if dom >= 0 and sp.matches(labels):
                counts[dom] += 1
        self._refresh(row)

    def copy(self) -> "Cluster":
        """An independent cluster in the same state."""
        other = Cluster(self.alloc.copy(), self.domains, self.arithmetic)
        other.req = self.req.copy()
        other.nzr = self.nzr.copy()
        other._placed = list(self._placed)
        other._cache = {
            k: _ShapeCache(c.fits.copy(), c.masked.copy())
            for k, c in self._cache.items()
        }
        other._spread_counts = {
            k: v.copy() for k, v in self._spread_counts.items()
        }
        return other

    def place_all(self, pods: Sequence[PodSpec]) -> List[int]:
        return [self.place(p) for p in pods]


def zone_domains(values: Sequence[Optional[str]]) -> np.ndarray:
    """Domain indices for one topology key from each row's label value
    (None: the node lacks the key)."""
    names = sorted({v for v in values if v is not None})
    index = {v: i for i, v in enumerate(names)}
    return np.array(
        [index[v] if v is not None else -1 for v in values], dtype=np.int64
    )
