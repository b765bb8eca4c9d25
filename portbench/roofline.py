"""The card's peaks and the operations and bytes K1 and K2 need, frozen
here so that a change to the program cannot move the yardstick.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates, at its full
power limit of 700 W: 67 TFLOP/s float32 outside the tensor cores, with
a fused multiply-add counted as two operations, and 3.35 TB/s of HBM3.
The solves' arithmetic cannot fuse (their bit parity with the reference
rounds every product and sum on its own), so each of their operations
takes one float32 issue slot and the card's rate for them is half the
figure: 33.5e12 operations a second. A card whose power limit is set
lower runs slower than this bound; the harness records the limit beside
every share.

The counts are copied from the per-kernel checks that came with the
kernels (``fit_ops``, ``score_ops``, ``kernel_bytes``, ``k2_pair_ops``
and ``k2_operations``). A launch's least time is the larger of its
operations over the operation rate and its bytes over the bandwidth.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_UNFUSED_OPS_PER_S = PEAK_FP32_FLOPS / 2
PEAK_BYTES_PER_S = 3.35e12
PODS_COL = 3
FIXED_DIMS = 4


def fit_ops(r: int) -> int:
    """Operations of the fit test for one (pod, node) pair: per fixed
    dim a subtract, a compare and an AND; per scalar dim also the
    zero-request compare and its OR; then the all-zero select."""
    return 3 * min(r, 4) + 5 * max(r - 4, 0) + 1


def score_ops(least: int, balanced: int, most: int) -> int:
    """Operations that score one feasible (pod, node) pair, each division
    as ONE operation:
      common   2 int adds, 4 int->float casts, 2 max, 4 compares, 2 ORs: 14
      least    per dim sub, mul, div, add, floor, select (12); half-sum
               add, div, add, floor (4); weight mul and add (2): 18
      balanced 2 compares, 2 divs, 2 selects; sub, abs, sub, mul, add,
               trunc; 2 compares, OR, select; weight mul and add: 18
      most     as least: 18
      argmax   compare and keep: 2"""
    return 14 + 2 + 18 * (bool(least) + bool(balanced) + bool(most))


def kernel_bytes(n: int, b: int, r: int, u: int) -> int:
    """K1's bytes: each input read once, each output written once."""
    inputs = 4 * (2 * n * r + 2 * n + b * r + 2 * b + b) + n + u * n + b
    outputs = 4 * (b + n * r + 2 * n)
    return inputs + outputs


def k2_pair_ops(r: int, least: int, balanced: int, most: int) -> Dict[str, int]:
    """K2's operations per (pod, node) pair, each division as ONE:
      fit       K1's fit test, per pair fit-tested;
      spread    per live slot: key compare, clamp (2), add self, sub min,
                compare, AND: 7, per pair that fits;
      affinity  per live row: key compare, value compare, clamp (2), count
                compare, AND: 6, per pair that fits;
      scoring   per feasible pair: K1's resource score; direct add 1;
                NodeAffinity 8; TaintToleration 9; SelectorSpread 19; soft
                spread 3 per slot and 9; preferred affinity 6 per row
                and 10."""
    return dict(
        fit=fit_ops(r), spread_slot=7, affinity_row=6,
        score=score_ops(least, balanced, most) + 1 + 8 + 9,
        sel=19, soft_slot=3, soft=9, ipa_row=6, ipa=10,
    )


def least_seconds(ops: float, n_bytes: float) -> Tuple[float, str]:
    """The least time the card needs, and which bound sets it."""
    t_ops = ops / PEAK_UNFUSED_OPS_PER_S
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class _FitTracker:
    """Exact pair counts of a greedy batch: for each (mask row, request)
    the nodes a pod of that request fits and its mask row admits, kept
    current as the batch's own placements fill nodes."""

    def __init__(self, alloc, requested, valid, mask_rows):
        self.alloc = alloc.astype(np.int64)
        self.req = requested.astype(np.int64).copy()
        self.r = self.alloc.shape[1]
        self.admitted = valid[None, :].astype(bool) & mask_rows.astype(bool)
        self.admitted_count = self.admitted.sum(axis=1)
        self.scalar = np.arange(self.r) >= FIXED_DIMS
        self.others = np.arange(self.r) != PODS_COL
        self.combos: Dict[Tuple[int, bytes], list] = {}

    def _fits(self, s: np.ndarray, rows) -> np.ndarray:
        ok = s[None, :] <= self.alloc[rows] - self.req[rows]
        ok[:, self.scalar & (s == 0)] = True
        if not (s[self.others] > 0).any():
            return ok[:, PODS_COL]
        return ok.all(axis=1)

    def fit_vector(self, m: int, s: np.ndarray) -> list:
        key = (m, s.tobytes())
        c = self.combos.get(key)
        if c is None:
            f = self._fits(s, slice(None)) & self.admitted[m]
            c = [int(f.sum()), f, s.copy(), m]
            self.combos[key] = c
        return c

    def place(self, node: int, s: np.ndarray) -> None:
        self.req[node] += s
        for c in self.combos.values():
            new = bool(self._fits(c[2], [node])[0]) and bool(
                self.admitted[c[3], node])
            if new != bool(c[1][node]):
                c[0] += 1 if new else -1
                c[1][node] = new


def k1_launch(alloc, requested, valid, pod_requests, mask_rows, mask_index,
              active, asg, weights=(1, 1, 0)) -> Dict[str, float]:
    """One K1 launch's operations, bytes and least time, from its operands
    and its answer (host arrays)."""
    n, r = alloc.shape
    b = pod_requests.shape[0]
    u = mask_rows.shape[0]
    midx = np.clip(mask_index.astype(np.int64), 0, max(u - 1, 0))
    reqs = pod_requests.astype(np.int64)
    tr = _FitTracker(alloc, requested, valid, mask_rows)
    tested = scored = 0
    for t in np.flatnonzero(active):
        m = int(midx[t])
        tested += int(tr.admitted_count[m])
        scored += tr.fit_vector(m, reqs[t])[0]
        if asg[t] >= 0:
            tr.place(int(asg[t]), reqs[t])
    ops = tested * fit_ops(r) + scored * score_ops(*weights)
    n_bytes = kernel_bytes(n, b, r, u)
    least, by = least_seconds(ops, n_bytes)
    return dict(ops=ops, bytes=n_bytes, least_s=least, bound_by=by,
                pairs_tested=tested, pairs_scored=scored)


def _live(a) -> int:
    return int(np.count_nonzero(np.asarray(a) >= 0))


def k2_launch(common: Sequence[np.ndarray], spread: Sequence[np.ndarray],
              affinity: Sequence[np.ndarray], scoring: Sequence[np.ndarray],
              asg: np.ndarray, weights=(1, 1, 0),
              family_bytes: Optional[int] = None) -> Optional[Dict[str, float]]:
    """One K2 launch's operations, bytes and least time from its operands
    and its answer (host arrays), as ``k2_operations`` counts them. The
    pairs that pass the spread filter are replayed here; a batch with a
    live required-affinity row is not replayed, and gives None. Of
    ``affinity`` and ``scoring`` only rows 3, 8, 12 and 7, 11, 13 are
    read; ``family_bytes`` gives the three families' bytes where the
    others are not at hand."""
    alloc, requested, _, valid, pod_requests, _, mask_rows, mask_index, active = common
    (sp_counts, sp_vvalid, sp_nv, sp_groups, sp_skew, sp_self, sp_match) = spread
    af_rows = (affinity[3], affinity[8])
    if any(_live(a) for a in af_rows) or int(np.asarray(affinity[12]).sum()):
        return None
    n, r = alloc.shape
    u = mask_rows.shape[0]
    midx = np.clip(mask_index.astype(np.int64), 0, max(u - 1, 0))
    reqs = pod_requests.astype(np.int64)
    ops_pp = k2_pair_ops(r, *weights)
    ipa_rows = int((np.asarray(scoring[13]) >= 0).any(axis=1).sum())
    counts = sp_counts.astype(np.int64).copy()
    big = np.iinfo(np.int64).max
    g_sp = counts.shape[0]
    tr = _FitTracker(alloc, requested, valid, mask_rows)
    total = 0
    pairs = dict(tested=0, fit=0, feasible=0)
    for t in np.flatnonzero(active):
        m = int(midx[t])
        tested = int(tr.admitted_count[m])
        fit_n, fit_vec = tr.fit_vector(m, reqs[t])[:2]
        feasible = fit_vec.copy()
        slots = [c for c in range(sp_groups.shape[1]) if sp_groups[t, c] >= 0]
        for c in slots:
            g = int(min(max(sp_groups[t, c], 0), g_sp - 1))
            min_v = np.where(sp_vvalid[g], counts[g], big).min()
            vals = sp_nv[g]
            node_count = counts[g][np.clip(vals, 0, counts.shape[1] - 1)]
            ok = (vals >= 0) & (
                node_count + int(sp_self[t, c]) - min_v <= int(sp_skew[t, c]))
            feasible &= ok
        feas_n = int(feasible.sum())
        n_soft = _live(scoring[11][t])
        sel = scoring[7][t] >= 0
        per_feasible = (
            ops_pp["score"] + (ops_pp["sel"] if sel else 0)
            + (ops_pp["soft"] + ops_pp["soft_slot"] * n_soft if n_soft else 0)
            + (ops_pp["ipa"] + ops_pp["ipa_row"] * ipa_rows if ipa_rows else 0)
        )
        total += (
            tested * ops_pp["fit"]
            + fit_n * ops_pp["spread_slot"] * len(slots)
            + feas_n * per_feasible
            + 2 * len(slots) * counts.shape[1]
        )
        pairs["tested"] += tested
        pairs["fit"] += fit_n
        pairs["feasible"] += feas_n
        a = int(asg[t])
        if a >= 0:
            tr.place(a, reqs[t])
            vals_at = sp_nv[:, a]
            bump = (sp_match[t] > 0) & (vals_at >= 0)
            counts[np.flatnonzero(bump), vals_at[bump]] += 1
    outputs = asg.size * 4 + 4 * (alloc.size + 2 * n)
    if family_bytes is None:
        family_bytes = sum(np.asarray(a).nbytes
                           for f in (spread, affinity, scoring) for a in f)
    n_bytes = int(sum(np.asarray(a).nbytes for a in common)
                  + family_bytes + outputs)
    least, by = least_seconds(total, n_bytes)
    return dict(ops=total, bytes=n_bytes, least_s=least, bound_by=by,
                pairs_tested=pairs["tested"], pairs_fit=pairs["fit"],
                pairs_feasible=pairs["feasible"])
