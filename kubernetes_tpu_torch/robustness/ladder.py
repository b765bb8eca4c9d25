"""The solver degradation ladder: one device tier -> host greedy ->
sequential oracle.

Tier semantics:

- ``cuda``: the hand-written CUDA kernel (ops/greedy_kernel.py), the
  ONLY tier offered while the solver's tensors are on the card. It has
  no breaker, and a failed upload, launch or download never moves a
  batch to a CPU solver: a KernelError, a CUDA runtime error, a
  SolveTimeout and every other exception propagate at once, with no
  retry. Two faults are the batch's, not the card's, and end in
  LadderExhausted instead: a PoisonError (at once; the containment
  bisection owns it), and a FaultInjected, the simulated transient
  fault of a chaos profile, which real hardware never raises. That one
  is retried in place under RetryPolicy (counted in
  ``solve_retries{tier="cuda"}`` and ``injected_retries``); once the
  attempts are spent the ladder raises LadderExhausted with the
  FaultInjected as its cause, and the batch scheduler solves the batch
  again on the card (drain and redispatch, or containment). An injected
  hang (``device_solve_hang``) that outlasts the watchdog is such a
  fault too: the batch scheduler tells the ladder, from the hang the
  injector handed that attempt, that its SolveTimeout was injected; a
  SolveTimeout with no injected hang behind it is the card's. A K3 victim
  search so exhausted (a wave, or one pod's search on the per-pod path)
  nominates no pod: its pods are requeued on the ordinary backoff and
  the next wave solves them on K3 again (scheduler/preemption.py). Any
  other failure of that search raises CardFault, which halts the
  scheduler.
- ``torch``: the kernel's plain PyTorch version -- the device tier ONLY
  when the solver's tensors are on the CPU (tests). It is never a tier
  on the card: there the plain version serves nothing.
- ``host_greedy``: a pure-numpy replay of the unconstrained greedy scan
  (this module), offered after ``torch`` on the CPU.
- ``sequential``: the per-pod oracle path (Scheduler.attempt_schedule)
  -- the floor of the ladder, always correct, always available.

The ``torch`` and ``host_greedy`` tiers carry a CircuitBreaker: after
``failure_threshold`` consecutive failures the tier opens and subsequent
batches route straight to the next healthy tier during cool-off; a
half-open tier admits probe batches and closes again on success.
Failures also retry in place (RetryPolicy) before stepping down, and
every device attempt runs under the wall-clock Watchdog.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

import numpy as np

from kubernetes_tpu_torch.robustness.circuit import (
    CircuitBreaker,
    RetryPolicy,
    SolveTimeout,
    Watchdog,
)
from kubernetes_tpu_torch.ops.greedy_kernel import KernelError
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjected,
    FaultPoint,
    PoisonError,
)
from kubernetes_tpu_torch.utils import flightrecorder, metrics

T = TypeVar("T")

TIER_CUDA = "cuda"
TIER_TORCH = "torch"
TIER_HOST_GREEDY = "host_greedy"
TIER_SEQUENTIAL = "sequential"

#: ladder order, fastest first (a batch is offered exactly one of the two
#: device tiers, by where its tensors live)
TIERS = (TIER_CUDA, TIER_TORCH, TIER_HOST_GREEDY, TIER_SEQUENTIAL)
#: the solver's tensors live on the card: every failure but a poison pod
#: or an injected fault is terminal, so nothing steps down to a CPU solver
CARD_TIERS = (TIER_CUDA,)
#: the tiers that touch the device (watchdog-guarded)
DEVICE_TIERS = (TIER_CUDA, TIER_TORCH)


@dataclass
class RobustnessConfig:
    """Knobs for the ladder/breaker/watchdog (config/types.py wires the
    YAML form; defaults are production-shaped)."""

    #: False turns off the breakers, the watchdog, and in-place retries
    #: (each batch gets exactly one attempt per tier; a workload whose
    #: first-batch compile legitimately exceeds solveTimeout can disable
    #: instead of tuning). The exception->step-down safety net itself
    #: stays: a failed solve still completes on a lower tier.
    enabled: bool = True
    #: wall-clock deadline for one device solve dispatch+execute; 0
    #: disables the watchdog (tests that legitimately pay a first-batch
    #: JIT compile may need a generous value -- compile time counts)
    solve_timeout_seconds: float = 60.0
    failure_threshold: int = 3
    cooloff_seconds: float = 5.0
    probe_batches: int = 1
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    #: sleep fn, injectable so chaos tests run at full speed
    sleep: Callable[[float], None] = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.sleep is None:
            import time

            self.sleep = time.sleep

    @classmethod
    def from_configuration(cls, cfg) -> "RobustnessConfig":
        """From the wire-config block
        (config.types.RobustnessConfiguration)."""
        return cls(
            enabled=cfg.enabled,
            solve_timeout_seconds=cfg.solve_timeout_seconds,
            failure_threshold=cfg.failure_threshold,
            cooloff_seconds=cfg.cooloff_seconds,
            probe_batches=cfg.probe_batches,
            retry=RetryPolicy(
                max_attempts=cfg.retry_max_attempts,
                backoff_seconds=cfg.retry_backoff_seconds,
                max_backoff_seconds=cfg.retry_max_backoff_seconds,
            ),
        )


class LadderExhausted(Exception):
    """Every device/host tier failed or is open; the caller must route
    the batch to the sequential oracle."""


class CardFault(RuntimeError):
    """A fault of a device search on the card that no tier answers (K3's
    victim search raises it, with the fault as its cause). The scheduler
    that meets it halts (Scheduler._halt_on_card_fault): nothing requeues
    the work to meet the same fault again."""


class SolverLadder:
    """Owns the per-tier breakers and runs one batch's solve down the
    ladder. The BatchScheduler supplies per-tier thunks; this class
    supplies ordering, retries, watchdog, breaker routing, and the
    fallback metrics."""

    def __init__(self, config: Optional[RobustnessConfig] = None) -> None:
        self.config = config or RobustnessConfig()
        self.watchdog = Watchdog()
        self.breakers: Dict[str, CircuitBreaker] = {
            tier: CircuitBreaker(
                tier,
                failure_threshold=self.config.failure_threshold,
                cooloff_seconds=self.config.cooloff_seconds,
                probe_batches=self.config.probe_batches,
            )
            for tier in (TIER_TORCH, TIER_HOST_GREEDY)
        }
        # visibility counters (mirrored to metrics; kept as attributes so
        # tests and the perf matrix can read them without scraping)
        self.solves_by_tier: Dict[str, int] = {t: 0 for t in TIERS}
        #: in-place retries of a FaultInjected, on any tier
        self.injected_retries = 0

    def breaker(self, tier: str) -> CircuitBreaker:
        return self.breakers[tier]

    def run(
        self,
        attempts: List[Tuple[str, Callable[[], T]]],
        label: str = "batch",
        injected_hang: Optional[Callable[[], bool]] = None,
    ) -> Tuple[str, T]:
        """Try ``attempts`` -- ordered (tier, thunk) pairs -- down the
        ladder. Returns (tier, result) from the first success. Raises
        LadderExhausted when every tier fails or is skipped; the caller
        then takes the sequential path (and counts it).

        ``injected_hang``: whether the attempt that just timed out drew
        an injected hang. On a card tier such a SolveTimeout is an
        injected fault (retried in place, then LadderExhausted); every
        other SolveTimeout there raises at once."""
        last_error: Optional[BaseException] = None
        enabled = self.config.enabled
        for idx, (tier, thunk) in enumerate(attempts):
            breaker = self.breakers.get(tier) if enabled else None
            if breaker is not None and not breaker.allow():
                metrics.solver_fallbacks.inc(
                    tier=self._next_tier_name(attempts, idx),
                    reason=f"{tier}_breaker_open",
                )
                flightrecorder.mark(
                    "fallback",
                    tier=self._next_tier_name(attempts, idx),
                    reason=f"{tier}_breaker_open",
                )
                continue
            try:
                result = self._attempt_tier(tier, thunk, injected_hang)
            except Exception as e:  # noqa: BLE001 - filtered below
                if isinstance(e, KernelError) or (
                    tier in CARD_TIERS
                    and not isinstance(e, (PoisonError, FaultInjected))
                ):
                    raise  # a card or kernel fault never degrades
                    # silently to another tier
                last_error = e
                if isinstance(e, SolveTimeout):
                    reason = f"{tier}_timeout"
                    if breaker is not None:
                        # a hang must not get threshold-many more
                        # chances to wedge more watchdog threads
                        breaker.force_open()
                elif isinstance(e, PoisonError):
                    # a poison pod is a BATCH-CONTENT fault, not a tier
                    # fault: charging the breaker would open the tier
                    # and strip healthy batches of their device path as
                    # collateral damage -- the bisection containment
                    # owns the poison's disposition instead
                    reason = f"{tier}_poison"
                else:
                    reason = f"{tier}_error"
                    if breaker is not None:
                        breaker.record_failure()
                metrics.solver_fallbacks.inc(
                    tier=self._next_tier_name(attempts, idx),
                    reason=reason,
                )
                flightrecorder.mark(
                    "fallback",
                    tier=self._next_tier_name(attempts, idx),
                    reason=reason,
                )
                continue
            if breaker is not None:
                breaker.record_success()
            self.solves_by_tier[tier] = self.solves_by_tier.get(tier, 0) + 1
            return tier, result
        raise LadderExhausted(
            f"every solver tier failed for {label}"
        ) from last_error

    def record_sequential(self, count: int = 1) -> None:
        self.solves_by_tier[TIER_SEQUENTIAL] += count

    @staticmethod
    def _next_tier_name(attempts, idx) -> str:
        if idx + 1 < len(attempts):
            return attempts[idx + 1][0]
        return TIER_SEQUENTIAL

    def _attempt_tier(
        self, tier: str, thunk: Callable[[], T],
        injected_hang: Optional[Callable[[], bool]] = None,
    ) -> T:
        """One tier's attempt: watchdog around each try, in-place retries
        with exponential backoff before giving up on the tier."""
        cfg = self.config
        timeout = (
            cfg.solve_timeout_seconds
            if cfg.enabled and tier in DEVICE_TIERS
            else 0.0  # host tiers don't touch the device; no watchdog
        )
        max_attempts = cfg.retry.max_attempts if cfg.enabled else 1
        attempt = 0
        while True:
            attempt += 1
            try:
                return self.watchdog.call(thunk, timeout, tier=tier)
            except SolveTimeout as timeout_err:
                if not (
                    tier in CARD_TIERS
                    and injected_hang is not None
                    and injected_hang()
                ):
                    raise  # a hang is terminal for the tier (no retry:
                    # retrying would park another worker on a wedged
                    # link)
                # the injector hung this attempt on purpose: the card's
                # answer to an injected fault, retried in place
                injected = FaultInjected(FaultPoint.DEVICE_SOLVE_HANG)
                if attempt >= max_attempts:
                    raise injected from timeout_err
                metrics.solve_retries.inc(tier=tier)
                self.injected_retries += 1
                cfg.sleep(cfg.retry.backoff_for_attempt(attempt))
            except (PoisonError, KernelError):
                raise  # persistent (a poison pod, a kernel that cannot
                # build or launch): in-place retries only burn backoff
            except Exception as e:
                if attempt >= max_attempts or (
                    tier in CARD_TIERS and not isinstance(e, FaultInjected)
                ):
                    raise
                metrics.solve_retries.inc(tier=tier)
                if isinstance(e, FaultInjected):
                    self.injected_retries += 1
                cfg.sleep(cfg.retry.backoff_for_attempt(attempt))


# -- host-greedy tier ----------------------------------------------------

def _host_fits(free: np.ndarray, pod_req: np.ndarray) -> np.ndarray:
    """numpy mirror of ops.assignment._fits (fit.go semantics): the
    pod-count dimension is always checked; all-zero requests
    short-circuit after it; scalar/extended dims only count when
    requested. free [N, R], pod_req [R] -> [N] bool."""
    from kubernetes_tpu_torch.tensors.node_tensor import NUM_FIXED_DIMS, PODS

    cols = np.arange(pod_req.shape[0])
    dim_ok = pod_req[None, :] <= free
    scalar_skip = (cols >= NUM_FIXED_DIMS) & (pod_req == 0)
    dim_ok = dim_ok | scalar_skip[None, :]
    nonpods = cols != PODS
    if np.max(np.where(nonpods, pod_req, 0)) == 0:
        return dim_ok[:, PODS]
    return dim_ok.all(axis=-1)


def _host_score(caps, nzr_state, p_nzr, config) -> np.ndarray:
    """numpy mirror of the device resource scorers (ops/scores.py): same
    float32 arithmetic, same epsilon-floor, so the host tier's placements
    match the device tiers bit-for-bit on the score path."""
    eps = np.float32(1e-4)
    req = (nzr_state + p_nzr[None, :]).astype(np.float32)
    cap = caps.astype(np.float32)
    cap_safe = np.maximum(cap, 1.0)
    score = np.zeros(caps.shape[0], dtype=np.float32)
    if config.least_allocated_weight:
        raw = np.floor((cap - req) * 100.0 / cap_safe + eps)
        per_dim = np.where((cap == 0) | (req > cap), 0.0, raw)
        score += config.least_allocated_weight * np.floor(
            per_dim.sum(axis=-1, dtype=np.float32) / 2.0 + eps
        )
    if config.balanced_allocation_weight:
        frac = np.where(cap == 0, 1.0, req / cap_safe)
        diff = np.abs(frac[..., 0] - frac[..., 1])
        bal = np.trunc((1.0 - diff) * 100.0 + eps)
        bal = np.where((frac[..., 0] >= 1.0) | (frac[..., 1] >= 1.0), 0.0, bal)
        score += config.balanced_allocation_weight * bal.astype(np.float32)
    if config.most_allocated_weight:
        raw = np.floor(req * 100.0 / cap_safe + eps)
        per_dim = np.where((cap == 0) | (req > cap), 0.0, raw)
        score += config.most_allocated_weight * np.floor(
            per_dim.sum(axis=-1, dtype=np.float32) / 2.0 + eps
        )
    return score


def host_greedy_assign(
    allocatable: np.ndarray,  # [N, R] int32
    requested: np.ndarray,  # [N, R] int32 batch-start state
    nzr: np.ndarray,  # [N, 2] int32
    valid: np.ndarray,  # [N] bool
    pod_requests: np.ndarray,  # [B, R] int32, solve order
    pod_nzr: np.ndarray,  # [B, 2] int32
    mask_rows: np.ndarray,  # [U, N] bool deduplicated static-mask rows
    mask_index: np.ndarray,  # [B] int32
    active: np.ndarray,  # [B] bool
    config=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-host replay of the unconstrained greedy solve
    (ops/assignment._greedy_assign_impl, the kernel's plain version):
    same fit semantics, same scores, same lowest-index argmax tie-break.
    Used when the device tier is down -- no device traffic at all. Returns
    (assignments [B] int32, requested' [N, R], nzr' [N, 2]).

    The attachable-volume count columns (tensors/node_tensor.py) replay
    here for free: they are ordinary scalar dims of the ``[N, R]``
    layout, enforced by the same zero-request-skip fit rule as any
    extended resource, so a countable-volume batch degrades through this
    tier with identical placements."""
    from kubernetes_tpu_torch.ops.assignment import NO_NODE, GreedyConfig

    if config is None:
        config = GreedyConfig()
    b = pod_requests.shape[0]
    req_state = np.array(requested, dtype=np.int64).astype(np.int32)
    nzr_state = np.array(nzr, dtype=np.int32)
    caps = allocatable[:, :2]
    assignments = np.full(b, NO_NODE, dtype=np.int32)
    valid = np.asarray(valid, dtype=bool)
    for k in range(b):
        if not active[k]:
            continue
        pod_req = pod_requests[k]
        free = allocatable - req_state
        feasible = (
            _host_fits(free, pod_req)
            & mask_rows[mask_index[k]]
            & valid
        )
        if not feasible.any():
            continue
        score = _host_score(caps, nzr_state, pod_nzr[k], config)
        score = np.where(feasible, score, -np.inf)
        choice = int(np.argmax(score))
        assignments[k] = choice
        req_state[choice] += pod_req
        nzr_state[choice] += pod_nzr[k]
    return assignments, req_state, nzr_state
