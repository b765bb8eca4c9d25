"""Robustness subsystem: fault injection + solver degradation ladder.

The scheduler's availability contract (Borg/Omega, PAPERS.md): placement
quality may degrade, the control loop never stops. This package provides

- ``faults``: a deterministic, seedable fault-injection harness with
  named injection points wired through the device scheduling path
  (device solve raises / hangs / returns garbage, bind conflicts, watch
  stream drops). Off by default; production pays ~zero overhead.
- ``circuit``: per-solver-tier circuit breakers (closed -> open ->
  half-open with probe batches), retry-with-exponential-backoff, and a
  wall-clock watchdog for device solves.
- ``ladder``: the degradation ladder CUDA kernel (or, on the CPU, its
  plain PyTorch version) -> host greedy -> sequential oracle, with the
  host-greedy numpy solver.
- ``containment``: blast-radius containment -- poison-pod bisection
  policy + the quarantine ledger (escalating holds, bounded strikes,
  typed ``PodQuarantined`` parking).

Integration points: scheduler/batch.py (solve path + bisection +
carry audit), scheduler/scheduler.py (bind retry, sequential poison
seam), client/informer.py (relist on watch error), scheduler/
resilience.py (the carry-audit sweep).
"""

from kubernetes_tpu_torch.robustness.containment import (
    ContainmentConfig,
    QuarantineManager,
)
from kubernetes_tpu_torch.robustness.circuit import (
    BreakerOpen,
    CircuitBreaker,
    RetryPolicy,
    SolveTimeout,
    Watchdog,
)
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjected,
    FaultInjector,
    FaultPoint,
    get_injector,
    install_injector,
)
from kubernetes_tpu_torch.robustness.ladder import (
    RobustnessConfig,
    SolverLadder,
    TIER_HOST_GREEDY,
    TIER_CUDA,
    TIER_SEQUENTIAL,
    TIER_TORCH,
    host_greedy_assign,
)

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "ContainmentConfig",
    "FaultInjected",
    "FaultInjector",
    "FaultPoint",
    "QuarantineManager",
    "RetryPolicy",
    "RobustnessConfig",
    "SolveTimeout",
    "SolverLadder",
    "TIER_HOST_GREEDY",
    "TIER_CUDA",
    "TIER_SEQUENTIAL",
    "TIER_TORCH",
    "Watchdog",
    "get_injector",
    "host_greedy_assign",
    "install_injector",
]
