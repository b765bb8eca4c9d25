"""Circuit breaker + retry/backoff + wall-clock watchdog for device
solves.

The breaker state machine is the classic one (closed -> open on N
consecutive failures; open -> half-open after a cool-off; half-open
admits a bounded number of probe batches and closes on success, reopens
on failure). One breaker per solver tier (ladder.py), so a sick Pallas
kernel routes subsequent batches straight to the XLA scan during
cool-off instead of paying the failure per batch.

The watchdog bounds a device solve's wall clock: JAX dispatch can block
for minutes inside a pathological compile (the bench history's compile
blowups trip the serving link's dead-man timer), and a wedged serving
link blocks the result download forever. The guarded call runs on a
worker thread; on timeout the caller gets SolveTimeout and steps down
the ladder. The abandoned thread is left to finish/die on its own (a
wedged device call is not interruptible from Python) -- the breaker
keeps subsequent batches off the wedged tier.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

from kubernetes_tpu_torch.utils import flightrecorder, metrics

T = TypeVar("T")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpen(Exception):
    """The tier's breaker is open; the caller must use the next tier."""

    def __init__(self, tier: str, remaining: float) -> None:
        super().__init__(
            f"circuit for {tier!r} is open ({remaining:.2f}s cool-off left)"
        )
        self.tier = tier
        self.remaining = remaining


class SolveTimeout(Exception):
    """A watchdogged call exceeded its wall-clock deadline."""

    def __init__(self, tier: str, deadline: float) -> None:
        super().__init__(
            f"solve on tier {tier!r} exceeded its {deadline:.2f}s deadline"
        )
        self.tier = tier
        self.deadline = deadline


class CircuitBreaker:
    """Per-tier breaker. Thread-safe; time injectable for tests."""

    def __init__(
        self,
        tier: str,
        failure_threshold: int = 3,
        cooloff_seconds: float = 5.0,
        probe_batches: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.tier = tier
        self.failure_threshold = max(1, failure_threshold)
        self.cooloff_seconds = cooloff_seconds
        self.probe_batches = max(1, probe_batches)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_successes = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_locked(self, to_state: str) -> None:
        if to_state == self._state:
            return
        metrics.breaker_transitions.inc(
            tier=self.tier, from_state=self._state, to_state=to_state
        )
        flightrecorder.mark(
            "breaker", tier=self.tier, from_state=self._state,
            to_state=to_state,
        )
        self._state = to_state
        if to_state == OPEN:
            self._opened_at = self._clock()
            self._probes_in_flight = 0
            self._probe_successes = 0
        elif to_state == CLOSED:
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            self._probe_successes = 0

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.cooloff_seconds
        ):
            self._transition_locked(HALF_OPEN)

    def allow(self) -> bool:
        """May a batch be attempted on this tier right now? A half-open
        breaker admits up to ``probe_batches`` concurrent probes."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_in_flight >= self.probe_batches:
                return False
            self._probes_in_flight += 1
            return True

    def check(self) -> None:
        """allow() or raise BreakerOpen."""
        if not self.allow():
            with self._lock:
                remaining = max(
                    0.0,
                    self.cooloff_seconds - (self._clock() - self._opened_at),
                )
            raise BreakerOpen(self.tier, remaining)

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._probe_successes += 1
                if self._probe_successes >= self.probe_batches:
                    self._transition_locked(CLOSED)
            else:
                self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # a failed probe reopens immediately (restarts cool-off)
                self._transition_locked(OPEN)
                return
            self._consecutive_failures += 1
            if (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._transition_locked(OPEN)

    def force_open(self) -> None:
        """A hang is worse than an error: a wedged tier must not get
        threshold-many more chances to wedge more watchdog threads."""
        with self._lock:
            self._transition_locked(OPEN)


@dataclass(frozen=True)
class RetryPolicy:
    """Retry-with-exponential-backoff for transient failures (device
    solve, bind transaction). ``sleep`` is injectable so chaos tests can
    run at full speed."""

    max_attempts: int = 2
    backoff_seconds: float = 0.05
    backoff_multiplier: float = 2.0
    max_backoff_seconds: float = 1.0

    def backoff_for_attempt(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return min(
            self.backoff_seconds * (self.backoff_multiplier ** (attempt - 1)),
            self.max_backoff_seconds,
        )


class Watchdog:
    """Run a callable with a wall-clock deadline on a worker thread.

    Each guarded call spawns one short-lived daemon thread (a deliberate
    choice over a reusable pool: a wedged call permanently occupies a
    pool worker, and with a bounded pool a hang storm would deadlock new
    submissions behind wedged workers; the ~50us spawn cost amortizes
    over a whole batch solve). A timed-out call abandons its thread --
    it runs to completion and its late result is dropped. Abandoned
    threads are counted against ``max_workers`` so a hang storm cannot
    leak unboundedly: past the cap, calls run UNGUARDED on the caller's
    thread (the breaker, forced open by the first hang, is what actually
    protects the pipeline by then).
    """

    def __init__(self, max_workers: int = 4) -> None:
        self.max_workers = max_workers
        self._lock = threading.Lock()
        self._abandoned = 0

    @property
    def abandoned_threads(self) -> int:
        with self._lock:
            return self._abandoned

    def call(
        self,
        fn: Callable[[], T],
        timeout: Optional[float],
        tier: str = "device",
    ) -> T:
        """Run ``fn`` with a deadline. Raises SolveTimeout on overrun,
        re-raises fn's own exception otherwise. timeout None/<=0 runs
        unguarded."""
        if not timeout or timeout <= 0:
            return fn()
        with self._lock:
            if self._abandoned >= self.max_workers:
                # every worker slot is wedged; don't leak more threads
                run_unguarded = True
            else:
                run_unguarded = False
        if run_unguarded:
            return fn()

        result: list = []
        error: list = []
        done = threading.Event()

        def run() -> None:
            try:
                result.append(fn())
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                error.append(e)
            finally:
                done.set()

        t = threading.Thread(target=run, name=f"watchdog-{tier}", daemon=True)
        t.start()
        if not done.wait(timeout):
            with self._lock:
                self._abandoned += 1

            # when the wedged call eventually finishes, free its slot
            def reap() -> None:
                t.join()
                with self._lock:
                    self._abandoned = max(0, self._abandoned - 1)

            threading.Thread(
                target=reap, name=f"watchdog-reaper-{tier}", daemon=True
            ).start()
            raise SolveTimeout(tier, timeout)
        if error:
            raise error[0]
        return result[0]
