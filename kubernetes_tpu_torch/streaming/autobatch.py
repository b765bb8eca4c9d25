"""SLO-adaptive batch controller: the feedback loop that replaces the
static ``batch_window``/``max_batch`` knobs.

The dispatcher's batching knobs trade latency for throughput: a short
window dispatches small, cheap-to-wait-for batches (every solve still
pays the fixed dispatch cost: the pack, one upload, one kernel launch
and one download), a long window fills batches toward ``max_batch`` and
amortizes that fixed cost. No static setting
serves an arrival *process* at both ends -- shallow-queue periods want
the short window, backlog wants the long one. The
``AutoBatchController`` closes the loop from the signals the dispatch
path already produces:

- queue depth (``queue.active_count``) and the pop counter
  (``queue.scheduling_cycle``) give a drain-rate estimate, so
  ``depth / rate`` estimates the backlog sojourn a pod joining now
  will see;
- the always-on per-thread stage timers split ``pop_wait``
  (dispatcher blocked on arrivals) from drain work, so a transiently
  deep queue on an otherwise-idle dispatcher doesn't trigger a grow.

Control law (deliberately simple, deterministic, and hysteretic):

- **throughput mode** when the estimated sojourn exceeds
  ``grow_fraction * slo``: double the window toward ``max_window``
  (clamped to ``slo/2`` -- the window itself must never spend the
  latency budget) and step the dispatch cap ONE RUNG up the batch-cap
  ladder (default ladder = the two poles, so this is "to max_batch";
  with ``auto_rungs`` the ladder is sized from the solve cost warmup
  measures at each rung and calibrate() prunes rungs that don't pay).
- **latency mode** when the estimated sojourn is under
  ``shrink_fraction * slo`` AND the queue is shallower than one
  latency-mode batch: halve the window toward ``min_window`` and step
  the cap one rung down toward ``latency_batch`` (a batch pads only to
  the next 64 pods, so a small batch pays a proportionally small
  solve).
- **hold** inside the hysteresis band -- on a steady trace the
  controller converges and stops moving (the oscillation guard test
  pins this).

Overload is special-cased: at sustained overload the RAW pressure
signal whipsaws -- a deep queue pins the sojourn estimate, the resulting
max-batch drain empties the window's view of the queue, the estimate
collapses, the controller shrinks, the backlog re-forms, it grows again
(10 or more window moves inside a failing rung on the scripted overload
series of the tests). Two mechanisms calm it:

- the decision signal is an **EWMA** of the pressure ratio
  (``pressure_ewma_alpha``), so one big drain can't fake a recovery;
- crossing the grow threshold ``latch_after_steps`` consecutive times
  **latches throughput mode**: shrinks are blocked until the smoothed
  pressure stays under the shrink threshold for
  ``unlatch_after_steps`` consecutive decisions. A latched controller
  parked at the throughput pole makes at most the initial grow moves
  on a sustained overload series (unit-pinned at <= 2).


``step()`` is a pure function of its arguments plus controller state:
a fixed input sequence always produces the same window/cap trajectory
(deterministic-trace convergence tests). ``maybe_step()`` is the
time-gated wrapper the dispatch loop calls once per
``interval_seconds``.
"""

from __future__ import annotations

import time
from typing import Optional

from kubernetes_tpu_torch.utils import flightrecorder, metrics

#: batch sizes quantize to this (mirrors scheduler/batch.py POD_BUCKET
#: without importing the scheduler -- the controller must stay
#: dependency-light so the queue/bench layers can use it standalone)
BATCH_BUCKET = 64


class AutoBatchController:
    def __init__(
        self,
        *,
        slo_p99_seconds: float = 1.0,
        min_window: float = 0.0,
        max_window: Optional[float] = None,
        latency_batch: int = 512,
        max_batch: int = 4096,
        interval_seconds: float = 0.25,
        grow_fraction: float = 0.5,
        shrink_fraction: float = 0.15,
        grow_floor_window: float = 0.02,
        idle_grow_guard: float = 0.5,
        pressure_ewma_alpha: float = 0.4,
        latch_after_steps: int = 2,
        unlatch_after_steps: int = 4,
        rungs: Optional[list] = None,
        auto_rungs: bool = False,
        now=time.monotonic,
    ) -> None:
        """``rungs``: explicit batch-cap ladder (ascending; endpoints
        ``latency_batch``/``max_batch`` are always included).
        ``auto_rungs``: seed a geometric candidate ladder between the
        two poles instead of the hardcoded two rungs; the scheduler's
        ``warmup()`` times one solve at every candidate's size and
        ``calibrate`` prunes rungs that don't pay."""
        if slo_p99_seconds <= 0:
            raise ValueError("slo_p99_seconds must be positive")
        self.slo = slo_p99_seconds
        self.min_window = max(0.0, min_window)
        # the window is spent INSIDE the latency budget; cap it at half
        # the SLO so batching alone can never burn the whole budget
        cap = 0.5 * slo_p99_seconds
        self.max_window = min(
            cap, max_window if max_window is not None else 0.25
        )
        self.max_window = max(self.max_window, self.min_window)
        self.max_batch = max(BATCH_BUCKET, int(max_batch))
        lb = min(int(latency_batch), self.max_batch)
        self.latency_batch = max(
            BATCH_BUCKET,
            BATCH_BUCKET * (lb // BATCH_BUCKET),
        )
        # -- the batch-cap rung ladder ------------------------------------
        self.auto_rungs = bool(auto_rungs)
        if rungs is None and self.auto_rungs:
            rungs = self.candidate_rungs(self.latency_batch, self.max_batch)
        if rungs is None:
            rungs = [self.latency_batch, self.max_batch]
        self.rungs = self._normalize_rungs(rungs)
        self.interval = interval_seconds
        self.grow_fraction = grow_fraction
        self.shrink_fraction = shrink_fraction
        self.grow_floor_window = max(grow_floor_window, 1e-4)
        self.idle_grow_guard = idle_grow_guard
        self._now = now

        # controller outputs (read by the dispatcher every batch)
        self.window = self.min_window
        self.batch_cap = self.latency_batch

        # trajectory / oscillation visibility
        self.steps = 0
        self.window_changes = 0
        self.cap_changes = 0
        self.grows = 0
        self.shrinks = 0

        self._last_t: Optional[float] = None
        self._last_cycle = 0
        self._last_pop_wait = 0.0
        self._last_step_t: Optional[float] = None

        # -- overload latch state (EWMA-smoothed pressure) ----------------
        self.pressure_ewma_alpha = min(1.0, max(0.0, pressure_ewma_alpha))
        self.latch_after_steps = max(1, int(latch_after_steps))
        self.unlatch_after_steps = max(1, int(unlatch_after_steps))
        self.pressure_ewma = 0.0
        self.latched = False
        self.latches = 0  # times the latch engaged (visibility)
        self._over_streak = 0
        self._calm_streak = 0

    # -- the batch-cap rung ladder -------------------------------------------

    @staticmethod
    def candidate_rungs(latency_batch: int, max_batch: int) -> list:
        """Geometric candidate ladder between the two poles (doubling):
        the starting point calibration prunes from."""
        out = []
        r = max(BATCH_BUCKET, int(latency_batch))
        while r < max_batch:
            out.append(r)
            r *= 2
        out.append(int(max_batch))
        return out

    def _normalize_rungs(self, rungs) -> list:
        """Bucket-quantized, clamped, deduplicated ascending ladder that
        always contains both poles."""
        norm = {self.latency_batch, self.max_batch}
        for r in rungs:
            r = int(r)
            r = max(BATCH_BUCKET, BATCH_BUCKET * (r // BATCH_BUCKET))
            # only strictly-interior rungs: quantizing a value at/past a
            # pole must not mint a near-duplicate of that pole
            if self.latency_batch < r < self.max_batch:
                norm.add(r)
        return sorted(norm)

    def calibrate(self, pad_costs: dict, keep_fraction: float = 0.8):
        """Prune the candidate ladder from MEASURED solve cost per rung
        (``BatchScheduler.warmup`` times one steady solve of each rung's
        size): a middle rung survives only when its solve costs at most
        ``keep_fraction`` of the next kept rung above -- a rung that
        isn't meaningfully cheaper buys no latency and only adds
        controller churn. The poles always survive; an unmeasured
        middle rung drops. No-op unless ``auto_rungs``. Returns the
        ladder."""
        if not self.auto_rungs or len(self.rungs) <= 2:
            return self.rungs
        kept = [self.rungs[-1]]
        for r in reversed(self.rungs[:-1]):
            if r == self.rungs[0]:
                kept.append(r)
                continue
            cost = pad_costs.get(r)
            above = pad_costs.get(kept[-1])
            if cost is None or above is None or above <= 0:
                continue
            if cost <= keep_fraction * above:
                kept.append(r)
        self.rungs = sorted(set(kept))
        if self.batch_cap not in self.rungs:
            fitting = [r for r in self.rungs if r >= self.batch_cap]
            self.batch_cap = fitting[0] if fitting else self.rungs[-1]
        return self.rungs

    def _cap_up(self) -> int:
        for r in self.rungs:
            if r > self.batch_cap:
                return r
        return self.rungs[-1]

    def _cap_down(self) -> int:
        for r in reversed(self.rungs):
            if r < self.batch_cap:
                return r
        return self.rungs[0]

    # -- the control law ----------------------------------------------------

    def step(
        self,
        depth: int,
        popped_cycle: int,
        t: float,
        pop_wait_seconds: Optional[float] = None,
    ) -> str:
        """One controller decision from (queue depth, cumulative pop
        counter, clock, cumulative pop_wait stage seconds). Returns the
        direction taken: "grow" | "shrink" | "hold". Pure in its inputs
        + controller state -- no clock or RNG reads."""
        self.steps += 1
        if self._last_t is None:
            self._last_t = t
            self._last_cycle = popped_cycle
            if pop_wait_seconds is not None:
                self._last_pop_wait = pop_wait_seconds
            return "hold"
        dt = t - self._last_t
        if dt <= 0:
            return "hold"
        rate = max(0.0, (popped_cycle - self._last_cycle) / dt)
        idle_frac = 0.0
        if pop_wait_seconds is not None:
            idle_frac = max(
                0.0, min(1.0, (pop_wait_seconds - self._last_pop_wait) / dt)
            )
            self._last_pop_wait = pop_wait_seconds
        self._last_t = t
        self._last_cycle = popped_cycle

        if rate > 0:
            wait_est = depth / rate
        else:
            # nothing drained this interval: a backlog with no drain is
            # saturation (estimate pins to the SLO, forcing a grow); an
            # empty queue with no drain is plain idle
            wait_est = self.slo if depth > 0 else 0.0
        raw_pressure = wait_est / self.slo
        # the DECISION signal is the smoothed pressure: one max-batch
        # drain that momentarily empties the queue can no longer fake a
        # recovery mid-overload (no hunting between the poles)
        a = self.pressure_ewma_alpha
        self.pressure_ewma = a * raw_pressure + (1.0 - a) * self.pressure_ewma
        pressure = self.pressure_ewma

        # latch bookkeeping: consecutive over-threshold decisions engage
        # it; consecutive calm decisions release it
        if pressure > self.grow_fraction and (
            idle_frac < self.idle_grow_guard
        ):
            # the idle-dispatcher guard applies to the latch too: depth
            # piling up while the dispatcher is blocked on arrivals is
            # not overload, and must neither grow nor latch
            self._over_streak += 1
            self._calm_streak = 0
            if (
                not self.latched
                and self._over_streak >= self.latch_after_steps
            ):
                self.latched = True
                self.latches += 1
                metrics.autobatch_latched.set(1.0)
                # sustained overload: walking the window up one
                # doubling per interval just prolongs the failing rung.
                # Jump straight to the throughput pole (top rung) and
                # hold there.
                return self._apply(
                    "grow", (self.max_window, self.rungs[-1])
                )
        elif pressure < self.shrink_fraction:
            self._calm_streak += 1
            self._over_streak = 0
            if self.latched and self._calm_streak >= self.unlatch_after_steps:
                self.latched = False
                metrics.autobatch_latched.set(0.0)
        else:
            self._over_streak = 0
            self._calm_streak = 0

        if pressure > self.grow_fraction and idle_frac < self.idle_grow_guard:
            return self._apply("grow", self._grown())
        if (
            pressure < self.shrink_fraction
            and depth <= self.latency_batch
            and not self.latched
        ):
            return self._apply("shrink", self._shrunk())
        return "hold"

    def _grown(self):
        window = min(
            self.max_window, max(self.grow_floor_window, self.window * 2.0)
        )
        return window, self._cap_up()

    def _shrunk(self):
        if self.window <= self.grow_floor_window:
            window = self.min_window
        else:
            window = max(self.min_window, self.window / 2.0)
        return window, self._cap_down()

    def _apply(self, direction: str, target) -> str:
        window, cap = target
        changed = False
        if window != self.window:
            self.window = window
            self.window_changes += 1
            changed = True
        if cap != self.batch_cap:
            self.batch_cap = cap
            self.cap_changes += 1
            changed = True
        if not changed:
            # already pinned at the pole: not a decision, not a change
            return "hold"
        if direction == "grow":
            self.grows += 1
        else:
            self.shrinks += 1
        metrics.autobatch_decisions.inc(direction=direction)
        metrics.autobatch_window.set(self.window)
        metrics.autobatch_batch_cap.set(float(self.batch_cap))
        flightrecorder.mark(
            "autobatch", direction=direction,
            window_ms=round(self.window * 1000.0, 3),
            cap=self.batch_cap,
        )
        # --trace timelines show controller moves as instant events on
        # their own track, between the stage spans they retune
        flightrecorder.trace_instant(
            f"autobatch_{direction}",
            args={"window_ms": round(self.window * 1000.0, 3),
                  "cap": self.batch_cap},
            track="autobatch",
        )
        return direction

    # -- dispatcher-facing wrapper -------------------------------------------

    def maybe_step(self, sched) -> Optional[str]:
        """Time-gated poll from the dispatch loop: at most one decision
        per ``interval_seconds``, reading the live queue + stage-timer
        signals and pushing the outputs onto the scheduler
        (``batch_window``, ``dispatch_batch_cap``)."""
        t = self._now()
        if (
            self._last_step_t is not None
            and t - self._last_step_t < self.interval
        ):
            return None
        self._last_step_t = t
        direction = self.step(
            sched.queue.active_count(),
            sched.queue.scheduling_cycle,
            t,
            sched.stage_seconds.get("pop_wait", 0.0),
        )
        sched.batch_window = self.window
        sched.dispatch_batch_cap = self.batch_cap
        return direction
