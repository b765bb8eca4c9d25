"""Blast-radius containment: poison-pod quarantine ledger + bisection
policy knobs.

Batched solving inverts the failure economics of the reference's
scheduleOne: one malformed pod no longer fails alone -- it drags the
whole ``[B]``-wide dispatch down the solver ladder on every retry. The
containment plane keeps the blast radius per-pod again:

- **Bisection** (scheduler/batch.py ``_bisect_batch``): when a batch
  exhausts the solver ladder, the batch is split O(log B)-wise on the
  already-warm pad rungs; healthy halves commit at their normal device
  tier and only the isolated offender(s) reach the quarantine ledger.
- **Quarantine** (this module + queue/scheduling_queue.py): isolated
  pods take escalating out-of-queue holds with a bounded strike budget;
  on exhaustion they PARK with a typed ``PodQuarantined`` condition
  written to the apiserver -- visible, never silently dropped, never
  redispatched into another batch.

The manager is deliberately dumb about WHY a pod was isolated: the
bisection (or the ladder-exhausted crash-loop detector) supplies the
reason string; this module owns only the strike ledger, the hold
schedule, and the park/condition bookkeeping.
"""

from __future__ import annotations

import collections
import logging
import threading
from dataclasses import dataclass
from typing import Dict, Optional
from zlib import crc32

from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)

#: the typed condition parked pods carry on the apiserver
QUARANTINE_CONDITION = "PodQuarantined"

#: strike ledger bound: entries beyond this evict oldest-first (a pod
#: that bound long ago and never misbehaved again must not pin memory
#: forever)
_STRIKE_LEDGER_CAP = 4096


def spec_identity(pod) -> str:
    """The strike-ledger key: pod identity + a digest of its spec.

    Keyed by uid, a controller that deletes and respawns its poison pod
    (same spec, fresh uid) resets the strike budget every incarnation
    and the quarantine never converges to a park. Keying by
    namespace/name + spec digest makes the ledger survive respawns --
    the replacement inherits its predecessor's strikes -- while a REAL
    spec edit (the operator actually fixed the pod) changes the digest
    and legitimately starts a fresh budget. The spec is a dataclass
    tree, so ``repr`` is a deterministic canonical form of the declared
    fields (runtime memo attributes never appear in it)."""
    digest = crc32(repr(pod.spec).encode()) & 0xFFFFFFFF
    return (
        f"{pod.metadata.namespace}/{pod.metadata.name}#{digest:08x}"
    )


@dataclass
class ContainmentConfig:
    """Knobs for bisection + quarantine (constructor-level; the wire
    form rides config.types.ContainmentConfiguration)."""

    #: False restores the pre-containment behavior: ladder exhaustion
    #: routes the whole batch to the sequential oracle, nothing is
    #: bisected or quarantined
    enabled: bool = True
    #: isolations a pod survives (with escalating holds) before it
    #: parks with the PodQuarantined condition
    max_strikes: int = 3
    #: first out-of-queue hold; doubles per strike up to the max
    base_hold_seconds: float = 0.25
    max_hold_seconds: float = 5.0
    #: systemic-failure guard: a bisection run that has isolated this
    #: many singletons without a single successful sub-solve aborts to
    #: the sequential path (EVERY subset failing is a sick device, not
    #: a poison signature) -- unless a ladder_exhausted crash-loop
    #: already tripped, which forces isolation through
    bisect_abort_after: int = 4

    @classmethod
    def from_configuration(cls, cfg) -> "ContainmentConfig":
        """From the wire-config block
        (config.types.ContainmentConfiguration)."""
        return cls(
            enabled=cfg.enabled,
            max_strikes=cfg.max_strikes,
            base_hold_seconds=cfg.base_hold_seconds,
            max_hold_seconds=cfg.max_hold_seconds,
            bisect_abort_after=cfg.bisect_abort_after,
        )


class QuarantineManager:
    """The per-pod strike ledger behind bisection: escalating holds,
    bounded budget, typed park. Thread-safe (the dispatcher and, in
    principle, several profiles' flows may isolate concurrently)."""

    def __init__(
        self,
        queue,
        client=None,
        config: Optional[ContainmentConfig] = None,
    ) -> None:
        self.queue = queue
        self.client = client
        self.config = config or ContainmentConfig()
        self._lock = threading.Lock()
        self._strikes: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        # visibility counters (mirrored to metrics; attributes so tests
        # and the perf matrix read them without scraping)
        self.isolations = 0
        self.holds = 0
        self.parks = 0

    def strikes_of(self, pod) -> int:
        """Strikes charged against this pod's spec identity (shared
        across incarnations of the same spec)."""
        with self._lock:
            return self._strikes.get(spec_identity(pod), 0)

    def hold_for_strike(self, strike: int) -> float:
        cfg = self.config
        return min(
            cfg.base_hold_seconds * (2 ** max(0, strike - 1)),
            cfg.max_hold_seconds,
        )

    def isolate(self, pod_info, reason: str = "bisect") -> str:
        """One isolation event for the pod: bump its strike count, then
        either HOLD it out of the queue (escalating backoff; the queue
        flush releases it for a bounded retry) or, past the budget,
        PARK it with the PodQuarantined condition. Returns the
        disposition ("held" | "parked")."""
        pod = pod_info.pod
        uid = pod.metadata.uid
        # keyed by spec identity, NOT uid: a same-spec respawn (delete +
        # recreate, fresh uid) inherits its predecessor's strikes, so a
        # crash-looping controller can't reset the budget forever
        key = spec_identity(pod)
        with self._lock:
            strike = self._strikes.get(key, 0) + 1
            self._strikes[key] = strike
            self._strikes.move_to_end(key)
            while len(self._strikes) > _STRIKE_LEDGER_CAP:
                self._strikes.popitem(last=False)
            self.isolations += 1
        if strike >= self.config.max_strikes:
            self.queue.park_quarantined(pod_info)
            with self._lock:
                self.parks += 1
            metrics.quarantine_pods.inc(
                disposition="parked", reason=reason
            )
            # the parked GAUGE is owned by the queue (set at every
            # _quarantine_parked mutation, including deletes/releases)
            flightrecorder.mark(
                "quarantine", pod=uid, strike=strike,
                disposition="parked", reason=reason,
            )
            logger.warning(
                "pod %s quarantined (parked) after %d strikes (%s)",
                pod.key(), strike, reason,
            )
            self._write_condition(pod, strike, reason)
            return "parked"
        hold = self.hold_for_strike(strike)
        self.queue.quarantine_pod(pod_info, hold)
        with self._lock:
            self.holds += 1
        metrics.quarantine_pods.inc(disposition="held", reason=reason)
        flightrecorder.mark(
            "quarantine", pod=uid, strike=strike, disposition="held",
            hold_seconds=hold, reason=reason,
        )
        logger.warning(
            "pod %s quarantined (held %.2fs, strike %d/%d, %s)",
            pod.key(), hold, strike, self.config.max_strikes, reason,
        )
        return "held"

    def clear_condition_async(self, pod) -> None:
        """Remove the PodQuarantined condition after a parked pod is
        released (queue.on_quarantine_release hook). Runs the apiserver
        write on its own daemon thread: the queue invokes the hook from
        an informer-delivery path, which must never block on (or
        re-enter) the API."""
        if self.client is None:
            return
        threading.Thread(
            target=self._clear_condition, args=(pod,), daemon=True,
            name="quarantine-clear",
        ).start()

    def _clear_condition(self, pod) -> None:
        def drop(p) -> None:
            p.status.conditions = [
                c for c in p.status.conditions
                if c.type != QUARANTINE_CONDITION
            ]

        try:
            self.client.update_pod_status(
                pod.metadata.namespace, pod.metadata.name, drop
            )
        except KeyError:
            pass  # deleted while releasing: nothing to clear
        except Exception:  # noqa: BLE001 - best-effort cleanup
            logger.exception(
                "clearing PodQuarantined condition for %s", pod.key()
            )

    def _write_condition(self, pod, strike: int, reason: str) -> None:
        """The visible park: a typed PodQuarantined condition on the
        apiserver. Failures log and never raise -- the pod is already
        parked locally; the condition is the operator-facing record."""
        if self.client is None:
            return
        from kubernetes_tpu_torch.api.types import PodCondition

        msg = (
            f"pod isolated by blast-radius containment ({reason}) "
            f"{strike} time(s); quarantine retry budget exhausted"
        )

        def set_condition(p) -> None:
            p.status.conditions = [
                c for c in p.status.conditions
                if c.type != QUARANTINE_CONDITION
            ] + [
                PodCondition(
                    type=QUARANTINE_CONDITION,
                    status="True",
                    reason="QuarantineBudgetExhausted",
                    message=msg,
                )
            ]

        try:
            self.client.update_pod_status(
                pod.metadata.namespace, pod.metadata.name, set_condition
            )
        except Exception:  # noqa: BLE001 - the park itself already took
            logger.exception(
                "writing PodQuarantined condition for %s", pod.key()
            )
