"""Lease-based leader election (active/passive scheduler HA).

Reference: /root/reference/staging/src/k8s.io/client-go/tools/
leaderelection/leaderelection.go (Run :197, acquire :244, renew :258) with
the LeaseLock resource lock. Semantics kept: a candidate acquires when the
lease is unheld or expired; the holder renews every retry period and MUST
abdicate (callback + return) when it cannot renew within the renew
deadline -- lost lease means process restart in the reference
(server.go:247 klog.Fatalf); all scheduler state is soft and rebuilt from
informers.

PR-2 hardening:

- **Jittered renew** (reference wait.JitterUntil, leaderelection.go:266):
  every retry period is stretched by up to ``renew_jitter_fraction`` so a
  fleet of candidates doesn't thunder against the lease in lockstep.
- **Skew tolerance**: a challenger only seizes an expired lease after
  ``clock_skew_tolerance_seconds`` of extra grace, so a holder whose
  clock trails the challenger's isn't deposed while it still believes it
  holds a live lease.
- **Fencing probe** (``holds_lease``): a fresh read of the lease record
  answering "do I hold it RIGHT NOW" -- the batch committer calls this
  immediately before every bulk bind and aborts the commit when deposed,
  so two live schedulers can never double-bind (see batch.py).
- **lease_renew_fail** injection point: a failed renew RPC, driven by the
  PR-1 fault injector (globally, or targeted at one elector via
  ``fault_injector``) so failover chaos stays seeded and reproducible.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import zlib
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import Lease, ObjectMeta
from kubernetes_tpu_torch.config.types import LeaderElectionConfiguration
from kubernetes_tpu_torch.robustness.faults import FaultPoint, get_injector
from kubernetes_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)


class LeaderElector:
    def __init__(
        self,
        client,
        config: LeaderElectionConfiguration,
        identity: str,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.client = client
        self.config = config
        self.identity = identity
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.clock = clock
        self._stop = threading.Event()
        self.is_leader = False
        #: targeted injector override for tests/bench (None = process
        #: global get_injector()); lets one elector of a pair fail its
        #: renews deterministically while the standby stays healthy
        self.fault_injector = None
        # deterministic per-identity jitter stream: reproducible chaos
        # runs, but no two identities share a phase
        self._jitter_rng = random.Random(zlib.crc32(identity.encode()))

    # -- lock primitives ----------------------------------------------------

    def _jittered(self, period: float) -> float:
        frac = max(0.0, self.config.renew_jitter_fraction)
        if frac <= 0.0:
            return period
        return period * (1.0 + frac * self._jitter_rng.random())

    def _renew_fails_injected(self) -> bool:
        inj = (
            self.fault_injector
            if self.fault_injector is not None
            else get_injector()
        )
        return inj is not None and inj.should_fire(
            FaultPoint.LEASE_RENEW_FAIL
        )

    def _get_or_create(self) -> Lease:
        server = self.client.server
        try:
            return server.get(
                "Lease", self.config.resource_namespace, self.config.resource_name
            )
        except KeyError:
            lease = Lease(
                metadata=ObjectMeta(
                    name=self.config.resource_name,
                    namespace=self.config.resource_namespace,
                )
            )
            try:
                return server.create(lease)
            except ValueError:  # lost the create race
                return server.get(
                    "Lease",
                    self.config.resource_namespace,
                    self.config.resource_name,
                )

    def _try_acquire_or_renew(self) -> bool:
        """One CAS round (leaderelection.go:317 tryAcquireOrRenew). The
        holder/expiry check runs INSIDE the atomic update so two candidates
        can never both seize the lease, and expiry honors the duration
        advertised in the lease record (observedRecord.LeaseDurationSeconds),
        not the challenger's local config."""
        if self._renew_fails_injected():
            metrics.lease_renew_failures.inc()
            return False
        server = self.client.server
        now = self.clock()
        skew = max(0.0, self.config.clock_skew_tolerance_seconds)
        self._get_or_create()

        class _Held(Exception):
            pass

        def mutate(obj: Lease) -> None:
            # a challenger grants the expired holder skew-tolerance grace;
            # the holder itself renews regardless (its own record)
            expired = (
                obj.renew_time + obj.lease_duration_seconds + skew <= now
                if obj.holder_identity != self.identity
                else obj.renew_time + obj.lease_duration_seconds <= now
            )
            if obj.holder_identity not in ("", self.identity) and not expired:
                raise _Held()
            if obj.holder_identity != self.identity:
                obj.lease_transitions += 1
                obj.acquire_time = now
            obj.holder_identity = self.identity
            obj.lease_duration_seconds = self.config.lease_duration_seconds
            obj.renew_time = now

        try:
            server.guaranteed_update(
                "Lease",
                self.config.resource_namespace,
                self.config.resource_name,
                mutate,
            )
            return True
        except _Held:
            return False
        except Exception:
            logger.exception("lease update failed")
            metrics.lease_renew_failures.inc()
            return False

    # -- fencing -------------------------------------------------------------

    def holds_lease(self) -> bool:
        """Commit-time fencing check: read the lease record FRESH and
        answer whether this identity still holds a live lease. Any doubt
        (record unreadable, holder changed, record expired) answers False
        -- the committer aborts and requeues rather than risk a
        double-bind by a deposed leader."""
        if not self.is_leader:
            return False
        try:
            obj = self.client.server.get(
                "Lease",
                self.config.resource_namespace,
                self.config.resource_name,
            )
        except Exception:  # noqa: BLE001 - can't prove ownership: fence
            return False
        return (
            obj.holder_identity == self.identity
            and obj.renew_time + obj.lease_duration_seconds > self.clock()
        )

    # -- run loop -----------------------------------------------------------

    def run(self) -> None:
        """Blocks: acquire -> lead (renew loop) -> abdicate on failure."""
        while not self._stop.is_set():
            if not self._try_acquire_or_renew():
                self._stop.wait(
                    self._jittered(self.config.retry_period_seconds)
                )
                continue
            # we are the leader
            self.is_leader = True
            logger.info("became leader: %s", self.identity)
            lead_thread = threading.Thread(
                target=self.on_started_leading, daemon=True
            )
            lead_thread.start()
            deadline = self.clock() + self.config.renew_deadline_seconds
            while not self._stop.is_set():
                if self._try_acquire_or_renew():
                    deadline = self.clock() + self.config.renew_deadline_seconds
                elif self.clock() >= deadline:
                    break  # failed to renew within the deadline: abdicate
                self._stop.wait(
                    self._jittered(self.config.retry_period_seconds)
                )
            self.is_leader = False
            if not self._stop.is_set():
                logger.error("lost leader lease: %s", self.identity)
            if self.on_stopped_leading is not None:
                self.on_stopped_leading()
            return  # reference fatals here; caller decides restart policy

    def stop(self) -> None:
        self._stop.set()

    def release(self) -> None:
        """Voluntarily give up the lease (leaderelection.go release)."""
        if not self.is_leader:
            return

        def mutate(obj: Lease) -> None:
            if obj.holder_identity != self.identity:
                return  # someone else already seized it: don't clobber
            obj.holder_identity = ""
            obj.renew_time = 0.0

        try:
            self.client.server.guaranteed_update(
                "Lease",
                self.config.resource_namespace,
                self.config.resource_name,
                mutate,
            )
        except Exception:
            logger.exception("releasing lease")
        self.is_leader = False
