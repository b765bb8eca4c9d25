"""Deterministic, seedable fault injection for the device scheduling
path.

Named injection points sit on the seams the bench history has actually
seen fail (compile blowups, the serving-link dead-man timer, bind
conflicts under churn, dropped watch streams). Each point fires with a
configured probability from its OWN seeded RNG stream, so a chaos run is
reproducible regardless of thread interleaving: the k-th evaluation of a
given point always makes the same decision for a given seed.

Production wiring: ``get_injector()`` returns None unless a harness (a
chaos test, ``bench.py --fault-profile``, ``python -m kubernetes_tpu_torch
--fault-profile``) installed one -- the hot path pays a single ``is not
None`` check per seam.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from kubernetes_tpu_torch.utils import flightrecorder, metrics


class FaultPoint:
    """Injection point names (the seams in the scheduling path)."""

    #: device solve raises mid-dispatch (compile blowup, Mosaic lowering
    #: failure, serving-link error)
    DEVICE_SOLVE = "device_solve"
    #: device solve blocks past the wall-clock watchdog deadline (the
    #: serving-link dead-man-timer wedge)
    DEVICE_SOLVE_HANG = "device_solve_hang"
    #: solve "succeeds" but the downloaded assignments are garbage
    #: (NaN-score argmax artifacts, out-of-range node indices)
    SOLVE_GARBAGE = "solve_garbage"
    #: bind/commit transaction returns a conflict error
    BIND_CONFLICT = "bind_conflict"
    #: watch stream drops mid-frame (informer must relist)
    WATCH_DROP = "watch_drop"
    #: lease renew/acquire RPC fails (leader election must jitter-retry
    #: and, past the renew deadline, abdicate)
    LEASE_RENEW_FAIL = "lease_renew_fail"
    #: apiserver transaction fails outright (list/bind/guaranteed_update
    #: raise; retry policies and relist must absorb it)
    API_UNAVAILABLE = "api_unavailable"
    #: the scheduler process dies between assume and bind (no cleanup
    #: runs; the restarted incarnation must requeue the in-flight pods)
    CRASH_BETWEEN_ASSUME_AND_BIND = "crash_between_assume_and_bind"
    #: the watch replay window no longer covers since_rv (410 Gone
    #: analogue; the informer must relist + diff)
    WATCH_HISTORY_TRUNCATED = "watch_history_truncated"
    #: one node flaps: deleted (spot kill / crash) and replaced by a
    #: COLD node of the same name after a short down time. Evaluated
    #: per tick by robustness/lifecycle.ClusterLifecycleDriver, which
    #: performs the actual apiserver surgery.
    NODE_FLAP = "node_flap"
    #: spot-reclamation storm: a whole slice of the fleet is deleted at
    #: once (mass requeue + re-solve), cold replacements join later
    RECLAIM_STORM = "reclaim_storm"
    #: the device victim-search dispatch of a preemption wave raises
    #: (compile blowup / serving-link error during the wave); the wave's
    #: solver ladder must charge the tier's breaker and complete on the
    #: jnp twin (or the host oracle at the floor)
    PREEMPT_SOLVE = "preempt_solve"
    #: an evicted victim refuses to die promptly: the delete becomes a
    #: GRACEFUL eviction (deletion_timestamp set, capacity still held)
    #: and the real delete lands only after ``hang_seconds`` of grace --
    #: nominees retrying against the still-occupied node must back off
    #: via podEligibleToPreemptOthers' terminating-victim check instead
    #: of re-evicting the same incarnation
    VICTIM_SLOW_DEATH = "victim_slow_death"
    #: stamps a POD (evaluated once per newly popped pod by the batch
    #: scheduler's drain loop): every solver-ladder tier of any batch
    #: containing the stamped pod fails, and its sequential attempt
    #: fails alone -- the per-pod persistent failure the bisection /
    #: quarantine containment plane exists to isolate. Tests and the
    #: poison-chaos workload may also stamp pods directly
    #: (``stamp_poison`` / the POISON_ANNOTATION).
    POISON_POD = "poison_pod"
    #: flips bytes in one device-resident carry row (evaluated per
    #: committed batch): silent state corruption the carry integrity
    #: audit must detect and heal before it mis-places pods
    CARRY_CORRUPT = "carry_corrupt"
    #: the device fails outright (evaluated per dispatch): ALL resident
    #: state is gone; in-flight batches must recover through the
    #: requeue machinery and the next dispatch rebuilds from the host
    #: cache via the cold-upload path (detection -> rebuilt is metered)
    DEVICE_LOST = "device_lost"
    #: a hollow kubelet acks its binding LATE (evaluated per scheduled
    #: ack): ``hang_seconds`` is added to the node's ack latency -- kept
    #: under the scheduler's ack timeout in the shipped profile so slow
    #: nodes exercise the ledger without tripping a rebind
    SLOW_ACK = "slow_ack"
    #: a hollow kubelet is a zombie (evaluated ONCE per node at fleet
    #: build): heartbeats keep flowing but bindings are NEVER acked --
    #: the silent-death shape only scheduler-side bind-ack tracking can
    #: catch (the lifecycle monitor sees a live lease)
    ZOMBIE_KUBELET = "zombie_kubelet"
    #: a hollow kubelet stops heartbeating for ``hang_seconds``
    #: (evaluated per heartbeat tick): the lease lapses, the
    #: nodelifecycle monitor must mark the node unreachable and
    #: taint-evict through the can_disrupt gate, then untaint when the
    #: lease resumes
    HEARTBEAT_LAPSE = "heartbeat_lapse"

    ALL = (
        DEVICE_SOLVE, DEVICE_SOLVE_HANG, SOLVE_GARBAGE, BIND_CONFLICT,
        WATCH_DROP, LEASE_RENEW_FAIL, API_UNAVAILABLE,
        CRASH_BETWEEN_ASSUME_AND_BIND, WATCH_HISTORY_TRUNCATED,
        NODE_FLAP, RECLAIM_STORM, PREEMPT_SOLVE, VICTIM_SLOW_DEATH,
        POISON_POD, CARRY_CORRUPT, DEVICE_LOST,
        # appended (never reordered): per-point RNG streams derive from
        # the index into ALL, so existing profiles stay reproducible
        SLOW_ACK, ZOMBIE_KUBELET, HEARTBEAT_LAPSE,
    )


class FaultInjected(Exception):
    """Raised by a firing injection point (subsystems under test treat it
    like the real failure it simulates)."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault at {point!r}")
        self.point = point


class PoisonError(RuntimeError):
    """Raised by a solve/schedule seam when a stamped poison pod is in
    the dispatch: models a spec that crashes pack, NaN-inducing
    requests, or a row that makes the kernel emit garbage. Persistent
    per POD (unlike FaultInjected's per-draw transience), so it keeps
    firing until containment isolates the pod."""

    def __init__(self, key: str) -> None:
        super().__init__(f"injected poison pod {key}")
        self.pod_key = key


#: annotation form of the poison stamp: survives the apiserver round
#: trip, so tests and chaos workloads can poison a pod AT CREATION
#: (the fault-point form stamps by UID at pop time instead)
POISON_ANNOTATION = "ktpu.dev/poison-pod"

#: uid-keyed stamp + eval ledgers: the informer replaces pod OBJECTS on
#: every status echo (queue.update sets pi.pod = new_pod), so a
#: __dict__ memo would wash the stamp -- and the one-draw-per-pod
#: guarantee -- away mid-chaos. Both sets are cleared by
#: install_injector so runs stay isolated.
_poisoned_uids: set = set()
_poison_eval_uids: set = set()


def stamp_poison(pod) -> None:
    """Directly stamp a pod as poison by UID (the deterministic form
    chaos tests use for chosen offsets; the POISON_POD fault point
    stamps probabilistically at pop time via poison_stamp_maybe)."""
    _poisoned_uids.add(pod.metadata.uid)


def poison_stamp_maybe(pod) -> None:
    """One POISON_POD draw per pod EVER (keyed by uid, so re-pops and
    informer object replacements never re-draw); a firing draw stamps
    the pod for the rest of the run."""
    inj = _injector
    if inj is None:
        return
    uid = pod.metadata.uid
    if uid in _poison_eval_uids:
        return
    _poison_eval_uids.add(uid)
    if inj.should_fire(FaultPoint.POISON_POD):
        _poisoned_uids.add(uid)


def pod_is_poisoned(pod) -> bool:
    """True when the pod carries either poison stamp. Manifests only
    while an injector is installed (see poison_raise_maybe) -- the
    annotation on its own is inert in production."""
    if pod.metadata.uid in _poisoned_uids:
        return True
    ann = pod.metadata.annotations
    return bool(ann) and ann.get(POISON_ANNOTATION) == "true"


def poison_raise_maybe(pod) -> None:
    """Raise PoisonError when the pod is stamped and an injector is
    installed. The solve seams call this per dispatched batch member;
    the sequential path calls it per attempt (the reference economics:
    a malformed pod fails ALONE there)."""
    if _injector is not None and pod_is_poisoned(pod):
        raise PoisonError(pod.key())


class SchedulerCrashed(Exception):
    """Raised by the CRASH_BETWEEN_ASSUME_AND_BIND point: the process is
    'dead' from here -- the handlers that catch this MUST NOT run the
    normal failure cleanup (forget/Unreserve/requeue), because a real
    crash wouldn't; recovery is the next incarnation's job."""

    def __init__(self) -> None:
        super().__init__(
            "injected crash between assume and bind (no cleanup runs)"
        )


@dataclass
class PointConfig:
    """Per-point firing policy."""

    rate: float = 0.0  # probability per evaluation, [0, 1]
    max_fires: Optional[int] = None  # stop firing after this many (None =
    # unlimited) -- lets a chaos run model a transient failure burst that
    # heals, which is what drives a breaker through a full
    # open -> half-open -> closed cycle
    hang_seconds: float = 0.0  # DEVICE_SOLVE_HANG: how long to block


@dataclass
class FaultProfile:
    """A named, loadable set of point configs (bench --fault-profile)."""

    name: str
    seed: int = 0
    points: Dict[str, PointConfig] = field(default_factory=dict)


class FaultInjector:
    """Deterministic injector: one seeded RNG stream per point.

    ``should_fire(point)`` consumes one draw from that point's stream;
    determinism holds per point even when several threads hit different
    points concurrently (each stream has its own lock).
    """

    def __init__(self, profile: FaultProfile) -> None:
        self.profile = profile
        self._rngs: Dict[str, random.Random] = {}
        self._fired: Dict[str, int] = {}
        self._evals: Dict[str, int] = {}
        self._lock = threading.Lock()
        for i, point in enumerate(FaultPoint.ALL):
            # independent per-point streams from the one profile seed
            # (int-derived: str/tuple seeding hashes with the per-process
            # salt and would break cross-run determinism)
            self._rngs[point] = random.Random(profile.seed * 1000003 + i)
            self._fired[point] = 0
            self._evals[point] = 0

    def point_config(self, point: str) -> Optional[PointConfig]:
        return self.profile.points.get(point)

    def should_fire(self, point: str) -> bool:
        cfg = self.profile.points.get(point)
        if cfg is None or cfg.rate <= 0.0:
            return False
        with self._lock:
            self._evals[point] += 1
            if cfg.max_fires is not None and self._fired[point] >= cfg.max_fires:
                return False
            fire = self._rngs[point].random() < cfg.rate
            if fire:
                self._fired[point] += 1
        if fire:
            metrics.faults_injected.inc(point=point)
            # the chaos e2e reconstructs "which faults fired, in what
            # order" from the flight recorder alone and checks it
            # against this injector's own ledger (fired_count)
            flightrecorder.mark("fault", point=point)
        return fire

    def fired_count(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    def eval_count(self, point: str) -> int:
        with self._lock:
            return self._evals.get(point, 0)

    # -- seam helpers (what the integration points actually call) -------

    def raise_maybe(self, point: str) -> None:
        """Raise FaultInjected when the point fires."""
        if self.should_fire(point):
            raise FaultInjected(point)

    def crash_maybe(self, point: str) -> None:
        """Raise SchedulerCrashed when the point fires. Distinct from
        raise_maybe: the catcher must treat it as process death (halt,
        no cleanup), not as a retryable failure."""
        if self.should_fire(point):
            raise SchedulerCrashed()

    def hang_seconds_maybe(self, point: str) -> float:
        """Seconds the seam should block for (0.0 = no fault). The caller
        sleeps inside whatever watchdog scope guards the real operation,
        so the injected hang trips the same timeout the real wedge
        would."""
        if self.should_fire(point):
            cfg = self.profile.points.get(point)
            return cfg.hang_seconds if cfg is not None else 0.0
        return 0.0

    def corrupt_assignments_maybe(self, point: str, assignments):
        """Return a corrupted copy of a downloaded assignment vector when
        the point fires (out-of-range node indices -- the downstream
        validator must catch exactly this shape of garbage)."""
        if not self.should_fire(point):
            return assignments
        out = assignments.copy()
        if out.size:
            # deterministic corruption: poison every 3rd slot with an
            # out-of-range index and the first slot with a huge negative
            out[::3] = 1 << 30
            out[0] = -(1 << 30)
        return out


# -- global install point ------------------------------------------------

_injector: Optional[FaultInjector] = None


def install_injector(injector: Optional[FaultInjector]) -> None:
    """Install (or clear, with None) the process-wide injector. Also
    resets the poison stamp/eval ledgers so consecutive chaos runs
    (and tests) start clean."""
    global _injector
    _injector = injector
    _poisoned_uids.clear()
    _poison_eval_uids.clear()


def get_injector() -> Optional[FaultInjector]:
    return _injector


# -- named profiles (bench.py --fault-profile / chaos suite) -------------

def builtin_profiles() -> Dict[str, FaultProfile]:
    """The named injection profiles the harness ships. ``seed`` can be
    overridden after load (faults.seed config knob)."""
    return {
        # ISSUE acceptance shape: 20% device-solve failures + forced
        # solve timeouts + one bind-conflict burst, healing after a
        # bounded number of fires so breakers complete a full cycle
        "chaos-default": FaultProfile(
            name="chaos-default",
            seed=0,
            points={
                FaultPoint.DEVICE_SOLVE: PointConfig(rate=0.2, max_fires=24),
                FaultPoint.DEVICE_SOLVE_HANG: PointConfig(
                    rate=0.1, max_fires=6, hang_seconds=1.0
                ),
                FaultPoint.BIND_CONFLICT: PointConfig(rate=1.0, max_fires=3),
            },
        ),
        # every device solve fails: exercises the floor of the ladder
        "device-down": FaultProfile(
            name="device-down",
            seed=0,
            points={FaultPoint.DEVICE_SOLVE: PointConfig(rate=1.0)},
        ),
        # garbage results: exercises download validation + host re-solve
        "garbage-scores": FaultProfile(
            name="garbage-scores",
            seed=0,
            points={FaultPoint.SOLVE_GARBAGE: PointConfig(rate=0.25)},
        ),
        # flaky watch: exercises informer relist
        "flaky-watch": FaultProfile(
            name="flaky-watch",
            seed=0,
            points={FaultPoint.WATCH_DROP: PointConfig(rate=0.05)},
        ),
        # cluster-lifecycle chaos (PR-6 acceptance shape): node flaps +
        # one spot-reclamation storm + a solver-fault sprinkle, so the
        # ladder/breakers (PR 1), the sweeper/reconciler (PR 2), AND the
        # slot-based device carry (PR 6) are exercised under membership
        # churn at once. The flap/storm points are evaluated per
        # ClusterLifecycleDriver tick; every point heals after a bounded
        # number of fires so the run converges.
        "lifecycle-chaos": FaultProfile(
            name="lifecycle-chaos",
            seed=0,
            points={
                FaultPoint.NODE_FLAP: PointConfig(rate=0.25, max_fires=8),
                FaultPoint.RECLAIM_STORM: PointConfig(
                    rate=0.08, max_fires=1
                ),
                FaultPoint.DEVICE_SOLVE: PointConfig(
                    rate=0.05, max_fires=4
                ),
                # ONE conflict: absorbed by the default 2-attempt bind
                # retry (2 fires would go terminal and the run measures
                # the requeue flush interval, not the chaos)
                FaultPoint.BIND_CONFLICT: PointConfig(rate=1.0, max_fires=1),
            },
        ),
        # multi-active partition chaos (PR-8 acceptance shape): lease
        # losses depose partition holders mid-burst (survivors must
        # adopt the orphaned ranges), bind-conflict bursts force the
        # committer's typed-conflict absorption, and transient API
        # unavailability stresses the retry/relist seams -- all bounded
        # so the run converges to 100% bound with a balanced conflict
        # ledger
        "partition-chaos": FaultProfile(
            name="partition-chaos",
            seed=0,
            points={
                FaultPoint.LEASE_RENEW_FAIL: PointConfig(
                    rate=0.2, max_fires=12
                ),
                FaultPoint.BIND_CONFLICT: PointConfig(rate=1.0, max_fires=2),
                FaultPoint.API_UNAVAILABLE: PointConfig(
                    rate=0.03, max_fires=6
                ),
            },
        ),
        # batched preemption chaos (PR-11 acceptance shape): wave-solve
        # faults force the pallas tier's breaker through a fallback to
        # the jnp twin mid-wave, a bind-conflict burst races the
        # nominees' commits, and slow-dying victims hold their capacity
        # past the wave so nominees must ride the terminating-victim
        # re-arm path -- all bounded so a priority-inversion storm still
        # converges to 100% of the high band bound with zero PDB
        # overspend
        "preemption-chaos": FaultProfile(
            name="preemption-chaos",
            seed=0,
            points={
                FaultPoint.PREEMPT_SOLVE: PointConfig(rate=0.3, max_fires=6),
                FaultPoint.DEVICE_SOLVE: PointConfig(rate=0.05, max_fires=2),
                # ONE conflict: absorbed by the default 2-attempt bind
                # retry (same rationale as lifecycle-chaos)
                FaultPoint.BIND_CONFLICT: PointConfig(rate=1.0, max_fires=1),
                FaultPoint.VICTIM_SLOW_DEATH: PointConfig(
                    rate=0.5, max_fires=8, hang_seconds=0.3
                ),
            },
        ),
        # blast-radius containment chaos (ISSUE-14 acceptance shape):
        # a few poison pods stamped into the stream (each drags every
        # batch containing it down the full ladder until bisection
        # isolates it into quarantine), one silent carry-row corruption
        # (the integrity audit must detect + heal it), and one
        # device-loss event (resident state rebuilt from the host cache
        # through the cold-upload path, in-flight batches requeued).
        # Healthy pods must keep binding at a DEVICE tier throughout --
        # the containment plane exists so the blast radius is the
        # poison pod, not the batch.
        "poison-chaos": FaultProfile(
            name="poison-chaos",
            seed=0,
            points={
                FaultPoint.POISON_POD: PointConfig(
                    rate=0.01, max_fires=3
                ),
                FaultPoint.CARRY_CORRUPT: PointConfig(
                    rate=0.2, max_fires=1
                ),
                FaultPoint.DEVICE_LOST: PointConfig(
                    rate=0.1, max_fires=1
                ),
            },
        ),
        # hollow-node / closed-bind-loop chaos (ISSUE-17 acceptance
        # shape): ~5% of acks run slow (still under the ack timeout, so
        # the ledger books latency without rebinding), ~1% of hollow
        # nodes are zombies (heartbeats flow, acks never come -- only
        # bind-ack tracking catches them; their pods must rebind
        # elsewhere exactly once per incarnation), and a bounded number
        # of heartbeat lapses push nodes through the full
        # unreachable -> taint-evict -> recover lifecycle arc
        "kubelet-chaos": FaultProfile(
            name="kubelet-chaos",
            seed=0,
            points={
                FaultPoint.SLOW_ACK: PointConfig(
                    rate=0.05, hang_seconds=0.25
                ),
                FaultPoint.ZOMBIE_KUBELET: PointConfig(rate=0.01),
                FaultPoint.HEARTBEAT_LAPSE: PointConfig(
                    rate=0.02, max_fires=4, hang_seconds=1.5
                ),
            },
        ),
        # control-plane chaos (PR-2 acceptance shape): renew failures
        # that force a failover, transient API unavailability absorbed
        # by retries/relists, a truncated watch window (410 Gone), and a
        # bind-conflict burst -- every point heals after a bounded
        # number of fires so the run converges
        "ha-chaos": FaultProfile(
            name="ha-chaos",
            seed=0,
            points={
                FaultPoint.LEASE_RENEW_FAIL: PointConfig(
                    rate=0.3, max_fires=8
                ),
                FaultPoint.API_UNAVAILABLE: PointConfig(
                    rate=0.05, max_fires=10
                ),
                FaultPoint.WATCH_HISTORY_TRUNCATED: PointConfig(
                    rate=0.5, max_fires=2
                ),
                FaultPoint.BIND_CONFLICT: PointConfig(rate=1.0, max_fires=2),
            },
        ),
    }


def injector_from_configuration(cfg) -> Optional[FaultInjector]:
    """Build an injector from the wire-config block
    (config.types.FaultInjectionConfiguration); None when disabled.
    Named-profile points load first, then per-point overrides."""
    if not cfg.enabled:
        return None
    points: Dict[str, PointConfig] = {}
    if cfg.profile:
        points.update(load_profile(cfg.profile).points)
    for name, p in cfg.points.items():
        points[name] = PointConfig(
            rate=p.rate, max_fires=p.max_fires, hang_seconds=p.hang_seconds
        )
    return FaultInjector(
        FaultProfile(
            name=cfg.profile or "custom", seed=cfg.seed, points=points
        )
    )


def load_profile(name: str, seed: Optional[int] = None) -> FaultProfile:
    profiles = builtin_profiles()
    if name not in profiles:
        raise KeyError(
            f"unknown fault profile {name!r} (known: "
            f"{', '.join(sorted(profiles))})"
        )
    profile = profiles[name]
    if seed is not None:
        profile.seed = seed
    return profile
