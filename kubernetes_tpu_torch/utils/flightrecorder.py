"""Always-on flight recorder: the last K batch spans + control-plane
marks, dumpable as JSON when something goes wrong.

Twelve PRs of robustness machinery (ladders, breakers, waves,
partitions) degrade observably only as scattered counters; this module
is the single record that reconstructs *what happened to batch N*:

- ``BatchSpan``: one monotonically-numbered record per dispatch --
  batch size, pad shape, solver tier actually run, carry decision
  (reuse / delta scatter / full upload), per-stage wall clock, commit
  outcome, conflicts absorbed, per-pod linkage (uid -> batch id,
  queue-wait, attempt count).
- marks: breaker transitions, ladder fallbacks, fault points fired,
  fencing aborts, partition takeovers, preemption waves, mid-run jit
  recompiles, arrival-engine stalls, autobatch decisions.

The ring is bounded (``deque(maxlen=...)``) and lock-cheap: one short
lock hold per span begin / mark; span field updates are owned by the
single thread driving that batch (dispatcher, then committer -- the
pipeline hands the batch off, never shares it). ``KTPU_FLIGHTRECORDER=0``
compiles the spine out (begin_batch returns the no-op NullSpan, mark
returns immediately) -- the arm the overhead microbench compares
against.

Dump triggers: ``/debug/flightrecorder`` (scheduler/app.py), SIGUSR1,
and ``dump_on_degraded`` wherever a component raises the
degraded-health gauge. Chaos e2es assert against ``RECORDER.dump()``
instead of grepping logs.

The module doubles as the Chrome-trace event sink: ``start_trace()``
arms a buffer (bench.py --trace) and every span stage / instant mark
also lands there as a Chrome-trace event; ``export_chrome_trace``
writes JSON that loads in ui.perfetto.dev. Zero cost when not armed
(one None check).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: compile-out switch: the spine costs ~1us per op when on; off, the
#: begin/mark calls return immediately (the microbench's OFF arm)
ENABLED = os.environ.get("KTPU_FLIGHTRECORDER", "1") != "0"
SPAN_CAPACITY = int(os.environ.get("KTPU_FLIGHTRECORDER_SPANS", "512"))
MARK_CAPACITY = int(os.environ.get("KTPU_FLIGHTRECORDER_MARKS", "4096"))
#: where degraded-health / SIGUSR1 dumps land
DUMP_DIR = os.environ.get("KTPU_FLIGHTRECORDER_DIR", ".")


class BatchSpan:
    """One dispatch's record. Mutated only by the thread currently
    driving the batch (dispatcher -> committer hand-off; the async bulk
    bind bumps ``conflicts`` last). Lives in the ring from begin, so a
    dump mid-flight shows the batch in its current state."""

    __slots__ = (
        "batch_id", "t_start", "t_end", "size", "padded", "tier",
        "carry", "delta_rows", "stages", "placed", "no_node",
        "gang_masked", "spilled", "volume_retries", "conflicts",
        "routed", "pods", "thread", "extra",
    )

    def __init__(self, batch_id: int, size: int, pods) -> None:
        self.batch_id = batch_id
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        self.size = size
        self.padded: Optional[int] = None
        self.tier: Optional[str] = None
        self.carry: Optional[str] = None
        self.delta_rows = 0
        self.stages: Dict[str, float] = {}
        self.placed = 0
        self.no_node = 0
        self.gang_masked = 0
        self.spilled = 0
        self.volume_retries = 0
        self.conflicts = 0
        self.routed: Optional[str] = None  # non-device disposition
        #: (pod uid, queue-wait seconds, attempt count) per pod
        self.pods: List[Tuple[str, float, int]] = pods
        self.thread = threading.current_thread().name
        self.extra: Optional[dict] = None

    def stage(self, name: str, seconds: float,
              t0: Optional[float] = None) -> None:
        """Accumulate one stage's wall clock; when the Chrome-trace
        buffer is armed the stage also lands there as a duration event
        on the calling thread's track (t0 = perf_counter at start)."""
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        if _trace is not None and t0 is not None:
            trace_span(name, t0, seconds,
                       args={"batch": self.batch_id})

    def note(self, **fields) -> None:
        for k, v in fields.items():
            if k in BatchSpan.__slots__:
                setattr(self, k, v)
            else:
                if self.extra is None:
                    self.extra = {}
                self.extra[k] = v

    def bump(self, field: str, n: int = 1) -> None:
        setattr(self, field, getattr(self, field) + n)

    def finish(self, tier: Optional[str] = None,
               routed: Optional[str] = None) -> None:
        if tier is not None:
            self.tier = tier
        if routed is not None:
            self.routed = routed
        self.t_end = time.perf_counter()

    def __bool__(self) -> bool:
        return True

    def to_dict(self) -> dict:
        # copy the mutable members first: a dump can run concurrently
        # with the owning thread still stamping stages (mid-flight
        # batch on the debug endpoint / SIGUSR1 path) -- iterating the
        # live dicts would raise "changed size during iteration"
        stages = dict(self.stages)
        pods = list(self.pods)
        extra = dict(self.extra) if self.extra else None
        d = {
            "batch_id": self.batch_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "duration_ms": (
                round((self.t_end - self.t_start) * 1000.0, 3)
                if self.t_end is not None else None
            ),
            "size": self.size,
            "padded": self.padded,
            "tier": self.tier,
            "carry": self.carry,
            "delta_rows": self.delta_rows,
            "stages_ms": {
                k: round(v * 1000.0, 3) for k, v in stages.items()
            },
            "placed": self.placed,
            "no_node": self.no_node,
            "gang_masked": self.gang_masked,
            "spilled": self.spilled,
            "volume_retries": self.volume_retries,
            "conflicts": self.conflicts,
            "routed": self.routed,
            "thread": self.thread,
            "pods": [
                {"uid": uid, "queue_wait_ms": round(w * 1000.0, 3),
                 "attempts": att}
                for uid, w, att in pods
            ],
        }
        if extra:
            d["extra"] = extra
        return d


class _NullSpan:
    """The compiled-out span: every spine call is a no-op attribute
    access. Falsy so callers can branch on it cheaply."""

    __slots__ = ()

    def stage(self, name, seconds, t0=None):
        pass

    def note(self, **fields):
        pass

    def bump(self, field, n=1):
        pass

    def finish(self, tier=None, routed=None):
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class FlightRecorder:
    """The bounded ring of spans + marks. One process-global instance
    (``RECORDER``); chaos harnesses may construct private ones."""

    def __init__(self, span_capacity: int = SPAN_CAPACITY,
                 mark_capacity: int = MARK_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=span_capacity)
        self._marks: deque = deque(maxlen=mark_capacity)
        self._next_id = 0

    def begin_batch(self, size: int, pods=()) -> BatchSpan:
        """Allocate the next batch id and enter the span into the ring
        immediately (a mid-flight dump must show in-flight batches)."""
        with self._lock:
            self._next_id += 1
            span = BatchSpan(self._next_id, size, list(pods))
            self._spans.append(span)
        return span

    def mark(self, kind: str, /, **fields) -> None:
        """One timestamped control-plane event (breaker transition,
        fallback, fault fired, fencing abort, takeover, recompile...).
        ``kind`` is positional-only so a field may also be named
        ``kind``; the event kind wins in the dump."""
        self._marks.append((time.perf_counter(), kind, fields))

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._marks.clear()
            self._next_id = 0

    # -- dumps ---------------------------------------------------------

    def dump(self) -> dict:
        """Snapshot the rings as plain data (JSON-serializable)."""
        with self._lock:
            spans = list(self._spans)
            marks = list(self._marks)
        return {
            "dumped_at": time.time(),
            "perf_counter": time.perf_counter(),
            "next_batch_id": self._next_id,
            "spans": [s.to_dict() for s in spans],
            "marks": [
                # event kind last: it wins over a field named "kind"
                {**fields, "t": t, "kind": kind}
                for t, kind, fields in marks
            ],
        }

    def dump_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.dump(), indent=indent, default=str)

    def dump_to_file(self, reason: str) -> str:
        """Write the dump next to the process (KTPU_FLIGHTRECORDER_DIR)
        and return the path; failures log, never raise (the recorder
        must not take down the path that tripped it)."""
        path = os.path.join(
            DUMP_DIR,
            f"flightrecorder-{int(time.time())}-{reason}.json",
        )
        try:
            with open(path, "w") as f:
                f.write(self.dump_json(indent=1))
            logger.warning("flight recorder dumped to %s (%s)", path, reason)
        except Exception:  # noqa: BLE001 - never take down the caller
            logger.exception("flight recorder dump to %s failed", path)
        return path


RECORDER = FlightRecorder()


def begin_batch(size: int, pods=()) -> BatchSpan:
    if not ENABLED:
        return NULL_SPAN  # type: ignore[return-value]
    return RECORDER.begin_batch(size, pods)


def mark(kind: str, /, **fields) -> None:
    if not ENABLED:
        return
    RECORDER.mark(kind, **fields)


def dump_on_degraded(reason: str) -> Optional[str]:
    """Called wherever a component sets the degraded-health gauge: the
    moment something goes degraded is exactly when the last-K record is
    worth keeping."""
    if not ENABLED:
        return None
    RECORDER.mark("degraded", reason=reason)
    return RECORDER.dump_to_file(reason)


# -- Chrome-trace event buffer (bench.py --trace) ------------------------

_trace: Optional[list] = None
_trace_lock = threading.Lock()
_trace_tids: Dict[str, int] = {}


def start_trace() -> None:
    """Arm the Chrome-trace buffer: from here every span stage, arrival
    stall, and autobatch decision lands as a trace event."""
    global _trace
    with _trace_lock:
        _trace = []
        _trace_tids.clear()


def trace_active() -> bool:
    return _trace is not None


def _tid_for(name: str) -> int:
    """Stable small-int tid per track name, with a Perfetto thread_name
    metadata event emitted on first sight."""
    tid = _trace_tids.get(name)
    if tid is None:
        tid = len(_trace_tids) + 1
        _trace_tids[name] = tid
        _trace.append({  # type: ignore[union-attr]
            "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
            "args": {"name": name},
        })
    return tid


def trace_span(name: str, t0: float, dur: float,
               track: Optional[str] = None, args: Optional[dict] = None
               ) -> None:
    """One complete ('X') duration event; t0/dur in perf_counter
    seconds, converted to the trace's microsecond clock."""
    buf = _trace
    if buf is None:
        return
    with _trace_lock:
        if _trace is None:
            return
        ev = {
            "ph": "X", "name": name, "pid": 1,
            "tid": _tid_for(track or threading.current_thread().name),
            "ts": t0 * 1e6, "dur": max(dur, 0.0) * 1e6,
        }
        if args:
            ev["args"] = args
        _trace.append(ev)


def trace_instant(name: str, args: Optional[dict] = None,
                  track: Optional[str] = None) -> None:
    buf = _trace
    if buf is None:
        return
    with _trace_lock:
        if _trace is None:
            return
        ev = {
            "ph": "i", "name": name, "pid": 1, "s": "t",
            "tid": _tid_for(track or threading.current_thread().name),
            "ts": time.perf_counter() * 1e6,
        }
        if args:
            ev["args"] = args
        _trace.append(ev)


def stop_trace() -> List[dict]:
    """Disarm and return the collected events."""
    global _trace
    with _trace_lock:
        events, _trace = (_trace or []), None
        _trace_tids.clear()
    return events


def export_chrome_trace(path: str) -> int:
    """Write the armed buffer as Chrome-trace JSON (the object form,
    which Perfetto and chrome://tracing both load) and disarm. Returns
    the event count."""
    events = stop_trace()
    with open(path, "w") as f:
        json.dump(
            {"traceEvents": events, "displayTimeUnit": "ms"}, f
        )
    return len(events)
